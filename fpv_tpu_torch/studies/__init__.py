"""Entropy and geometry studies of the FPVT model, on the port.

The counterparts of the JAX package's ``examples/*_study.py``: the same
corpora, decisions and returned numbers, computed with the port's model
step, predictors, previews and codec.  Each runs as
``python -m fpv_tpu_torch.studies.<name> [--fast] [--device cpu|cuda]``
(default ``cuda``; without a card it exits unless given ``--device cpu``).
"""

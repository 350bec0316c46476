"""The JAX package's ``examples/`` walkthroughs on the port.

Each runs as ``python -m fpv_tpu_torch.examples.<name> [--device cuda|cpu]``
(default the card) and asserts what its JAX script asserts:
``fpv1_compat``, ``fpvt_pipeline``, ``multichip`` and ``serving_hubs``.
The measurement scripts are in ``fpv_tpu_torch.studies``.
"""

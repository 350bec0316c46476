"""The benchmark of the PyTorch and CUDA codec, ``fpv_tpu_torch``: camera
recordings ingested, replayed and sought on one card.  Run one cell with
``python3 -m fpvbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``; see README.md."""

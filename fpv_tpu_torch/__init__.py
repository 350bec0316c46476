"""fpv_tpu_torch: the FPVT lossless video codec on PyTorch and CUDA.

A port of ``fpv_tpu`` (JAX, TPU) to PyTorch with hand-written CUDA kernels
for NVIDIA Hopper.  It writes FPVT v6 files byte-identical to the JAX
package's device writer and reads its 1024-lane files.  It imports neither
JAX nor ``fpv_tpu``.

    import fpv_tpu_torch
    data = fpv_tpu_torch.encode_file_fpvt(frames, shift=4, device="cuda")
    back = fpv_tpu_torch.decode_file_fpvt(data, device="cuda")
"""

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    FpvtWriter,
    decode_file_fpvt,
    encode_file_fpvt,
)

__all__ = [
    "FpvtReader",
    "FpvtWriter",
    "decode_file_fpvt",
    "encode_file_fpvt",
]

"""fpv_tpu_torch: the FPVT lossless video codec on PyTorch and CUDA.

A port of ``fpv_tpu`` (JAX, TPU) to PyTorch with hand-written CUDA kernels
for NVIDIA Hopper.  It writes FPVT v6 files byte-identical to the JAX
package's writer and reads every FPVT v4-v6 file, narrow streams included;
its reader decodes batches, single frames, previews and streams, and the
serving hubs (``MultiStreamEncoder``, ``MultiStreamDecoder``) multiplex
many camera streams onto a card.  It imports neither JAX nor ``fpv_tpu``.

    import fpv_tpu_torch
    data = fpv_tpu_torch.encode_file_fpvt(frames, shift=4, device="cuda")
    back = fpv_tpu_torch.decode_file_fpvt(data, device="cuda")
    frame = fpv_tpu_torch.FpvtReader(data, device="cuda").decode_frame(5)
"""

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    FpvtStreamingReader,
    FpvtWriter,
    decode_file_fpvt,
    encode_file_fpvt,
    warmup_stream,
)
from fpv_tpu_torch.api.multistream import MultiStreamDecoder, MultiStreamEncoder

__all__ = [
    "FpvtReader",
    "FpvtStreamingReader",
    "FpvtWriter",
    "MultiStreamDecoder",
    "MultiStreamEncoder",
    "decode_file_fpvt",
    "encode_file_fpvt",
    "warmup_stream",
]

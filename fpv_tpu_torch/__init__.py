"""fpv_tpu_torch: the FPVT lossless video codec on PyTorch and CUDA.

A port of ``fpv_tpu`` (JAX, TPU) to PyTorch with hand-written CUDA kernels
for NVIDIA Hopper.  It writes FPVT v6 files byte-identical to the JAX
package's writer and reads every FPVT v4-v6 file, narrow streams included;
its reader decodes batches, single frames, previews and streams, and the
serving hubs (``MultiStreamEncoder``, ``MultiStreamDecoder``) multiplex
many camera streams onto a card.  The FPV1 compatibility profile
(``Encoder``, ``encode_file``, ``StreamingDecoder``,
``RandomAccessDecoder``, ``decode_file``) writes the JAX package's bytes
with its filter chain on the card and brotli (the system libbrotli) on
host threads.  ``transcode`` converts files between the two profiles on
the card, byte-identical to the JAX package's transcoder; the tools run
as ``python -m fpv_tpu_torch.cli.<encode|decode|inspect|benchmark|
transcode>``, and ``fpv_tpu_torch.batch`` holds the columnar and Arrow
frontends.  It imports neither JAX nor ``fpv_tpu``.

    import fpv_tpu_torch
    data = fpv_tpu_torch.encode_file_fpvt(frames, shift=4, device="cuda")
    back = fpv_tpu_torch.decode_file_fpvt(data, device="cuda")
    frame = fpv_tpu_torch.FpvtReader(data, device="cuda").decode_frame(5)
    fpv1 = fpv_tpu_torch.encode_file(frames, shift=4, device="cuda")
    back = fpv_tpu_torch.decode_file(fpv1, num_threads=8, device="cuda")
    fpvt = fpv_tpu_torch.transcode(fpv1, "fpvt", shift=4, device="cuda")
"""

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    FpvtStreamingReader,
    FpvtWriter,
    decode_file_fpvt,
    encode_file_fpvt,
    warmup_stream,
)
from fpv_tpu_torch.api.decoder import (
    RandomAccessDecoder,
    StreamingDecoder,
    decode_file,
)
from fpv_tpu_torch.api.encoder import Encoder, encode_file
from fpv_tpu_torch.api.frame import ChunkFlags, FrameFlags, FramePlanes
from fpv_tpu_torch.api.multistream import MultiStreamDecoder, MultiStreamEncoder
from fpv_tpu_torch.api.transcode import (
    sniff_profile,
    transcode,
    transcode_to_fpv1,
    transcode_to_fpvt,
)

__all__ = [
    "ChunkFlags",
    "Encoder",
    "FrameFlags",
    "FramePlanes",
    "FpvtReader",
    "FpvtStreamingReader",
    "FpvtWriter",
    "MultiStreamDecoder",
    "MultiStreamEncoder",
    "RandomAccessDecoder",
    "StreamingDecoder",
    "decode_file",
    "decode_file_fpvt",
    "encode_file",
    "encode_file_fpvt",
    "sniff_profile",
    "transcode",
    "transcode_to_fpv1",
    "transcode_to_fpvt",
    "warmup_stream",
]

"""The bytes the rANS kernels must move, and the card's peak: the yardstick
of the roofline shares.

Frozen from the count the codec's kernel table uses: every input read once
and every output written once, for one coded plane stream of ``nblocks``
blocks of ``lanes`` lanes, ``chunk_len`` symbol steps and ``words``
payload words.

* K1 (encode; K1a ``rans_encode_chain_kernel`` + K1b
  ``rans_encode_place_kernel``): symbols in (one byte a step and lane),
  lane lengths in (i32), the encode table in (i32: 256 entries order-0,
  512 ctx16), final states out (i32 a lane), word counts out (i32 a block
  and segment), payload out (u16 a word).
* K2 (decode; ``rans_decode_kernel``): word counts (i32) and payload
  offsets (i64) a block and segment, states and lane lengths (i32 a lane),
  the 4096-entry decode table (i32) and the payload (u16 a word) in;
  symbols (a byte a step and lane) and integrity flags (i32 a lane) out.

For one main batch of the 12-bit corpus (32 frames of 1024 x 1024,
chunk 4096, previews at chunk 512) these give 91,371,760 B for K1 and
88,959,730 B for K2.
"""

from __future__ import annotations

CODING_ORDER0, CODING_CTX16 = 0, 1

# H100 SXM, NVIDIA's data sheet, at its 700 W power limit
PEAK_BYTES_PER_S = 3.35e12

K1_KERNELS = ("rans_encode_chain_kernel", "rans_encode_place_kernel")
K2_KERNELS = ("rans_decode_kernel",)


def _table_entries(coding: int) -> int:
    return 512 if coding == CODING_CTX16 else 256


def k1_bytes(s: dict) -> int:
    """K1's bytes for one stream (keys of reference.fpvt.stream_geometry)."""
    lanes = s["nblocks"] * s["lanes"]
    return (lanes * s["chunk_len"] + 4 * lanes
            + 4 * _table_entries(s["coding"]) + 4 * lanes
            + 4 * s["nblocks"] * s["nseg"] + 2 * s["words"])


def k2_bytes(s: dict) -> int:
    """K2's bytes for one stream."""
    lanes = s["nblocks"] * s["lanes"]
    groups = s["nblocks"] * s["nseg"]
    return (4 * groups + 8 * groups + 4 * lanes + 4 * lanes + 4 * 4096
            + 2 * s["words"] + lanes * s["chunk_len"] + 4 * lanes)


def roofline_pct(nbytes: float, kernel_s: float) -> float | None:
    """The share of the bound (bytes at the peak rate) in the kernels'
    device time, in percent; None when no kernel time was read."""
    if kernel_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / kernel_s

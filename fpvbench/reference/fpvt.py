"""Plain FPVT v4-v6 reader: the yardstick that judges what the codec wrote.

Written from the format description (``docs/FORMAT_FPVT.md``) in NumPy for
the parsing and plain PyTorch for the decoding, on any device.  It imports
nothing of the codec under test and takes nothing it made but the file
bytes.  It is slow by design: one vectorized step of every lane at a time
for the rANS streams, one anti-diagonal at a time for the CG2D inverse.

    parsed = parse(data)              # structure, checked against itself
    dec = decode(parsed, device)      # frames u16 [N, H, W], previews, faults
    acct = stream_geometry(parsed)    # per coded stream: the sizes the
                                      # byte counts of fpvbench/bytecount.py use
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

MAGIC = b"FPVT"
HEADER_SIZE = 32
READ_VERSIONS = (4, 5, 6)

SECTION_BATCH, SECTION_DELTA, SECTION_INDEX = 0, 1, 2

F_USE_DELTA = 1
F_SPATIAL_SHIFT = 1
F_NO_LOW = 8
F_PV_SPATIAL_SHIFT = 4
F_PV_USE_DELTA = 64
F_USE_PREV = 128
SPATIAL_NONE, SPATIAL_UP, SPATIAL_CG2D = 0, 1, 2

HDR_F_BIG_ENDIAN = 1
HDR_F_DELTA_IS_FRAME0 = 2

CODING_ORDER0, CODING_CTX16, CODING_CONST, CODING_RAW = 0, 1, 2, 3
SEG_LEN = 512
RANS_L = 1 << 15
ORDER0_BITS = 12
CTX_BITS = 7
CTX_NCTX, CTX_ALPHA = 32, 16


class FormatError(ValueError):
    """The bytes break the format."""


@dataclasses.dataclass
class Stream:
    """One plane stream as stored: ``nframes`` planes of ``plane_size``
    bytes, coded as ``coding``."""

    nframes: int
    plane_size: int
    chunk_len: int
    coding: int
    lanes: int = 0
    value: int = 0  # CODING_CONST
    raw: np.ndarray | None = None  # CODING_RAW
    freq: np.ndarray | None = None  # order-0 [256] or ctx16 [32, 16]
    states: np.ndarray | None = None  # u32 [nblocks * lanes]
    counts: np.ndarray | None = None  # u32 [nblocks, nseg]
    payload: np.ndarray | None = None  # u16 words

    @property
    def symbols(self) -> int:
        return self.nframes * self.plane_size

    @property
    def nseg(self) -> int:
        return max(1, -(-self.chunk_len // SEG_LEN))

    @property
    def nblocks(self) -> int:
        return max(1, -(-self.symbols // (self.chunk_len * self.lanes)))


@dataclasses.dataclass
class Batch:
    flags: np.ndarray  # u8 [n]
    timestamps: np.ndarray  # i64 [n]
    high: Stream
    low: Stream | None
    preview: Stream | None


@dataclasses.dataclass
class File:
    xsize: int
    ysize: int
    shift: int
    big_endian: bool
    chunk_log2: int
    frames_per_batch: int
    delta_is_frame0: bool
    dflags: int
    delta_high: Stream
    delta_low: Stream | None
    batches: list[Batch]


def _need(data, pos: int, n: int) -> None:
    if pos < 0 or n < 0 or pos + n > len(data):
        raise FormatError("truncated file")


def _stream(data, pos: int, nframes: int, plane_size: int,
            headers_only: bool) -> tuple[Stream, int]:
    """Parse the plane stream at ``pos`` -> (stream, end of it)."""
    _need(data, pos, 24)
    (size,) = struct.unpack_from("<I", data, pos)
    _need(data, pos, size)
    end = pos + size
    psize, chunk_len, nchunks, coding, lanes, value = struct.unpack_from(
        "<IIIIHH", data, pos + 4)
    p = pos + 24
    if psize != plane_size:
        raise FormatError("plane size does not match the frame geometry")
    if not 16 <= chunk_len <= 65536 or chunk_len & (chunk_len - 1):
        raise FormatError("bad chunk length")
    st = Stream(nframes, psize, chunk_len, coding)
    if coding == CODING_CONST:
        if value > 255:
            raise FormatError("bad constant")
        st.value = value
        return st, end
    if coding == CODING_RAW:
        n = st.symbols
        if p + n > end:
            raise FormatError("raw stream overruns its size")
        raw = np.frombuffer(data, np.uint8, n, p)
        if zlib.adler32(raw) & 0xFFFFFFFF != nchunks:
            raise FormatError("raw stream checksum")
        st.raw = raw
        return st, end
    if coding not in (CODING_ORDER0, CODING_CTX16):
        raise FormatError(f"unknown coding {coding}")
    if lanes < 8 or lanes > 1024 or lanes & (lanes - 1):
        raise FormatError("bad lane count")
    st.lanes = lanes
    if nchunks != st.nblocks * lanes:
        raise FormatError("chunk count does not match the geometry")
    _need(data, p, 512)
    if coding == CODING_CTX16:
        freq = np.frombuffer(data, np.uint8, 512, p).astype(np.int64)
        freq = freq.reshape(CTX_NCTX, CTX_ALPHA)
        if not (freq.sum(axis=1) == 1 << CTX_BITS).all():
            raise FormatError("context table does not sum to 128")
    else:
        freq = np.frombuffer(data, "<u2", 256, p).astype(np.int64)
        if freq.sum() != 1 << ORDER0_BITS:
            raise FormatError("table does not sum to 4096")
    p += 512
    ngroups = st.nblocks * st.nseg
    _need(data, p, 4 * nchunks + 4 * ngroups)
    states = np.frombuffer(data, "<u4", nchunks, p)
    p += 4 * nchunks
    counts = np.frombuffer(data, "<u4", ngroups, p).reshape(
        st.nblocks, st.nseg)
    p += 4 * ngroups
    words = int(counts.sum(dtype=np.int64))
    if p + 2 * words > end:
        raise FormatError("payload overruns its stream")
    st.freq, st.states, st.counts = freq, states, counts
    st.payload = None if headers_only else np.frombuffer(
        data, "<u2", words, p)
    return st, end


def parse(data: bytes, headers_only: bool = False) -> File:
    """The file's structure: header, delta section, batch sections in file
    order, checked against the index footer.  ``headers_only`` skips
    reading payload words (their count is kept), for byte accounting."""
    data = memoryview(data)
    _need(data, 0, HEADER_SIZE)
    (magic, version, _profile, hflags, xsize, ysize, shift, chunk_log2, _r,
     fpb, _r2) = struct.unpack_from("<4sBBHIIBBHIQ", data, 0)
    if magic != MAGIC or version not in READ_VERSIONS:
        raise FormatError("not an FPVT v4-v6 file")
    if not (0 < xsize <= 65536 and 0 < ysize <= 65536) or shift > 16:
        raise FormatError("bad header")
    h, w = ysize, xsize
    pos = HEADER_SIZE
    _need(data, pos, 10)
    size, stype = struct.unpack_from("<QB", data, pos)
    if stype != SECTION_DELTA:
        raise FormatError("the delta section must come first")
    _need(data, pos, size)
    dflags = data[pos + 9]
    dh, p = _stream(data, pos + 10, 1, h * w, headers_only)
    dl = None
    if not dflags & F_NO_LOW:
        dl, p = _stream(data, p, 1, h * w, headers_only)
    if p > pos + size:
        raise FormatError("delta section overrun")
    pos += size
    batches, offsets = [], []
    while True:
        _need(data, pos, 9)
        size, stype = struct.unpack_from("<QB", data, pos)
        _need(data, pos, size)
        if size < 9:
            raise FormatError("bad section size")
        if stype == SECTION_INDEX:
            break
        if stype != SECTION_BATCH:
            raise FormatError(f"unknown section type {stype}")
        n, has_low, has_pv, _pad = struct.unpack_from("<IBBH", data, pos + 9)
        if not 0 < n <= 1 << 20:
            raise FormatError("bad frame count")
        p = pos + 17
        _need(data, p, 9 * n)
        flags = np.frombuffer(data, np.uint8, n, p)
        ts = np.frombuffer(data, "<i8", n, p + n)
        p += 9 * n
        hi, p = _stream(data, p, n, h * w, headers_only)
        lo = pv = None
        if has_low:
            lo, p = _stream(data, p, n, h * w, headers_only)
        if has_pv:
            pv, p = _stream(data, p, n, (h // 4) * (w // 4), headers_only)
        if p > pos + size:
            raise FormatError("batch section overrun")
        batches.append(Batch(flags, ts, hi, lo, pv))
        offsets.append((pos, n))
        pos += size
    # the footer: its entries are the batch sections just walked
    if pos + size != len(data):
        raise FormatError("bytes after the footer")
    (nb,) = struct.unpack_from("<Q", data, pos + 9)
    if size != 33 + 12 * nb or nb != len(offsets):
        raise FormatError("footer does not list the batch sections")
    q = pos + 17
    for off, n in offsets:
        if struct.unpack_from("<QI", data, q) != (off, n):
            raise FormatError("footer entry does not match its section")
        q += 12
    (total,) = struct.unpack_from("<Q", data, q)
    fsize, fmagic = struct.unpack_from("<I4s", data, q + 8)
    if total != sum(n for _o, n in offsets) or fsize != size or (
            fmagic != MAGIC):
        raise FormatError("footer totals")
    return File(xsize, ysize, shift, bool(hflags & HDR_F_BIG_ENDIAN),
                chunk_log2, fpb, bool(hflags & HDR_F_DELTA_IS_FRAME0),
                dflags, dh, dl, batches)


def streams(f: File) -> list[tuple[str, Stream]]:
    """Every plane stream of ``f`` in file order, named."""
    out = [("delta high", f.delta_high)]
    if f.delta_low is not None:
        out.append(("delta low", f.delta_low))
    for i, b in enumerate(f.batches):
        for name, st in (("high", b.high), ("low", b.low),
                         ("preview", b.preview)):
            if st is not None:
                out.append((f"batch {i} {name}", st))
    return out


# ---------------------------------------------------------------------------
# rANS


def _decode_table(st: Stream) -> np.ndarray:
    """int64 [ctx * 2^bits + slot] entries sym | f << 8 | (slot - cum) << 24
    (one context for order-0)."""
    bits = CTX_BITS if st.coding == CODING_CTX16 else ORDER0_BITS
    freq = st.freq.reshape(-1, st.freq.shape[-1])
    slots = np.arange(1 << bits, dtype=np.int64)
    rows = []
    for f in freq:
        cum = np.concatenate([[0], np.cumsum(f)])
        sym = np.searchsorted(cum, slots, side="right") - 1
        rows.append(sym | (f[sym] << 8) | ((slots - cum[sym]) << 24))
    return np.concatenate(rows)


def _lane_lengths(st: Stream) -> np.ndarray:
    """int64 [nblocks, lanes]: how many symbols each lane codes."""
    span = st.chunk_len * st.lanes
    rem = np.clip(st.symbols - np.arange(st.nblocks, dtype=np.int64) * span,
                  0, span)
    lane = np.arange(st.lanes, dtype=np.int64)
    n = (rem[:, None] - lane[None, :] + st.lanes - 1) // st.lanes
    return np.clip(n, 0, st.chunk_len)


def _decode_group(group: list[Stream], device) -> tuple[list, list]:
    """Decode coded streams that share coding, chunk length and lane count
    together, one symbol step of every lane at a time -> (per stream the
    flat u8 symbols, per stream the number of failed integrity checks)."""
    st0 = group[0]
    k, lanes, nseg = st0.chunk_len, st0.lanes, st0.nseg
    ctx = st0.coding == CODING_CTX16
    bits = CTX_BITS if ctx else ORDER0_BITS
    tables = [_decode_table(st) for st in group]
    tab_base, states, counts, starts, lens, tab_ids = [], [], [], [], [], []
    word_off = 0
    tab_off = 0
    for st, tab in zip(group, tables):
        states.append(st.states.astype(np.int64).reshape(st.nblocks, lanes))
        c = st.counts.astype(np.int64)
        counts.append(c)
        flat = np.concatenate([[0], np.cumsum(c.reshape(-1))[:-1]])
        starts.append(flat.reshape(c.shape) + word_off)
        word_off += int(c.sum())
        lens.append(_lane_lengths(st))
        tab_ids.append(np.full(st.nblocks, tab_off, np.int64))
        tab_base.append(tab)
        tab_off += len(tab)
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    table = put(np.concatenate(tab_base))
    payload = put(np.concatenate([st.payload for st in group]).astype(
        np.int64))
    x = put(np.concatenate(states))
    cnt = put(np.concatenate(counts))
    start = put(np.concatenate(starts))
    ln = put(np.concatenate(lens))
    tbase = put(np.concatenate(tab_ids))[:, None]
    nb = x.shape[0]
    out = torch.zeros((nb, k, lanes), dtype=torch.uint8, device=dev)
    prev = torch.zeros((nb, lanes), dtype=torch.int64, device=dev)
    bad = torch.zeros(nb, dtype=torch.int64, device=dev)
    mask = (1 << bits) - 1
    jmax = int(ln.max()) if ln.numel() else 0
    ptr = base = None
    last = payload.numel() - 1
    for j in range(jmax):
        if j % SEG_LEN == 0:
            if j:
                bad += (ptr != 0).to(torch.int64)
            ptr = cnt[:, j // SEG_LEN].clone()
            base = start[:, j // SEG_LEN]
        active = j < ln
        slot = x & mask
        idx = tbase + slot
        if ctx:
            c = prev * 2 + (torch.roll(prev, 1, 1) != torch.roll(prev, -1, 1))
            idx = idx + (c << bits)
        e = table[idx]
        sym = e & 0xFF
        xn = ((e >> 8) & 0xFFFF) * (x >> bits) + (e >> 24)
        renorm = active & (xn < RANS_L)
        r = renorm.to(torch.int64)
        total = r.sum(1)
        pos = (base + ptr - total)[:, None] + torch.cumsum(r, 1) - r
        word = payload[pos.clamp(0, max(last, 0))] if last >= 0 else 0
        xn = torch.where(renorm, (xn << 16) | word, xn)
        x = torch.where(active, xn, x)
        ptr = ptr - total
        prev = torch.where(active, sym, 0)
        out[:, j] = prev.to(torch.uint8)
    seg = (jmax - 1) // SEG_LEN if jmax else -1
    if ptr is not None:
        bad += (ptr != 0).to(torch.int64)
    if seg + 1 < nseg:
        bad += (cnt[:, seg + 1:] != 0).sum(1)
    lane_bad = ((x != RANS_L) & (ln > 0)).sum(1)
    bad += lane_bad
    syms, faults = [], []
    b0 = 0
    for st in group:
        blk = out[b0 : b0 + st.nblocks]
        if ctx:
            blk = blk << 4  # the nibble is the byte's high half
        syms.append(blk.reshape(-1)[: st.symbols])
        faults.append(int(bad[b0 : b0 + st.nblocks].sum()))
        b0 += st.nblocks
    return syms, faults


def decode_streams(sts: list[Stream], device) -> tuple[list, list]:
    """Every stream's flat u8 planes (nframes * plane_size) on ``device``
    and its number of failed integrity checks."""
    out: list = [None] * len(sts)
    faults = [0] * len(sts)
    groups: dict[tuple, list[int]] = {}
    for i, st in enumerate(sts):
        if st.coding == CODING_CONST:
            out[i] = torch.full((st.symbols,), st.value, dtype=torch.uint8,
                                device=device)
        elif st.coding == CODING_RAW:
            out[i] = torch.from_numpy(st.raw.copy()).to(device)
        else:
            groups.setdefault((st.coding, st.chunk_len, st.lanes),
                              []).append(i)
    for idx in groups.values():
        syms, bad = _decode_group([sts[i] for i in idx], device)
        for i, s, b in zip(idx, syms, bad):
            out[i], faults[i] = s, b
    return out, faults


# ---------------------------------------------------------------------------
# prediction


def up_inverse(res: torch.Tensor) -> torch.Tensor:
    """[B, H, W] u8 residuals of 'up' -> planes: a running sum down each
    column, mod 256."""
    return (torch.cumsum(res.to(torch.int64), 1) & 0xFF).to(torch.uint8)


def cg2d_inverse(res: torch.Tensor) -> torch.Tensor:
    """[B, H, W] u8 residuals of CG2D -> planes.  Row 0 is stored as is,
    column 0 predicts from north, other pixels from clamp(n + w - nw,
    min(n, w), max(n, w)); every pixel of an anti-diagonal depends only on
    earlier ones, so one diagonal is done at a time."""
    b, h, w = res.shape
    out = res.to(torch.int64).clone()
    out[:, :, 0] = torch.cumsum(out[:, :, 0], 1) & 0xFF
    flat = out.view(b, h * w)
    dev = res.device
    for d in range(2, h + w - 1):
        y = torch.arange(max(1, d - w + 1), min(d - 1, h - 1) + 1,
                         device=dev)
        if not y.numel():
            continue
        i = y * w + (d - y)
        n, wv, nw = flat[:, i - w], flat[:, i - 1], flat[:, i - w - 1]
        pred = torch.minimum(torch.maximum(n + wv - nw, torch.minimum(n, wv)),
                             torch.maximum(n, wv))
        flat[:, i] = (flat[:, i] + pred) & 0xFF
    return out.to(torch.uint8)


def spatial_inverse(res: torch.Tensor, modes: np.ndarray) -> torch.Tensor:
    """Each frame's spatial predictor (modes [B]: none, up, CG2D) undone."""
    out = res.clone()
    for mode, fn in ((SPATIAL_UP, up_inverse), (SPATIAL_CG2D, cg2d_inverse)):
        sel = np.flatnonzero(modes == mode)
        if sel.size:
            t = torch.from_numpy(sel).to(res.device)
            out[t] = fn(res[t])
    if ((modes < 0) | (modes > SPATIAL_CG2D)).any():
        raise FormatError("unknown spatial predictor")
    return out


def box_preview(high: torch.Tensor) -> torch.Tensor:
    """[B, H, W] u8 high planes -> [B, H//4, W//4] previews: the 4x4 box
    mean, its lowest bit cleared."""
    b, h, w = high.shape
    ph, pw = h // 4, w // 4
    s = high[:, : ph * 4, : pw * 4].to(torch.int64).reshape(
        b, ph, 4, pw, 4).sum((2, 4))
    return ((s // 16) & 0xFE).to(torch.uint8)


# ---------------------------------------------------------------------------
# the file


@dataclasses.dataclass
class Decoded:
    frames: torch.Tensor  # int32 [N, H, W] u16 values, left-aligned
    previews: torch.Tensor  # u8 [frames in batches, H//4, W//4]
    faults: int  # failed integrity checks of the rANS streams


def decode(f: File, device="cpu") -> Decoded:
    """Decode a parsed file: every frame (left-aligned u16 values, frame 0
    the delta frame when the header says so) and every batch frame's
    preview."""
    return decode_files([f], device)[0]


def decode_files(fs: list[File], device="cpu") -> list[Decoded]:
    """:func:`decode` of several files, their rANS streams decoded together
    (one step loop for all of them)."""
    if any(f.big_endian for f in fs):
        raise FormatError("big-endian files are not in this reader's scope")
    named = [(k, n, st) for k, f in enumerate(fs) for n, st in streams(f)]
    planes, faults = decode_streams([st for _k, _n, st in named], device)
    out = []
    for k, f in enumerate(fs):
        mine = [(n, p, b) for (kk, n, _s), p, b in zip(named, planes, faults)
                if kk == k]
        out.append(_rebuild(f, {n: p for n, p, _b in mine},
                            sum(b for _n, _p, b in mine), device))
    return out


def _rebuild(f: File, got: dict, faults: int, device) -> Decoded:
    """Frames and previews of ``f`` from its decoded streams ``got``."""
    h, w = f.ysize, f.xsize
    zero = torch.zeros((h, w), dtype=torch.uint8, device=device)
    dh = spatial_inverse(got["delta high"].view(1, h, w),
                         np.array([(f.dflags >> F_SPATIAL_SHIFT) & 3]))[0]
    dl = got["delta low"].view(h, w) if f.delta_low is not None else zero
    frames = [(dh.to(torch.int32) << 8 | dl.to(torch.int32))[None]] if (
        f.delta_is_frame0) else []
    previews = []
    pv_delta = box_preview(dh[None])[0]
    for i, b in enumerate(f.batches):
        n = len(b.flags)
        flags = b.flags.astype(np.int64)
        hi = spatial_inverse(got[f"batch {i} high"].view(n, h, w),
                             (flags >> F_SPATIAL_SHIFT) & 3)
        lo = (got[f"batch {i} low"].view(n, h, w) if b.low is not None
              else torch.zeros((n, h, w), dtype=torch.uint8, device=device))
        ph_, pl_ = dh, dl
        his, los = [], []
        for t in range(n):
            if flags[t] & F_USE_PREV and flags[t] & F_USE_DELTA:
                raise FormatError("USE_PREV with USE_DELTA")
            if flags[t] & F_USE_PREV:
                ref_h, ref_l = ph_, pl_
            elif flags[t] & F_USE_DELTA:
                ref_h, ref_l = dh, dl
            else:
                ref_h = ref_l = zero
            ph_, pl_ = hi[t] + ref_h, lo[t] + ref_l  # u8: mod 256
            his.append(ph_)
            los.append(pl_)
        frames.append(torch.stack(his).to(torch.int32) << 8
                      | torch.stack(los).to(torch.int32))
        if b.preview is not None:
            pv = spatial_inverse(
                got[f"batch {i} preview"].view(n, h // 4, w // 4),
                (flags >> F_PV_SPATIAL_SHIFT) & 3)
            use = torch.from_numpy(flags & F_PV_USE_DELTA != 0).to(device)
            previews.append(torch.where(use[:, None, None], pv + pv_delta,
                                        pv))
        else:
            previews.append(torch.zeros((n, h // 4, w // 4),
                                        dtype=torch.uint8, device=device))
    empty = torch.zeros((0, h // 4, w // 4), dtype=torch.uint8, device=device)
    return Decoded(torch.cat(frames) if frames else torch.zeros(
        (0, h, w), dtype=torch.int32, device=device),
        torch.cat(previews) if previews else empty, faults)


def left_aligned(frames: torch.Tensor, shift: int) -> torch.Tensor:
    """Camera samples (right-aligned, int32) -> the u16 values a reader
    returns for a little-endian file of that shift."""
    return (frames.to(torch.int32) << shift) & 0xFFFF


def stream_geometry(f: File) -> list[dict]:
    """Per rANS-coded stream: coding, blocks, chunk length, lanes,
    segments and payload words (what fpvbench/bytecount.py counts)."""
    return [dict(name=n, coding=st.coding, nblocks=st.nblocks,
                 chunk_len=st.chunk_len, lanes=st.lanes, nseg=st.nseg,
                 words=int(st.counts.sum(dtype=np.int64)))
            for n, st in streams(f)
            if st.coding in (CODING_ORDER0, CODING_CTX16)]

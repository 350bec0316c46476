"""Multi-device scaling: device meshes, sharded codec steps and whole files.

The JAX package shards frames over a ``jax.sharding.Mesh`` (frames over
``data``, rows of very large frames over ``space``) and lets GSPMD insert
the collectives.  The port keeps that layout as an explicit grid of torch
devices and runs each shard's work on its own device, on a CUDA stream of
its own, so the shards of D cards (or D logical shards on one card)
overlap.  What crosses shards is what crosses them in JAX: the histogram
sums and support-mask unions, the decision costs of row shards, and the
halo rows the predictors and the preview read across a row cut.  The
reference's only parallelism is a worker pool over frames
(fusion_power_video.cc:1199-1230); streams and batch sections are
independent, so the data axis scales without cross-shard traffic but for
those small reductions.

A device may appear more than once in a mesh: logical shards sharing one
card, or the CPU in the tests.  A mesh may span processes
(``parallel.distributed.global_data_mesh``): each process then computes
only the data rows it owns, and host bytes cross processes through
``torch.distributed`` (gloo).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from fpv_tpu_torch.api.fpvt_codec import (
    FpvtReader,
    FpvtWriter,
    _decode_plane,
    _decode_staged,
    _flag_hints,
    _fused_decodable,
    _frame_rows,
    _mags,
    _mask_of_ranges,
    _pack_flags,
    _run_sums,
    _tree_f32,
    _value_ranges,
    _where3,
    encode_model_step,
    batch_decode_args,
    file_encode_setup,
    fused_decode_batch,
    fused_encode_batch,
    put_frames,
    section_rows_need,
)
from fpv_tpu_torch.entropy import plane_codec
from fpv_tpu_torch.entropy.plane_codec import (
    _hist_flat,
    _to_block_symbols,
    lens_tensor,
    upload,
)
from fpv_tpu_torch.entropy.tables_device import (
    encode_tables_device,
    fused_decode_tables_device,
    normalize_freqs_device,
)
from fpv_tpu_torch.format import fpvt
from fpv_tpu_torch.format.fpvt import SPATIAL_CG2D, SPATIAL_UP
from fpv_tpu_torch.ops import rans_cuda
from fpv_tpu_torch.ops.planes import combine_planes, split_planes, to_int16
from fpv_tpu_torch.ops.predict import clamped_gradient, cg2d_encode, up_encode
from fpv_tpu_torch.ops.preview import generate_preview
from fpv_tpu_torch.ops.rans_layout import (
    CODING_CONST,
    CODING_CTX16,
    CODING_ORDER0,
    CODING_RAW,
)
from fpv_tpu_torch.utils.profiling import annotate

_STRIDE = 16  # fpvt_codec's decision and histogram row strides


class Mesh:
    """A ``[data, space]`` grid of torch devices.

    ``shape`` is ``{"data": D, "space": S}``.  ``ranks`` names the process
    owning each data row (None: this process owns the whole mesh); a
    process computes only the rows it owns."""

    axis_names = ("data", "space")

    def __init__(self, devices, ranks=None) -> None:
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError("a mesh is a non-empty [data, space] grid")
        if ranks is not None and len(ranks) != len(grid):
            raise ValueError("one rank per data row")
        self.devices = grid
        self.shape = {"data": len(grid), "space": len(grid[0])}
        self.ranks = None if ranks is None else list(ranks)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len(set(self.ranks)) > 1

    def owns(self, d: int) -> bool:
        """Whether this process computes data row ``d``."""
        return self.ranks is None or self.ranks[d] == dist.get_rank()


class _Shard:
    """One mesh position's device and, on a card, a stream of its own."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def on(self):
        """Context queuing work on the shard's stream (no-op on the CPU)."""
        return torch.cuda.stream(self.stream)

    def sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    space: int = 1,
    devices=None,
) -> Mesh:
    """A (data, space) mesh over the first ``n_devices`` of ``devices``
    (default: every visible card; without one this raises, it never falls
    back to the CPU).  ``devices`` may name one device more than once:
    logical shards on one card, or ``[torch.device("cpu")] * D``."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("PyTorch sees no CUDA device; pass devices= "
                               "(e.g. [torch.device('cpu')] * n) for the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    if data is None:
        data = n_devices // space
    if data < 1 or space < 1 or data * space > len(devs):
        raise ValueError(f"a {data} x {space} mesh needs {data * space} "
                         f"devices, {len(devs)} given")
    return Mesh([devs[d * space : (d + 1) * space] for d in range(data)])


def shard_frames(imgs: np.ndarray, mesh: Mesh) -> list[list]:
    """Place [B, H, W] u16 (or u8) frames with B over 'data' and H over
    'space' -> grid [D][S] of int32 tensors of u16 samples, each on its
    mesh device (None where another process owns the row).  D must divide
    B and S must divide H."""
    arr = np.asarray(imgs)
    nd, ns = mesh.shape["data"], mesh.shape["space"]
    b, h = arr.shape[:2]
    if b % nd or h % ns:
        raise ValueError(f"{b} frames of {h} rows do not split over a "
                         f"{nd} x {ns} mesh")
    bl, hl = b // nd, h // ns
    grid = [[put_frames(arr[i * bl : (i + 1) * bl, j * hl : (j + 1) * hl],
                        mesh.devices[i][j]) if mesh.owns(i) else None
             for j in range(ns)] for i in range(nd)]
    for dev in {d for row in mesh.devices for d in row}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the uploads have landed
    return grid


def _reduce(mesh: Mesh, parts: list[torch.Tensor], op: str) -> torch.Tensor:
    """Host tensors of the shards this process computed -> their ``op``
    ("sum", "min") over every shard of the mesh: a sum or minimum here,
    then an all_reduce over the processes of a mesh that spans them."""
    stacked = torch.stack(parts)
    out = stacked.sum(0) if op == "sum" else stacked.amin(0)
    if mesh.spans_processes:
        dist.all_reduce(out, dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MIN)
    return out


def _map(fn, items: list) -> list:
    """``fn`` over ``items``, one thread each (shards overlap: each thread
    queues on its own shard's stream, and host steps release the
    interpreter lock in native code)."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(len(items)) as pool:
        return list(pool.map(fn, items))


def _host_u8(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.uint8)


def _data_shards(mesh: Mesh) -> list[_Shard | None]:
    """The data axis of a data-only mesh: one shard per row (None where
    another process owns it)."""
    if mesh.shape["space"] != 1:
        raise ValueError("this path shards frames over 'data' only: pass a "
                         "mesh whose space axis has size 1")
    return [_Shard(mesh.devices[d][0]) if mesh.owns(d) else None
            for d in range(mesh.shape["data"])]


# ---------------------------------------------------------------------------
# the model step, sharded over frames and rows


def _rotating_rows(g: torch.Tensor, rows: int) -> torch.Tensor:
    """[len(g), nr] global indices of the rows that
    ``fpvt_codec._sample_rows_rotating`` samples in frames ``g`` (global
    frame indices) of a plane of ``rows`` rows."""
    nr = max(rows // _STRIDE, 1)
    offs = torch.clamp(g % _STRIDE, max=max(rows - 1 - (nr - 1) * _STRIDE, 0))
    return offs[:, None] + _STRIDE * torch.arange(nr, device=g.device)[None]


def _kept_runs(rows: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """[B, R, W] u8 residual rows, [B, R] bool -> [B, count] int64 exact
    run sums (``fpvt_codec._run_sums``) of the kept rows' magnitudes (the
    others count 0).  The run sums of a data row's space shards add up to
    the whole sample's, so the float32 cost built from them equals the
    single-device step's."""
    return _run_sums(_mags(rows * keep[:, :, None]))


def _costs(runs: torch.Tensor, widths: list[int]) -> list[torch.Tensor]:
    """Concatenated run sums -> one float32 [B] cost per ``widths`` part,
    in ``fpvt_codec._cost``'s order."""
    return [_tree_f32(r) for r in runs.split(widths, dim=1)]


def _local_rows(x: torch.Tensor, y0: int, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (global, [B, R]) of ``x``, whose row 0 is global row
    ``y0``; rows outside ``x`` read a clamped row (callers mask them)."""
    return _frame_rows(x, (idx - y0).clamp(0, x.shape[1] - 1))


def _owned_runs(x, y0: int, idx, lo: int, hi: int) -> torch.Tensor:
    """[B, count] int64 run sums of rows ``idx`` of ``x`` that lie in
    [lo, hi)."""
    return _kept_runs(_local_rows(x, y0, idx), (idx >= lo) & (idx < hi))


def _gather_rows(row: list, hl: int, lo: int, hi: int, device) -> torch.Tensor:
    """Global rows [lo, hi) of one data row's space shards (each ``hl``
    rows) on ``device``: the shard's own rows and its halo rows, copied
    from the shards that hold them."""
    parts = []
    for j in range(lo // hl, -(-hi // hl)):
        a, b = max(lo, j * hl) - j * hl, min(hi, (j + 1) * hl) - j * hl
        parts.append(row[j][:, a:b].to(device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


class _RowShard:
    """One shard's rows of the model step: its own image rows [r0, r1),
    its preview rows [p0, p1) (a preview row belongs to the shard holding
    its first image row), and the extended rows [lo, hi) it reads: the
    row above its own (up and CG2D predictors), the image rows of the
    preview row above its own (the preview's predictors) and the rows
    completing its last preview row."""

    def __init__(self, j: int, hl: int, ph: int) -> None:
        self.r0, self.r1 = j * hl, (j + 1) * hl
        self.p0 = min(-(-self.r0 // 4), ph)
        self.p1 = min(-(-self.r1 // 4), ph)
        self.pa = self.p0 - 1 if self.p0 else 0  # first preview row read
        self.lo = min(self.r0 - 1, 4 * self.pa) if self.r0 else 0
        self.hi = max(self.r1, 4 * self.p1)


def _model_step(mesh, grid, delta_high, delta_low, shift, big_endian):
    """:func:`sharded_encode_model_step`'s work, in three shard-local
    phases with a host reduction between them (decision costs are summed
    over each data row's space shards; histograms and value ranges over
    the whole mesh)."""
    nd, ns = mesh.shape["data"], mesh.shape["space"]
    bl, hl, w = grid[0][0].shape
    h = hl * ns
    ph, pw = h // 4, w // 4
    has_pv = ph * pw > 0
    dh_host, dl_host = _host_u8(delta_high), _host_u8(delta_low)
    cells = [(i, j) for i in range(nd) for j in range(ns)]
    shards = {c: _Shard(mesh.devices[c[0]][c[1]]) for c in cells}
    geo = {c: _RowShard(c[1], hl, ph) for c in cells}
    st: dict = {c: {} for c in cells}

    def host(name):
        out = {}
        for c in cells:
            with shards[c].on():
                out[c] = st[c].pop(name).cpu()
        return out

    def row_sums(parts):
        return [torch.stack([parts[(i, j)] for j in range(ns)]).sum(0)
                for i in range(nd)]

    # phase A: split, previews, temporal and preview-delta costs
    for c in cells:
        i, j = c
        sh, gm, s = shards[c], geo[c], st[c]
        dev = sh.device
        with sh.on():
            imgs = _gather_rows(grid[i], hl, gm.lo, gm.hi, dev)
            high_e, low_e, _nz = split_planes(imgs, shift, big_endian)
            dh_e = upload(dh_host[gm.lo : gm.hi], dev)
            own = slice(gm.r0 - gm.lo, gm.r1 - gm.lo)
            g = torch.arange(i * bl, (i + 1) * bl, device=dev)
            ridx = _rotating_rows(g, h)
            dhe = high_e - dh_e[None]
            pvs = slice(4 * gm.pa - gm.lo, 4 * gm.p1 - gm.lo)
            pv_e = generate_preview(high_e[:, pvs])
            pvd_e = pv_e - generate_preview(dh_e[None, pvs])
            pidx = _rotating_rows(g, ph)
            costs = [_owned_runs(high_e, gm.lo, ridx, gm.r0, gm.r1),
                     _owned_runs(dhe, gm.lo, ridx, gm.r0, gm.r1)]
            if has_pv:
                costs += [_owned_runs(x, gm.pa, pidx, gm.p0, gm.p1)
                          for x in (pv_e, pvd_e)]
            else:
                costs += [torch.zeros_like(costs[0][:, :1])] * 2
            low = low_e[:, own]
            costs.append((low != 0).flatten(1).any(dim=1, keepdim=True)
                         .to(torch.int64))
            widths_a = [c.shape[1] for c in costs]
            s.update(high_e=high_e, dhe=dhe, low=low, pv_e=pv_e, pvd_e=pvd_e,
                     pidx=pidx, g=g, dl=upload(dl_host[gm.r0 : gm.r1], dev),
                     part=torch.cat(costs, dim=1))
    tot = [_costs(t, widths_a) for t in row_sums(host("part"))]
    use_delta = [t[1] < t[0] for t in tot]
    pv_use_delta = [t[3] < t[2] for t in tot]
    nonzero_low = [t[4] > 0 for t in tot]

    # phase B: temporal choice, spatial and preview-spatial costs
    for c in cells:
        i, _j = c
        sh, gm, s = shards[c], geo[c], st[c]
        dev = sh.device
        with sh.on():
            ud = upload(use_delta[i].numpy(), dev)
            high2_e = _where3(ud, s.pop("dhe"), s.pop("high_e"))
            s["low2"] = _where3(ud, s["low"] - s.pop("dl")[None],
                                s.pop("low"))
            nrp = max((h - 1) // _STRIDE, 1)
            offs = torch.clamp(s["g"] % _STRIDE,
                               max=max(h - 2 - (nrp - 1) * _STRIDE, 0))
            pidx = offs[:, None] + _STRIDE * torch.arange(nrp, device=dev)
            cidx = torch.clamp(pidx + 1, max=h - 1)
            cur = _local_rows(high2_e, gm.lo, cidx)
            north = _local_rows(high2_e, gm.lo, pidx)
            cg_s = cur - clamped_gradient(north, torch.roll(cur, 1, dims=2),
                                          torch.roll(north, 1, dims=2))
            keep = (cidx >= gm.r0) & (cidx < gm.r1)
            costs = [_kept_runs(x, keep) for x in (cur, cur - north, cg_s)]
            pv2_e = _where3(upload(pv_use_delta[i].numpy(), dev),
                            s.pop("pvd_e"), s.pop("pv_e"))
            p_up = p_cg = pv2_e  # an empty preview has no predictor
            if has_pv:
                p_up, p_cg = up_encode(pv2_e), cg2d_encode(pv2_e)
                costs += [_owned_runs(x, gm.pa, s["pidx"], gm.p0, gm.p1)
                          for x in (pv2_e, p_up, p_cg)]
            else:
                costs += [torch.zeros_like(costs[0][:, :1])] * 3
            widths_b = [c.shape[1] for c in costs]
            s.update(high2_e=high2_e, pv2_e=pv2_e, p_up=p_up, p_cg=p_cg,
                     part=torch.cat(costs, dim=1))
    tot = [torch.stack(_costs(t, widths_b)) for t in row_sums(host("part"))]
    spatial = [torch.argmin(t[:3], dim=0).to(torch.int32) for t in tot]
    pv_spatial = [torch.argmin(t[3:], dim=0).to(torch.int32) for t in tot]

    # phase C: residual planes, histograms, value ranges
    def choose(sel, up, cg, plain):
        return _where3(sel == SPATIAL_UP, up,
                       _where3(sel == SPATIAL_CG2D, cg, plain))

    for c in cells:
        i, _j = c
        sh, gm, s = shards[c], geo[c], st[c]
        dev = sh.device
        with sh.on():
            high2_e = s.pop("high2_e")
            top = gm.r0 - 1 if gm.r0 else 0
            blk = high2_e[:, top - gm.lo : gm.r1 - gm.lo]
            cut = gm.r0 - top
            sp = upload(spatial[i].numpy(), dev)
            high3 = choose(sp, up_encode(blk)[:, cut:],
                           cg2d_encode(blk)[:, cut:],
                           high2_e[:, gm.r0 - gm.lo : gm.r1 - gm.lo])
            k = gm.p0 - gm.pa
            pv3 = choose(upload(pv_spatial[i].numpy(), dev),
                         s.pop("p_up")[:, k:], s.pop("p_cg")[:, k:],
                         s.pop("pv2_e")[:, k:])
            start = -gm.r0 % _STRIDE
            low2 = s["low2"]
            s.update(high=high3, preview=pv3, hist=torch.stack([
                _hist_flat(high3[:, start::_STRIDE], 256),
                _hist_flat(low2[:, start::_STRIDE], 256),
                _hist_flat(pv3, 256)]))
            # (min, -max, rmin, -rmax): one minimum reduces all four
            s["ranges"] = torch.stack([_value_ranges(p) for p in (high3, low2)]
                                      ) * torch.tensor([1, -1, 1, -1],
                                                       device=dev)
    hist = _reduce(mesh, list(host("hist").values()), "sum")
    ranges = _reduce(mesh, list(host("ranges").values()), "min") * torch.tensor(
        [1, -1, 1, -1])
    for sh in shards.values():
        sh.sync()

    home = mesh.devices[0][0]

    def gather(name, dim):
        return torch.cat([torch.cat([st[(i, j)][name].to(home)
                                     for j in range(ns)], dim=dim)
                          for i in range(nd)])

    def frames(vals):
        return torch.cat(vals).to(home)

    out = dict(
        high=gather("high", 1),
        low=gather("low2", 1),
        preview=gather("preview", 1),
        use_delta=frames(use_delta),
        use_prev=torch.zeros(nd * bl, dtype=torch.bool, device=home),
        spatial=frames(spatial),
        pv_spatial=frames(pv_spatial),
        pv_use_delta=frames(pv_use_delta),
        nonzero_low=frames(nonzero_low),
        hist_high=hist[0].to(home),
        hist_low=hist[1].to(home),
        hist_preview=hist[2].to(home),
        mask_high=_mask_of_ranges(ranges[0]).to(home),
        mask_low=_mask_of_ranges(ranges[1]).to(home),
        mask_preview=(hist[2] > 0).to(torch.int32).to(home),
    )
    for dev in {sh.device for sh in shards.values()}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the gathers have read the shards
    return out


def sharded_encode_model_step(mesh: Mesh, shift: int = 0,
                              big_endian: bool = False):
    """A model step sharded over ``mesh`` -> ``step(imgs, delta_high,
    delta_low)``, the dict of ``fpvt_codec.encode_model_step`` (with the
    static-delta candidate and no prev-frame one, as the JAX step) on the
    whole batch, equal to it value for value.

    ``imgs``: [B, H, W] u16 numpy frames or :func:`shard_frames`' grid;
    the delta planes u8 [H, W] (numpy or tensors).  Frames shard over
    'data' and rows over 'space'; each shard computes on its own rows plus
    the halo rows its predictors and preview read (copied from the shards
    holding them).  Per-frame decisions sample rows by their global index,
    so their costs are summed over the space shards before a decision is
    made; histograms and value ranges (support masks) are reduced over
    the mesh.  The outputs are gathered onto the mesh's first device."""
    if mesh.spans_processes:
        raise ValueError("the sharded model step runs in one process")

    def step(imgs, delta_high, delta_low) -> dict:
        grid = imgs if isinstance(imgs, list) else shard_frames(imgs, mesh)
        return _model_step(mesh, grid, delta_high, delta_low, shift,
                           big_endian)

    return step


# ---------------------------------------------------------------------------
# the fused codec over the data axis


def sharded_fused_encode(
    mesh: Mesh,
    shift: int = 0,
    big_endian: bool = False,
    chunk_len: int = 512,
    low_coding: int = CODING_ORDER0,
    allow_prev: bool = False,
):
    """The production ``fused_encode_batch`` over the data axis -> ``f(imgs,
    delta_high, delta_low)`` -> per data shard, in device order, its
    ``(flags, (high, low, preview) streams)``: each shard encodes its frame
    slice on its own device (shard-local tables and streams), bit-identical
    to ``fused_encode_batch`` on that slice alone.  Shards of another
    process give None.  ``low_coding=CODING_CTX16`` is the shipping
    configuration (the writer's default for shift >= 4)."""
    shards = _data_shards(mesh)

    def f(imgs, delta_high, delta_low) -> list:
        arr = np.asarray(imgs)
        bl = arr.shape[0] // len(shards)
        dh, dl = _host_u8(delta_high), _host_u8(delta_low)

        def one(d):
            sh = shards[d]
            with sh.on():
                x = put_frames(arr[d * bl : (d + 1) * bl], sh.device)
                return fused_encode_batch(
                    x, upload(dh, sh.device), upload(dl, sh.device), shift,
                    big_endian, chunk_len, low_coding, allow_prev)

        owned = [d for d, sh in enumerate(shards) if sh is not None]
        got = dict(zip(owned, _map(one, owned)))
        return [got.get(d) for d in range(len(shards))]

    return f


def _codec_planes(m: dict, b: int, h: int, w: int):
    """(name, [B, S] plane, symbols per frame) of a model step's planes."""
    return [(n, m[n].reshape(b, -1), s) for n, s in
            (("high", h * w), ("low", h * w),
             ("preview", (h // 4) * (w // 4))) if s]


def sharded_codec_roundtrip(
    mesh: Mesh,
    chunk_len: int = 64,
    shift: int = 0,
    big_endian: bool = False,
):
    """The full codec data-parallel over ``mesh`` -> ``f(imgs, delta_high,
    delta_low) -> (frames, ok)``: per shard the model step (prev-frame
    candidate on), device tables, K1 (one grouped launch), K2 (one), the
    inverse predictions (K3 on CG2D frames) and the plane combine.  The one
    collective is the tables' input: the histograms summed and the
    support masks OR-ed over every shard (an all_reduce across the
    processes of a mesh that spans them), so all shards code with one
    shared table per plane.  ``frames`` are this process's shards'
    reconstructions ([B, H, W] u16, left-aligned as the decoder returns
    them; all frames for an in-process mesh); ``ok`` is true only if every
    shard's rANS integrity checks, preview round trip and pixel compare
    (against the left-aligned input) are.  The JAX package compares with
    the input itself, so its ``ok`` is false at any shift but 0."""
    shards = _data_shards(mesh)

    def f(imgs, delta_high, delta_low):
        arr = np.asarray(imgs)
        bl, h, w = arr.shape[0] // len(shards), arr.shape[1], arr.shape[2]
        dh_host, dl_host = _host_u8(delta_high), _host_u8(delta_low)
        owned = [d for d, sh in enumerate(shards) if sh is not None]
        st = {}
        for d in owned:  # issue every shard's model step, then read them
            sh = shards[d]
            with sh.on():
                x = put_frames(arr[d * bl : (d + 1) * bl], sh.device)
                dh, dl = upload(dh_host, sh.device), upload(dl_host, sh.device)
                m = encode_model_step(x, dh, dl, shift, big_endian,
                                      allow_prev=True)
                planes = _codec_planes(m, bl, h, w)
                st[d] = dict(x=x, dh=dh, dl=dl, m=m, planes=planes,
                             part=torch.stack([torch.stack(
                                 [m[f"hist_{n}"], m[f"mask_{n}"].long()])
                                 for n, _p, _s in planes]))
        parts = []
        for d in owned:
            with shards[d].on():
                parts.append(st[d].pop("part").cpu())
        tables = _reduce(mesh, parts, "sum")

        def one(d):
            sh, s = shards[d], st.pop(d)
            with sh.on():
                return _shard_roundtrip(s, tables.to(sh.device), bl, h, w,
                                        chunk_len, shift, big_endian)

        outs = _map(one, owned)
        ok = _reduce(mesh, [torch.tensor(int(o)) for _f, o in outs], "min")
        frames = (np.concatenate([f for f, _o in outs]) if outs
                  else np.zeros((0, h, w), np.uint16))
        return frames, bool(ok)

    return f


def _shard_roundtrip(s: dict, tables, b: int, h: int, w: int, k: int,
                     shift: int, big_endian: bool):
    """One shard's encode, decode and checks -> (frames u16, ok).  The
    pixel compare holds the decode to the frames as the split gives them
    (left-aligned: the input itself only at shift 0 little-endian)."""
    dev = s["x"].device
    enc, dec = [], []
    for (_n, plane, n_sym), (hist, mask) in zip(s["planes"], tables):
        freq = normalize_freqs_device(hist, (mask > 0).to(torch.int32))
        lens = lens_tensor(b, n_sym, k, dev)
        syms = _to_block_symbols(plane, k, lens.shape[0])
        enc.append(rans_cuda.EncodePlane(syms, lens,
                                         encode_tables_device(freq)))
        dec.append((lens, fused_decode_tables_device(freq)))
    coded = rans_cuda.rans_encode_grouped(enc)
    names = [n for n, _p, _s in s["planes"]]
    jobs = [_decode_plane(counts, 0, states, lens, k, table,
                          rans_cuda.staged_payload(payload), False)
            for (states, counts, payload), (lens, table) in zip(coded, dec)]
    staged = plane_codec.StagedRanges(
        names, [None] * len(jobs), plane_codec.StagedBlocks(names, jobs),
        [(i, 0, b * n_sym) for i, (_n, _p, n_sym) in enumerate(s["planes"])])
    flags = _pack_flags(s["m"])
    high, low, pv, _coded, ok = _decode_staged(
        staged, names, upload(flags.astype(np.int32), dev),
        _flag_hints(flags), b, h, w, s["dh"], s["dl"])
    out = combine_planes(high, low)
    want_high, want_low = split_planes(s["x"], shift, big_endian)[:2]
    oks = [ok.all(), torch.equal(out, combine_planes(want_high, want_low))]
    if pv is not None:
        oks.append(torch.equal(pv, generate_preview(want_high)))
    ok = all(bool(o) for o in oks)
    return to_int16(out).cpu().numpy().view(np.uint16), ok


# ---------------------------------------------------------------------------
# whole files


def _exchange(mesh: Mesh, local: dict) -> dict:
    """Every process's ``{data row: value}`` merged (host objects, one
    all_gather over the processes of a mesh that spans them)."""
    if not mesh.spans_processes:
        return local
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, local)
    merged = {}
    for o in objs:
        merged.update(o)
    return merged


def sharded_encode_file(
    frames: np.ndarray,
    mesh: Mesh,
    *,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    delta_frame: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
) -> bytes:
    """Encode [N, H, W] u16 (or u8) frames into ONE FPVT file with the batch
    sections data-parallel over ``mesh``, byte-identical to
    ``encode_file_fpvt`` with the same arguments.

    Every group of mesh-size full batches runs one batch per data shard,
    each through the writer's own batch path
    (``FpvtWriter._encode_batch_streams``: the fused route, CODING_RAW and
    const planes) on the shard's device with the delta planes copied
    there.  Packaging is two deep: group g's sections serialize on a
    thread pool while group g+1 computes.  Tail batches (fewer than a full
    mesh group) go through the writer on this process's first shard
    device, and so does every batch of a file small enough for
    ``file_encode_setup``'s narrow policy.  On a mesh spanning processes, each process computes its own
    shards and the serialized sections are exchanged (not the raw device
    outputs the JAX package gathers), so every process returns the same
    file.  The mesh's space axis must have size 1."""
    shards = _data_shards(mesh)
    owned = [d for d, sh in enumerate(shards) if sh is not None]
    nd, bpb = len(shards), frames_per_batch
    wri, header, body, ts_body = file_encode_setup(
        frames, shift, big_endian, bpb, chunk_log2, delta_frame, timestamps,
        device=shards[owned[0]].device,
    )
    parts = [header]
    n_full = (body.shape[0] // bpb) * bpb  # frames in full-size batches
    n_grouped = 0 if wri._narrow else n_full // (nd * bpb) * (nd * bpb)
    deltas = {}
    for d in owned:
        with shards[d].on():
            deltas[d] = (wri._delta_high.to(shards[d].device),
                         wri._delta_low.to(shards[d].device))

    def ts_of(s: int, n: int):
        return None if ts_body is None else ts_body[s : s + n]

    def compute(job):
        d, s = job
        sh = shards[d]
        with annotate("mesh.compute"), sh.on():
            imgs = put_frames(body[s : s + bpb], sh.device)
            return d, s, wri._encode_batch_streams(
                imgs, wri.header.shift, wri.header.big_endian, deltas[d])

    def package(out):
        d, s, (flags, streams) = out
        with annotate("mesh.package"):
            return d, wri._serialize(flags, streams, ts_of(s, bpb))

    def emit(futs, pack):
        sections = _exchange(mesh, dict(pack.map(package,
                                                 [f.result() for f in futs])))
        for d in range(nd):
            parts.append(wri.add_batch(sections[d], bpb))

    with ThreadPoolExecutor(max(len(owned), 1)) as work, \
            ThreadPoolExecutor(max(len(owned), 1)) as pack:
        pend = None
        for s in range(0, n_grouped, nd * bpb):
            futs = [work.submit(compute, (d, s + d * bpb)) for d in owned]
            if pend is not None:
                emit(pend, pack)
            pend = futs
        if pend is not None:
            emit(pend, pack)
    for s in range(n_grouped, body.shape[0], bpb):
        nb = min(bpb, body.shape[0] - s)
        parts.append(wri.add_batch(
            wri.encode_batch_bytes(body[s : s + nb], ts_of(s, nb)), nb))
    parts.append(wri.finish())
    return b"".join(parts)


_HINTS = ("any_up", "any_cg", "pv_any_up", "pv_any_cg", "any_pv_delta",
          "any_prev")


def stack_decode_args(pbs: list, chunk_len: int) -> tuple[dict, dict]:
    """``batch_decode_args`` of parsed sections of one decode signature
    (frames per batch, CONST and RAW planes, low coding), stacked as
    :func:`sharded_fused_decode` takes them -> (arrays [D, ...], static):
    payloads zero-padded to one length, ``rows_alloc`` the sections'
    maximum, the ``any_*`` hints their union (the JAX package's sharded
    decode stacks them so)."""
    rows = max(section_rows_need(pb, chunk_len) for pb in pbs)
    built = [batch_decode_args(pb, chunk_len, rows_alloc=rows) for pb in pbs]
    plen = max(a["payload"].size for a, _s in built)
    stack = {key: np.stack([np.pad(a[key], (0, plen - a[key].size))
                            if key == "payload" else a[key]
                            for a, _s in built]) for key in built[0][0]}
    static = dict(built[0][1])
    for _a, s in built[1:]:
        if any(s[key] != static[key] for key in ("low_ctx", "const_planes",
                                                 "raw_planes")):
            raise ValueError("stacked sections differ in decode signature")
        for key in _HINTS:
            static[key] |= s[key]
    return stack, static


def sharded_fused_decode(
    mesh: Mesh,
    *,
    chunk_len: int,
    b: int,
    h: int,
    w: int,
    decode_preview: bool = False,
    **static,
):
    """One batch section per data shard -> ``decode(payload, plane_offs,
    counts, states, flags, sym_tabs, fcs, delta_high, delta_low,
    const_vals)``.

    The callable takes ``batch_decode_args``' arrays stacked over the
    sections (payload [D, L] zero-padded to one length, plane_offs [D, 3],
    counts [D, C], states [D, S], flags [D, B], sym_tabs [D, 3, 32, 128],
    fcs [D, 3, 4, 128], const_vals [D, 3]; numpy or tensors) and the
    shared delta planes.  Section d decodes on shard d's device, on that
    shard's stream, through ``fused_decode_batch(pack_u8=True)``: one K2
    launch a shard.  Returns, on the mesh's first device, imgs [D, B*H, 2W]
    u8 (each section's little-endian byte stream), ok [D] bool and, with
    ``decode_preview``, previews [D, B, H//4, W//4] u8.  ``static``
    carries ``batch_decode_args``' static kwargs: the ``any_*`` hints the
    union over the sections, rows_alloc their maximum.  The mesh's space
    axis must have size 1 and the mesh must lie in this process."""
    if mesh.spans_processes:
        raise ValueError("sharded_fused_decode runs in one process")
    shards = _data_shards(mesh)
    home = shards[0].device

    def decode(payload, plane_offs, counts, states, flags, sym_tabs, fcs,
               delta_high, delta_low, const_vals):
        def one(d):
            sh = shards[d]
            with sh.on():
                outs = fused_decode_batch(
                    payload[d], plane_offs[d], counts[d], states[d],
                    flags[d], sym_tabs[d], fcs[d], delta_high, delta_low,
                    const_vals[d], chunk_len=chunk_len, b=b, h=h, w=w,
                    decode_preview=decode_preview, pack_u8=True,
                    device=sh.device, **static)
                done = None
                if sh.stream is not None:
                    done = torch.cuda.Event()
                    done.record(sh.stream)
            return outs, done

        results = _map(one, list(range(len(shards))))
        cur = (torch.cuda.current_stream(home) if home.type == "cuda"
               else None)
        for outs, done in results:
            if done is not None:
                cur.wait_event(done)  # the shard's decode has been queued
                for t in outs:
                    t.record_stream(cur)
        return tuple(torch.stack([outs[i].to(home) for outs, _d in results])
                     for i in range(len(results[0][0])))

    return decode


def sharded_decode_file(data: bytes, mesh: Mesh, want_previews: bool = False):
    """Decode an FPVT file's batch sections data-parallel over ``mesh``.

    Sections group by decode signature (frames per batch, the const-plane
    and raw-plane sets, a ctx16 low plane), as the JAX package's sharded
    programs do; each full group decodes one section per data shard, on
    that shard's device (a reader per shard sharing the file's parsed
    index and delta planes: staging, K2 and K3 on the shard's issue
    stream), and group g-1's downloads overlap group g's decode.  Narrow
    sections and partial groups go to the single-device reader on the
    mesh's first device.  Returns all frames [N, H, W] u16 (left-aligned)
    in file order, or ``(frames, previews [N, H//4, W//4] u8)`` with
    ``want_previews``.  A failed rANS integrity check raises ValueError.
    The mesh's space axis must have size 1."""
    if mesh.spans_processes:
        raise ValueError("decode a file across processes with "
                         "parallel.distributed.distributed_decode_file")
    shards = _data_shards(mesh)
    rdr = FpvtReader(data, device=shards[0].device)
    readers = [rdr] + [rdr._replica(sh.device) for sh in shards[1:]]
    nd = len(shards)
    h, w = rdr.header.ysize, rdr.header.xsize
    k = 1 << rdr.header.chunk_log2
    groups: dict[tuple, list] = {}
    leftovers = []
    for bi, (off, n) in enumerate(rdr._batches):
        pb = rdr._parse_batch(off)
        if not _fused_decodable(pb, k):
            leftovers.append((bi, pb, n))
            continue
        streams = (pb.high, pb.low, pb.preview)
        key = (n, tuple(st.coding == CODING_CONST for st in streams),
               tuple(st.coding == CODING_RAW for st in streams),
               pb.low.coding == CODING_CTX16)
        groups.setdefault(key, []).append((bi, pb))
    units = []
    for (n, *_sig), items in groups.items():
        while len(items) >= nd:
            units.append((n, items[:nd]))
            items = items[nd:]
        leftovers.extend((bi, pb, n) for bi, pb in items)

    results, results_pv = {}, {}

    def finalize(pend):
        fins, items = pend
        with annotate("mesh.download"):
            for fin, (bi, _pb) in zip(fins, items):
                results[bi], results_pv[bi] = fin()

    pend = None
    for n, items in units:
        with annotate("mesh.compute"):
            fins = [r._issue(pb, want_previews)
                    for r, (_bi, pb) in zip(readers, items)]
        if pend is not None:
            finalize(pend)
        pend = (fins, items)
    if pend is not None:
        finalize(pend)
    for bi, pb, _n in leftovers:
        results[bi], results_pv[bi] = rdr._issue(pb, want_previews)()
    order = range(len(rdr._batches))
    out = [results[bi] for bi in order]
    pv_out = [results_pv[bi] for bi in order] if want_previews else []
    if rdr.header.delta_is_frame0:
        out.insert(0, rdr.frame0()[None])
        if want_previews:
            pv_out.insert(0, rdr.preview_frame(0)[None])
    frames = np.concatenate(out) if out else np.zeros((0, h, w), np.uint16)
    if not want_previews:
        return frames
    pv = (np.concatenate(pv_out) if pv_out
          else np.zeros((0, h // 4, w // 4), np.uint8))
    return frames, pv


# ---------------------------------------------------------------------------
# the dry run


def multichip_dryrun(n_devices: int, h: int = 32, w: int = 32,
                     mesh: Mesh | None = None) -> None:
    """Run the full codec (model step, device tables, K1, K2, the inverse
    predictors) sharded over an ``n_devices`` data mesh (``mesh``, or
    :func:`make_mesh` over the visible cards) and verify the round trip,
    then the production configuration's sharded encode (bit-exact per
    shard) and sharded decode (pixel-exact).  Raises AssertionError on a
    mismatch."""
    if mesh is None:
        mesh = make_mesh(n_devices)
    if mesh.shape["data"] != n_devices:
        raise ValueError(f"the mesh has {mesh.shape['data']} data shards, "
                         f"not {n_devices}")
    step = sharded_codec_roundtrip(mesh, chunk_len=32)
    frames = _test_frames(2 * n_devices, h, w)  # 2 frames per shard
    dh = (frames[0] >> 8).astype(np.uint8)
    dl = (frames[0] & 0xFF).astype(np.uint8)
    out, ok = step(frames, dh, dl)
    if not ok:
        raise AssertionError("sharded full-codec roundtrip failed")
    if not np.array_equal(out, frames):
        raise AssertionError("sharded full-codec output mismatch")
    _dryrun_production_config(mesh, n_devices)
    _dryrun_production_decode(mesh, n_devices)


def _dryrun_production_config(mesh: Mesh, n_devices: int) -> None:
    """:func:`sharded_fused_encode` in the shipping configuration (ctx16 low
    plane, chunk_len 4096: eight segments per chunk), each shard's section
    bit-exact against ``fused_encode_batch`` on its slice on the mesh's
    first device (a fault in any shard but the first must not pass)."""
    k, shift, h, w = 4096, 4, 96, 128
    b = 2 * n_devices
    frames = (_test_frames(b, h, w) >> 4).astype(np.uint16)  # 12-bit
    left = (frames[0].astype(np.uint32) << shift) & 0xFFFF
    dh, dl = (left >> 8).astype(np.uint8), (left & 0xFF).astype(np.uint8)
    outs = sharded_fused_encode(mesh, shift=shift, chunk_len=k,
                                low_coding=CODING_CTX16,
                                allow_prev=True)(frames, dh, dl)
    home = mesh.devices[0][0]
    ts = np.full(2, -1, np.int64)
    for d, got in enumerate(outs):
        want = fused_encode_batch(
            put_frames(frames[2 * d : 2 * d + 2], home), upload(dh, home),
            upload(dl, home), shift, False, k, CODING_CTX16, True)
        if (fpvt.serialize_batch_section(got[0], ts, *got[1])
                != fpvt.serialize_batch_section(want[0], ts, *want[1])):
            raise AssertionError("sharded production-config encode not "
                                 f"bit-exact (shard {d})")


def _dryrun_production_decode(mesh: Mesh, n_devices: int) -> None:
    """An FPVT file of 1024-lane ctx16 sections at chunk_len 4096, one per
    shard, through :func:`sharded_decode_file`, pixel-exact."""
    h, w, shift, bpb = 96, 128, 4, 2
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 1 << 12, size=(n_devices * bpb, h, w),
                          dtype=np.uint16)
    wtr = FpvtWriter(w, h, shift=shift, frames_per_batch=bpb,
                     device=mesh.devices[0][0], narrow=False)
    parts = [wtr.init(frames[0])]
    parts += [wtr.encode_batch(frames[i * bpb : (i + 1) * bpb])
              for i in range(n_devices)]
    parts.append(wtr.finish())
    out = sharded_decode_file(b"".join(parts), mesh)
    want = (frames.astype(np.uint32) << shift).astype(np.uint16)
    if not np.array_equal(out, want):
        raise AssertionError("sharded production-config decode mismatch")


def _test_frames(b: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, 1 << 16, size=(b, h, w), dtype=np.uint16)

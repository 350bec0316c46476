"""Multi-process stream and batch sharding.

The reference is single-process; its only scaling axis is the in-process
worker pool (fusion_power_video.cc:1199-1230).  Across processes (and
hosts) the codec scales by pure data parallelism: a mesh spans every
device of every process (:func:`global_data_mesh`), each process computes
the shards it owns, and only host bytes cross processes, through
``torch.distributed`` with the gloo backend over TCP: compressed sections
on encode, decoded pixels on decode.  Gloo carries host tensors, so any
number of processes may share a card (NCCL allows one rank per card).

Multi-controller model, as the JAX package's: every process runs the same
call on the same file-level inputs and returns the same result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from fpv_tpu_torch.api.fpvt_codec import FpvtReader
from fpv_tpu_torch.parallel.mesh import Mesh, sharded_encode_file

# devices this process contributes to global_data_mesh (set by initialize)
_LOCAL_DEVICE_COUNT: int | None = None


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
) -> None:
    """Join this process to a group of ``num_processes`` as rank
    ``process_id``: ``torch.distributed.init_process_group`` with gloo
    over TCP at ``coordinator_address`` ("host:port", rank 0 listens).
    ``local_device_count``: how many of this process's cards join
    :func:`global_data_mesh` (default: every visible one)."""
    global _LOCAL_DEVICE_COUNT
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    _LOCAL_DEVICE_COUNT = local_device_count


def global_data_mesh(space: int = 1, devices=None) -> Mesh:
    """A (data, space) mesh over the devices of every process: this
    process's ``devices`` (default: its first ``local_device_count`` cards,
    see :func:`initialize`) joined in rank order.  Each data row lies in
    one process, which owns it."""
    if devices is None:
        count = (torch.cuda.device_count() if _LOCAL_DEVICE_COUNT is None
                 else _LOCAL_DEVICE_COUNT)
        if count == 0 or not torch.cuda.is_available():
            raise RuntimeError("PyTorch sees no CUDA device; pass devices= "
                               "for the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    local = [str(torch.device(d)) for d in devices]
    if not local or len(local) % space:
        raise ValueError(f"{len(local)} local devices do not form rows of "
                         f"{space}")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    grid, ranks = [], []
    for rank, devs in enumerate(every):
        for s in range(0, len(devs), space):
            grid.append(devs[s : s + space])
            ranks.append(rank)
    return Mesh(grid, ranks)


def distributed_encode_file(
    frames: np.ndarray,
    *,
    mesh: Mesh | None = None,
    shift: int = 0,
    big_endian: bool = False,
    frames_per_batch: int = 16,
    chunk_log2: int = 12,
    delta_frame: np.ndarray | None = None,
    timestamps: np.ndarray | None = None,
) -> bytes:
    """Encode one FPVT file with batch groups spread over the shards of
    every process (``mesh``, default :func:`global_data_mesh`).

    The bytes equal :func:`fpv_tpu_torch.parallel.mesh.sharded_encode_file`
    on a same-size single-process mesh, and so ``encode_file_fpvt``'s.
    Each process encodes the batches of the shards it owns; the processes
    then exchange the serialized batch sections (not raw device outputs),
    so every process assembles the identical complete file.  Tail batches
    are encoded by every process."""
    if mesh is None:
        mesh = global_data_mesh()
    return sharded_encode_file(
        frames, mesh, shift=shift, big_endian=big_endian,
        frames_per_batch=frames_per_batch, chunk_log2=chunk_log2,
        delta_frame=delta_frame, timestamps=timestamps,
    )


def distributed_decode_file(data: bytes, device="cuda") -> np.ndarray:
    """Decode one FPVT file with its batches spread round-robin over the
    processes; every process returns the full [N, H, W] uint16 result.

    Batches are independent given the delta section, so each process
    decodes its batches on ``device`` and one all_gather of host pixels
    gives every process the rest."""
    r = FpvtReader(data, device=device)
    nb = r.num_batches
    h, w = r.header.ysize, r.header.xsize
    counts = [n for _off, n in r._batches]
    outs: list[np.ndarray] = []
    if not dist.is_initialized() or dist.get_world_size() == 1:
        outs = [r.decode_batch(i) for i in range(nb)]
    elif nb:
        pid, nproc = dist.get_rank(), dist.get_world_size()
        n_max = -(-nb // nproc)
        bpb = max(counts)
        buf = np.zeros((n_max, bpb, h, w), np.uint16)
        for j, i in enumerate(range(pid, nb, nproc)):
            out = r.decode_batch(i)
            buf[j, : out.shape[0]] = out
        # [nproc][n_max, bpb, h, 2w] bytes (gloo carries no 16-bit
        # integers): one gather for all pixels
        mine = torch.from_numpy(buf.view(np.uint8))
        every = [torch.empty_like(mine) for _ in range(nproc)]
        dist.all_gather(every, mine)
        outs = [every[i % nproc][i // nproc, : counts[i]].numpy()
                .view(np.uint16) for i in range(nb)]
    if r.header.delta_is_frame0:
        outs.insert(0, r.frame0()[None])
    if not outs:
        return np.zeros((0, h, w), np.uint16)
    return np.concatenate(outs)

"""Multi-process sharding in the port: two real processes in one gloo group.

The counterpart of tests/test_distributed.py: 2 ranks x 2 CPU shards (a
4-shard mesh spanning both processes), the worker's frames of
tests/distributed_worker.py.  Each rank encodes the file over the mesh and
decodes it round-robin; both ranks' files must equal each other and the
JAX package's ``encode_file_fpvt`` bytes computed here, and the decodes
must be pixel-exact.  The workers also run the sharded codec round trip,
whose histograms all_reduce across the processes.

This file is its own worker: ``python tests/test_torch_distributed.py
worker <rank> <world> <port>`` (the worker imports no JAX).
"""

import hashlib
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W, BPB, LOCAL = 16, 16, 2, 2
KWARGS = dict(shift=4, frames_per_batch=BPB, chunk_log2=4)


def _frames(nproc: int) -> np.ndarray:
    """delta frame + 2 process-spanning mesh groups + a tail batch."""
    from fpv_tpu_torch.utils import testdata

    ndev = LOCAL * nproc
    return testdata.plasma_frames(1 + 2 * ndev * BPB + BPB, H, W, bits=12)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank: int, nproc: int, port: str) -> int:
    import torch
    import torch.distributed as dist

    from fpv_tpu_torch.api.fpvt_codec import encode_file_fpvt
    from fpv_tpu_torch.entropy import plane_codec
    from fpv_tpu_torch.parallel import distributed as tdist
    from fpv_tpu_torch.parallel.mesh import sharded_codec_roundtrip

    plane_codec.NARROW_MAX_SYMS = 0  # the fused 1024-lane geometry
    tdist.initialize(f"127.0.0.1:{port}", nproc, rank)
    assert dist.get_world_size() == nproc and dist.get_rank() == rank
    mesh = tdist.global_data_mesh(devices=[torch.device("cpu")] * LOCAL)
    assert mesh.shape == {"data": LOCAL * nproc, "space": 1}
    assert [mesh.owns(d) for d in range(LOCAL * nproc)] == [
        d // LOCAL == rank for d in range(LOCAL * nproc)]

    frames = _frames(nproc)
    got = tdist.distributed_encode_file(frames, mesh=mesh, **KWARGS)
    want = encode_file_fpvt(frames, device="cpu", **KWARGS)
    assert got == want, f"rank {rank}: the file differs from the writer's"
    out = tdist.distributed_decode_file(got, device="cpu")
    np.testing.assert_array_equal(out, frames << 4)

    body = frames[1 : 1 + 2 * LOCAL * nproc]
    left = body[0].astype(np.uint32) << 4
    rec, ok = sharded_codec_roundtrip(mesh, chunk_len=16, shift=4)(
        body, (left >> 8).astype(np.uint8), (left & 0xFF).astype(np.uint8))
    assert ok, f"rank {rank}: the sharded round trip failed"
    mine = slice(2 * LOCAL * rank, 2 * LOCAL * (rank + 1))
    np.testing.assert_array_equal(rec, body[mine] << 4)
    dist.destroy_process_group()
    print(f"WORKER-OK sha256={hashlib.sha256(got).hexdigest()}", flush=True)
    return 0


def test_two_process_gloo_sharding(monkeypatch):
    from fpv_tpu.api.fpvt_codec import encode_file_fpvt

    monkeypatch.setenv("FPV_TPU_RANS_ENGINE", "pallas")
    monkeypatch.setenv("FPV_TPU_NARROW_MAX", "0")
    want = hashlib.sha256(encode_file_fpvt(_frames(2), **KWARGS)).hexdigest()
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "worker", str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
            env=env, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    digests = [line.split("sha256=")[1] for out in outs
               for line in out.splitlines() if line.startswith("WORKER-OK")]
    assert digests == [want, want], outs


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))

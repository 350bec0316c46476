"""The port's command-line tools against the JAX package's, on the CPU.

Mirrors tests/test_cli.py.  Each tool's ``main(argv)`` runs in-process
with stdin, stdout and stderr replaced, beside the JAX tool's on the same
input: exit codes, stdout bytes and stderr reports must be equal (the
benchmark's timings aside).  The port's tools take ``--device cpu`` here;
without a card and without it they exit non-zero.  A few subprocesses
hold the pipe contract (each imports torch).  Also here:
``plane_stream_accounting`` against the JAX format's.
"""

import io
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fpv_tpu.api.encoder import encode_file
from fpv_tpu.api.fpvt_codec import encode_file_fpvt
from fpv_tpu.cli import benchmark as jbench
from fpv_tpu.cli import decode as jdecode
from fpv_tpu.cli import encode as jencode
from fpv_tpu.cli import inspect as jinspect
from fpv_tpu.cli import transcode as jtranscode
from fpv_tpu.format import fpvt as jfpvt
from fpv_tpu.utils import testdata
from fpv_tpu_torch.cli import benchmark as tbench
from fpv_tpu_torch.cli import decode as tdecode
from fpv_tpu_torch.cli import encode as tencode
from fpv_tpu_torch.cli import inspect as tinspect
from fpv_tpu_torch.cli import transcode as ttranscode
from fpv_tpu_torch.format import container
from fpv_tpu_torch.format import fpvt as tfpvt

from conftest import REPO, ref_encode, requires_reference

DEV = ["--device", "cpu"]


def run_port_cli(tool: str, args: list, stdin: bytes) -> bytes:
    """``python -m fpv_tpu_torch.cli.<tool> args --device cpu`` -> stdout
    (exit code 0 required)."""
    proc = subprocess.run(
        [sys.executable, "-m", f"fpv_tpu_torch.cli.{tool}", *args, *DEV],
        input=stdin, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        check=True, cwd=REPO,
    )
    return proc.stdout


def call(monkeypatch, main, argv, stdin: bytes = b""):
    """``main(argv)`` with stdin/stdout/stderr replaced -> (exit code,
    stdout bytes, stderr text); a SystemExit counts as its code."""
    out = io.BytesIO()
    err = io.StringIO()
    fake_out = io.TextIOWrapper(out, write_through=True)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
    monkeypatch.setattr(sys, "stdout", fake_out)
    monkeypatch.setattr(sys, "stderr", err)
    try:
        rc = main(list(argv))
    except SystemExit as e:
        rc = e.code
    fake_out.flush()
    monkeypatch.undo()
    return rc, out.getvalue(), err.getvalue()


def both(monkeypatch, jmain, tmain, argv, stdin=b"", device=DEV):
    """The JAX tool and the port's on the same argv and stdin: equal exit
    codes, stdout and stderr -> (code, stdout)."""
    want = call(monkeypatch, jmain, argv, stdin)
    got = call(monkeypatch, tmain, [*argv, *device], stdin)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert _untimed(got[2]) == _untimed(want[2])
    return got[0], got[1]


def _untimed(text: str) -> str:
    """stderr without the benchmark's wall-clock figures, the port's usage
    mention of --device, and the plane the port's reader names in a failed
    rANS integrity check ("... check failed (high plane)"; JAX's reader
    names none)."""
    text = re.sub(r", time: [^\n]*", "", text)
    text = re.sub(r" \([a-z ]+ plane\)", "", text)
    return text.replace(" [--device cuda|cpu]", "")


# one shape, so the JAX tools compile their device steps once
RAW_CASES = [
    pytest.param((4, 16, 24), 12, "0", "4", id="le-shift4"),
    pytest.param((4, 16, 24), 12, "1", "4", id="be-shift4"),
    pytest.param((4, 16, 24), 16, "0", "0", id="le-shift0"),
]


def _raw(shape, bits, be, shift):
    frames = testdata.plasma_frames(*shape, bits=bits, seed=5)
    return testdata.to_raw_bytes(frames, shift=int(shift),
                                 big_endian=be == "1")


@pytest.mark.parametrize("profile", ["fpv1", "fpvt"])
@pytest.mark.parametrize("shape,bits,be,shift", RAW_CASES)
def test_encode_decode_equal_jax(monkeypatch, profile, shape, bits, be,
                                 shift):
    raw = _raw(shape, bits, be, shift)
    n, h, w = shape
    args = [str(w), str(h), be, shift, "2", "--profile", profile]
    rc, data = both(monkeypatch, jencode.main, tencode.main, args, raw)
    assert rc == 0 and (data[:4] == b"FPVT") == (profile == "fpvt")
    rc, out = both(monkeypatch, jdecode.main, tdecode.main,
                   [str(w), str(h), be, shift], data)
    assert rc == 0 and out == raw


@pytest.mark.parametrize("to", ["fpvt", "fpv1"])
def test_transcode_tool_equal_jax(monkeypatch, to):
    frames = testdata.plasma_frames(5, 24, 32, bits=12, seed=3)
    src = (encode_file(frames, shift=4) if to == "fpvt"
           else encode_file_fpvt(frames, shift=4, frames_per_batch=2))
    rc, out = both(monkeypatch, jtranscode.main, ttranscode.main,
                   [to, "4"] if to == "fpvt" else [to], src)
    assert rc == 0 and (out[:4] == b"FPVT") == (to == "fpvt")
    # a wrong shift claim is refused with the same report
    rc, out = both(monkeypatch, jtranscode.main, ttranscode.main,
                   ["fpvt", "8"], encode_file(frames, shift=4))
    assert rc == 1 and out == b""


@pytest.mark.parametrize("profile", ["fpv1", "fpvt"])
def test_benchmark_tool_equal_jax(monkeypatch, tmp_path, profile):
    path = tmp_path / "capture.raw"
    path.write_bytes(_raw((5, 24, 32), 12, "0", "4"))
    args = [str(path), "32", "24", "0", "4", "0", "2", "--profile", profile]
    want = call(monkeypatch, jbench.main, args)
    got = call(monkeypatch, tbench.main, [*args, *DEV])
    assert got[:2] == want[:2] == (0, b"")
    assert _untimed(got[2]) == _untimed(want[2])
    assert got[2].endswith("ok\n")


def _fpvt_file():
    frames = testdata.plasma_frames(7, 40, 56, bits=12, seed=7)
    return encode_file_fpvt(frames, shift=4, frames_per_batch=3,
                            chunk_log2=8)


def _fpv1_file(n=5):
    return encode_file(testdata.plasma_frames(n, 40, 56, bits=12, seed=7),
                       shift=4)


def test_inspect_dicts_and_reports_equal_jax():
    fpvt, fpv1 = _fpvt_file(), _fpv1_file(40)
    info = tinspect.inspect_bytes(fpvt)
    assert info == jinspect.inspect_bytes(fpvt)
    assert tinspect.format_report(info) == jinspect.format_report(info)
    info = tinspect.inspect_fpv1_bytes(fpv1)
    assert info == jinspect.inspect_fpv1_bytes(fpv1)
    # more than 32 frames: the per-frame lines are left out
    assert tinspect.format_report_fpv1(info) == jinspect.format_report_fpv1(
        info)
    short = _fpv1_file()
    assert tinspect.format_report_fpv1(tinspect.inspect_fpv1_bytes(
        short)) == jinspect.format_report_fpv1(jinspect.inspect_fpv1_bytes(
            short))


def _flip(data: bytes, pos: int, mask: int = 0x5A) -> bytes:
    b = bytearray(data)
    b[pos] ^= mask
    return bytes(b)


def _inspect_cases():
    fpvt, fpv1 = _fpvt_file(), _fpv1_file()
    off, _n = tfpvt.parse_footer(fpvt)[1]
    chunks = [container.parse_frame_chunk(fpv1, o)
              for o in container.parse_footer(fpv1)]
    return {
        "fpvt": fpvt,
        "fpv1": fpv1,
        # the second batch's payload and a truncated file
        "fpvt-payload": _flip(fpvt, off + 700),
        "fpvt-truncated": fpvt[: len(fpvt) - 40],
        # frame 1's first brotli stream and frame 3's preview stream: the
        # batched check walks the batch frame by frame
        "fpv1-streams": _flip(_flip(fpv1, chunks[1].main_start + 4),
                              chunks[3].preview_start + 4),
        "fpv1-truncated": fpv1[:-3],
    }


@pytest.mark.parametrize("name", list(_inspect_cases()))
def test_inspect_main_and_check_equal_jax(monkeypatch, tmp_path, name):
    data = _inspect_cases()[name]
    path = tmp_path / "f"
    path.write_bytes(data)
    for argv in ([str(path)], ["--check", str(path)]):
        rc, out = both(monkeypatch, jinspect.main, tinspect.main, argv)
        if name in ("fpvt", "fpv1"):
            assert rc == 0
            if argv[0] == "--check":
                assert out.endswith(b"check: ok (all batches decode)\n")
    if name not in ("fpvt", "fpv1"):
        assert rc == 1  # the check found the damage


def test_usage_and_invalid_arguments_equal_jax(monkeypatch):
    for jmain, tmain, argv in (
        (jencode.main, tencode.main, []),
        (jencode.main, tencode.main, ["0", "5", "0", "0"]),
        (jencode.main, tencode.main, ["8", "8", "0", "17"]),
        (jencode.main, tencode.main, ["8", "8", "0", "0", "--profile"]),
        (jdecode.main, tdecode.main, ["8", "8", "0"]),
        (jdecode.main, tdecode.main, ["8", "70000", "0", "0"]),
        (jtranscode.main, ttranscode.main, ["gif"]),
        (jbench.main, tbench.main, ["f", "8", "8", "0"]),
        (jinspect.main, tinspect.main, []),
    ):
        rc, out = both(monkeypatch, jmain, tmain, argv)
        assert rc in (1, 2) and out == b""


def test_tools_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path = tmp_path / "f.fpvt"
    path.write_bytes(_fpvt_file())
    for main, argv in ((tencode.main, ["8", "8", "0", "0"]),
                       (tdecode.main, ["8", "8", "0", "0"]),
                       (ttranscode.main, ["fpvt"]),
                       (tbench.main, [str(path), "8", "8", "0", "0"]),
                       (tinspect.main, ["--check", str(path)])):
        rc, out, err = call(monkeypatch, main, argv)
        assert rc == 1 and out == b"" and "CUDA" in err
    rc, _out, err = call(monkeypatch, tencode.main,
                         ["8", "8", "0", "0", "--device", "tpu"])
    assert rc == 1 and "invalid device" in err


def test_cli_fpvt_pipe_roundtrip():
    frames = testdata.plasma_frames(4, 32, 32)
    raw = testdata.to_raw_bytes(frames)
    compressed = run_port_cli(
        "encode", ["32", "32", "0", "0", "--profile", "fpvt"], raw
    )
    assert compressed[:4] == b"FPVT"
    out = run_port_cli("decode", ["32", "32", "0", "0"], compressed)
    assert out == raw


def test_cli_usage_errors():
    p = subprocess.run(
        [sys.executable, "-m", "fpv_tpu_torch.cli.encode"],
        input=b"", capture_output=True, cwd=REPO,
    )
    assert p.returncode == 1 and b"Usage" in p.stderr
    p = subprocess.run(
        [sys.executable, "-m", "fpv_tpu_torch.cli.encode", "0", "5", "0", "0",
         *DEV],
        input=b"", capture_output=True, cwd=REPO,
    )
    assert p.returncode == 1 and b"invalid" in p.stderr


@requires_reference
def test_cli_encode_matches_reference():
    frames = testdata.plasma_frames(3, 32, 40, bits=12)
    raw = testdata.to_raw_bytes(frames)
    ours = run_port_cli("encode", ["40", "32", "0", "4", "2"], raw)
    assert ours == ref_encode(raw, 40, 32, 0, 4)


@requires_reference
def test_cli_decode_reference_stream():
    frames = testdata.plasma_frames(3, 32, 40, bits=12)
    raw = testdata.to_raw_bytes(frames)
    compressed = ref_encode(raw, 40, 32, 0, 4)
    assert run_port_cli("decode", ["40", "32", "0", "4"], compressed) == raw


def test_plane_stream_accounting_equal_jax():
    """Every plane stream kind (coded narrow and wide, const, raw): the
    port's accounting equals the JAX format's."""
    files = [
        _fpvt_file(),
        encode_file_fpvt(np.repeat(testdata.plasma_frames(1, 24, 32), 4, 0),
                         shift=4, frames_per_batch=2),
        encode_file_fpvt(testdata.noise_frames(4, 24, 32), frames_per_batch=2),
    ]
    seen = set()
    for data in files:
        for off, _n in tfpvt.parse_footer(data):
            ours = tfpvt.parse_batch_section(data, off)
            theirs = jfpvt.parse_batch_section(data, off)
            for a, b in zip((ours.high, ours.low, ours.preview),
                            (theirs.high, theirs.low, theirs.preview)):
                if a is None:
                    continue
                assert (tfpvt.plane_stream_accounting(a)
                        == jfpvt.plane_stream_accounting(b))
                seen.add(a.coding)
    assert seen == {0, 1, 2, 3}

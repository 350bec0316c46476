"""Device selection for the command-line tools.

The JAX package's tools re-assert ``JAX_PLATFORMS`` before they start
(``honor_jax_platforms_env``).  The port reads no environment knobs: each
tool takes ``--device cuda|cpu`` (default ``cuda``, any CUDA index such
as ``cuda:1`` too) and resolves it through
:func:`fpv_tpu_torch.api.fpvt_codec.resolve_device`.  Without a card and
without ``--device cpu`` a tool reports why on stderr and exits non-zero;
it never carries on on the CPU.
"""

from __future__ import annotations

import sys

import torch

from fpv_tpu_torch.api.fpvt_codec import resolve_device


def take_device(argv: list[str]) -> tuple[list[str], str]:
    """Remove ``--device NAME`` from ``argv`` -> (the other arguments,
    NAME or ``"cuda"``).  A trailing ``--device`` without a value empties
    the arguments, so the tool shows its usage."""
    argv = list(argv)
    if "--device" not in argv:
        return argv, "cuda"
    i = argv.index("--device")
    if i + 1 >= len(argv):
        return [], "cuda"
    name = argv[i + 1]
    del argv[i : i + 2]
    return argv, name


def open_device(name: str, tool: str) -> torch.device | None:
    """``name`` as a torch.device for ``tool`` -> the device, or None
    after a message on stderr when the name is not a CUDA or CPU device or
    names a card PyTorch cannot see."""
    try:
        dev = torch.device(name)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in ("cuda", "cpu"):
        sys.stderr.write(f"{tool}: invalid device {name!r} (cuda or cpu)\n")
        return None
    try:
        return resolve_device(dev)
    except RuntimeError as e:
        sys.stderr.write(f"{tool}: {e}\n")
        return None


def argv_device(argv: list[str] | None, tool: str
                ) -> tuple[list[str], torch.device]:
    """:func:`take_device` then :func:`open_device` for a script's main:
    (the other arguments, the device); exits with status 1 after the
    message when the device cannot be used (no card and no ``--device
    cpu``)."""
    argv, name = take_device(sys.argv[1:] if argv is None else argv)
    dev = open_device(name, tool)
    if dev is None:
        raise SystemExit(1)
    return argv, dev

"""Faults planted under the timed path, for the check's tests and its
control: with one planted, the check must read ``correct`` false.

* ``lossy`` (the control): each sample loses its lowest bit, one bit less
  precision than the camera's;
* ``flip``: one byte of each file, or one sample of each decoded answer,
  is altered where it is produced;
* ``half``: half of each answer is left out (half of the recording is
  encoded; half of the frames, or half of a frame, come back);
* ``stale``: each call hands back the answer of the call before, as a
  step that returns its state unchanged would.

An entry module passes what its timed call takes in and hands back
through one :class:`Faults`; set-up calls go around it.
"""

from __future__ import annotations

import numpy as np

FAULTS = ("lossy", "flip", "half", "stale")


class Faults:
    def __init__(self, fault: str | None, shift: int) -> None:
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.fault = fault
        self.shift = shift
        self._last = None

    def _stale(self, out):
        if self.fault != "stale":
            return out
        last, self._last = self._last, out
        return out if last is None else last

    def frames_in(self, frames: np.ndarray) -> np.ndarray:
        """Camera samples (right-aligned) on their way into an encode."""
        if self.fault == "lossy":
            return frames & np.uint16(0xFFFE)
        if self.fault == "half":
            return frames[: len(frames) // 2]
        return frames

    def encoded(self, out: bytes) -> bytes:
        """A file on its way out of an encode."""
        if self.fault == "flip":
            b = bytearray(out)
            b[len(b) // 2] ^= 0x10
            out = bytes(b)
        return self._stale(out)

    def decoded(self, out: np.ndarray) -> np.ndarray:
        """Decoded frames (left-aligned samples), a recording or one frame,
        on their way out of a decode."""
        lsb = np.uint16(1 << self.shift)
        if self.fault == "lossy":
            return out & ~lsb
        if self.fault == "flip":
            out = out.copy()
            out.reshape(-1)[out.size // 2] ^= lsb
        elif self.fault == "half":
            if out.ndim == 3:
                return out[: len(out) // 2]
            out = out.copy()
            out[len(out) // 2 :] = 0
        return self._stale(out)

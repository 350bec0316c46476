"""Little-endian serialization helpers (fusion_power_video.cc:254-294)."""

from __future__ import annotations

import struct


def read_u32le(data: bytes, pos: int = 0) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def read_u64le(data: bytes, pos: int = 0) -> int:
    return struct.unpack_from("<Q", data, pos)[0]


def u32le(value: int) -> bytes:
    return struct.pack("<I", value & 0xFFFFFFFF)


def u64le(value: int) -> bytes:
    return struct.pack("<Q", value & 0xFFFFFFFFFFFFFFFF)


def out_of_bounds(pos: int, width: int, size: int) -> bool:
    """pos + width > size with overflow safety (fusion_power_video.cc:292-294)."""
    return pos > size or size - pos < width

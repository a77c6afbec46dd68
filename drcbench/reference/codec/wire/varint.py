"""LEB128 varints and zigzag mapping.

Reference behavior: draco-oxide/src/utils/bit_coder.rs:4-33 (leb128) and
src/utils/mod.rs:152-168 (to_positive_i32 zigzag).
"""

from __future__ import annotations

import numpy as np

from .byte_io import ByteReader, ByteWriter


def leb128_write(value: int, writer: ByteWriter) -> None:
    value = int(value)
    if value < 0:
        raise ValueError("leb128 encodes unsigned values")
    while True:
        byte = value & 0x7F
        value >>= 7
        if value == 0:
            writer.write_u8(byte)
            return
        writer.write_u8(byte | 0x80)


def leb128_read(reader: ByteReader) -> int:
    result = 0
    shift = 0
    while True:
        byte = reader.read_u8()
        result |= (byte & 0x7F) << shift
        if (byte & 0x80) == 0:
            return result
        shift += 7


def leb128_size(value: int) -> int:
    """Number of bytes leb128_write would emit."""
    n = 1
    value = int(value) >> 7
    while value:
        n += 1
        value >>= 7
    return n


def zigzag(v):
    """Map signed to unsigned: v>=0 -> v<<1, v<0 -> ((-(v+1))<<1)+1.

    Accepts Python ints or numpy int arrays (computed in int64)."""
    if isinstance(v, np.ndarray):
        v = v.astype(np.int64)
        return np.where(v >= 0, v << 1, ((-(v + 1)) << 1) + 1).astype(np.uint64)
    v = int(v)
    return (v << 1) if v >= 0 else ((-(v + 1)) << 1) + 1


def unzigzag(u):
    """Inverse of zigzag."""
    if isinstance(u, np.ndarray):
        u = u.astype(np.uint64)
        half = (u >> np.uint64(1)).astype(np.int64)
        return np.where((u & np.uint64(1)) == 0, half, -half - 1)
    u = int(u)
    return (u >> 1) if (u & 1) == 0 else -((u >> 1) + 1)


def leb128_bytes(value: int) -> bytes:
    """leb128_write as bytes (no writer)."""
    w = ByteWriter()
    leb128_write(value, w)
    return bytes(w.getvalue())

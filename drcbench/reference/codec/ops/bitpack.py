"""Vectorized sub-byte bit packing (numpy), both bit orders.

Array-rate replacement for the scalar wire.bit_io.BitWriter loops on the
encoder hot path (CrLight CLERS codes, length-coded raw bits). Bit-exact
with the scalar writer: LSB-first packs value bit j at stream bit off+j,
MSB-first packs the value's MSB first (bit_coder.rs:90-188 semantics),
final partial byte zero-padded.
"""

from __future__ import annotations

import numpy as np


def _expand(sizes: np.ndarray, values: np.ndarray):
    sizes = np.asarray(sizes, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return None, None, 0
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    intra = (np.arange(total, dtype=np.int64)
             - np.repeat(starts, sizes))
    vals = np.repeat(values, sizes)
    return vals, intra, total


def pack_bits_lsb(sizes, values) -> bytes:
    """Pack each values[k]'s low sizes[k] bits, LSB-first within the stream."""
    vals, intra, total = _expand(sizes, values)
    if total == 0:
        return b""
    bits = ((vals >> intra) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def pack_bits_msb(sizes, values) -> bytes:
    """Pack each values[k]'s low sizes[k] bits, MSB of each value first."""
    vals, intra, total = _expand(sizes, values)
    if total == 0:
        return b""
    widths = np.repeat(np.asarray(sizes, dtype=np.int64),
                       np.asarray(sizes, dtype=np.int64))
    bits = ((vals >> (widths - 1 - intra)) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="big").tobytes()


def unpack_bits_msb(data: bytes, sizes) -> np.ndarray:
    """Inverse of pack_bits_msb: read len(sizes) values of sizes[k] bits
    each (MSB of each value first) from a zero-padded byte buffer.
    Zero-size entries decode to 0. Returns uint64 values."""
    sizes = np.asarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(len(sizes), dtype=np.uint64)
    if total > 8 * len(data):
        raise ValueError("bit buffer underrun")
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                         count=total).astype(np.uint64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    intra = np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)
    widths = np.repeat(sizes, sizes)
    contrib = bits << (widths - 1 - intra).astype(np.uint64)
    out = np.zeros(len(sizes), dtype=np.uint64)
    np.add.at(out, np.repeat(np.arange(len(sizes)), sizes), contrib)
    return out

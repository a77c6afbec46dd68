"""Symbol-sequence coding: length-coded (rANS tags + raw bits) and
direct-coded (pure rANS) dispatch.

Reference behavior: draco-oxide/src/encode/entropy/symbol_coding.rs and
src/decode/entropy/symbol_coding.rs.
"""

from __future__ import annotations

import numpy as np

from ..wire.bit_io import BitReader, BitWriter  # noqa: F401 (re-exported for callers)
from ..wire.byte_io import ByteReader, ByteWriter
from .rans import RansSymbolDecoder, RansSymbolEncoder, rans_precision_for_bit_length

LENGTH_CODED = 0
DIRECT_CODED = 1


def bit_length_u64(s: np.ndarray) -> np.ndarray:
    """Per-element bit length (64 - clz); 0 for value 0. Vectorized."""
    s = np.asarray(s, dtype=np.uint64)
    bl = np.zeros(s.shape, dtype=np.int64)
    v = s.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        m = v >= (np.uint64(1) << np.uint64(shift))
        bl[m] += shift
        v[m] >>= np.uint64(shift)
    bl[s > 0] += 1
    return bl


def encode_symbols(symbols, num_components: int, method: int,
                   writer: ByteWriter) -> None:
    """Encode a flat symbol array (num_values * num_components entries).

    Wire format (encode/entropy/symbol_coding.rs:17-55): u8 method, then the
    method-specific payload."""
    symbols = np.asarray(symbols, dtype=np.uint64).ravel()
    writer.write_u8(method)
    if method == LENGTH_CODED:
        _encode_length_coded(symbols, num_components, writer)
    elif method == DIRECT_CODED:
        _encode_direct_coded(symbols, writer)
    else:
        raise ValueError(f"unknown symbol encoding method {method}")


def _encode_length_coded(symbols: np.ndarray, num_components: int,
                         writer: ByteWriter) -> None:
    """Tags = per-value max bit length over components, rANS-coded in reverse
    value order with precision 12; raw value bits appended MSB-first in
    forward order (symbol_coding.rs:67-106)."""
    num_values = len(symbols) // num_components
    per_comp = symbols.reshape(num_values, num_components)
    bit_lengths = bit_length_u64(per_comp).max(axis=1)

    freq_counts = np.bincount(bit_lengths)
    enc = RansSymbolEncoder(writer, freq_counts, precision=12)
    enc.write_all(bit_lengths[::-1])
    enc.flush()

    from ..ops.bitpack import pack_bits_msb
    sizes = np.repeat(bit_lengths, num_components)
    writer.write_bytes(pack_bits_msb(sizes, per_comp.ravel()))


def _encode_direct_coded(symbols: np.ndarray, writer: ByteWriter) -> None:
    """u8 bit-length token derived from the count of nonzero symbols
    (a reference quirk — symbol_coding.rs:110-112), then one rANS stream at
    the precision schedule, symbols fed in reverse."""
    from .. import native
    blob = native.encode_direct(symbols)
    if blob is not None:
        writer.write_bytes(blob)
        return
    num_nonzero = int(np.count_nonzero(symbols))
    bit_length = int(bit_length_u64(np.asarray([num_nonzero]))[0]) + 1
    bit_length = max(1, min(18, bit_length))
    writer.write_u8(bit_length)
    precision = rans_precision_for_bit_length(bit_length)

    max_symbol = int(symbols.max()) if len(symbols) else 0
    freq_counts = np.bincount(symbols.astype(np.int64), minlength=max_symbol + 1)
    enc = RansSymbolEncoder(writer, freq_counts, precision=precision)
    enc.write_all(symbols[::-1].astype(np.int64))
    enc.flush()


def decode_symbols(num_symbols: int, num_components: int,
                   reader: ByteReader) -> np.ndarray:
    """Decode ``num_symbols`` total symbols (values * components).

    Mirror of decode/entropy/symbol_coding.rs:27-117."""
    method = reader.read_u8()
    if method == LENGTH_CODED:
        return _decode_length_coded(num_symbols, num_components, reader)
    if method == DIRECT_CODED:
        return _decode_direct_coded(num_symbols, reader)
    raise ValueError(f"unknown symbol encoding method {method}")


def _decode_length_coded(num_symbols: int, num_components: int,
                         reader: ByteReader) -> np.ndarray:
    from ..ops.bitpack import unpack_bits_msb

    dec = RansSymbolDecoder(reader, precision=12)
    num_values = num_symbols // num_components
    bit_lengths = dec.decode_all(num_values)
    sizes = np.repeat(np.asarray(bit_lengths, dtype=np.int64),
                      num_components)
    total_bits = int(sizes.sum())
    nbytes = (total_bits + 7) // 8
    out = unpack_bits_msb(bytes(reader.read_bytes(nbytes)), sizes)
    return out


def parse_direct_coded_stream(reader: ByteReader):
    """Parse a DIRECT_CODED symbol stream's header and CONSUME its payload
    without decoding: returns (dist, precision, payload bytes) for batched
    device decoding (ops/rans_lanes.rans_decode_lanes). Raises ValueError
    on any other method — callers fall back to the host decoder."""
    from ..wire.varint import leb128_read
    from .rans import parse_rans_table

    method = reader.read_u8()
    if method != DIRECT_CODED:
        raise ValueError(f"not a direct-coded stream (method {method})")
    bit_length = reader.read_u8()
    if not 1 <= bit_length <= 18:
        raise ValueError(f"invalid direct-coded bit length {bit_length}")
    precision = rans_precision_for_bit_length(bit_length)
    dist = parse_rans_table(reader)
    nbytes = leb128_read(reader)
    payload = bytes(reader.read_bytes(nbytes))
    return dist, precision, payload


def _decode_direct_coded(num_symbols: int, reader: ByteReader) -> np.ndarray:
    bit_length = reader.read_u8()
    if not 1 <= bit_length <= 18:
        raise ValueError(f"invalid direct-coded bit length {bit_length}")
    precision = rans_precision_for_bit_length(bit_length)
    dec = RansSymbolDecoder(reader, precision=precision)
    return dec.decode_all(num_symbols).astype(np.uint64)

"""Sub-byte bit packing in both bit orders.

Draco uses LSB-first packing for edgebreaker CLERS symbols and
topology-split orientations, and MSB-first elsewhere (length-coded raw
value bits). Reference behavior: draco-oxide/src/core/bit_coder.rs:90-188
(BitWriter) and :347-444 (BitReader).

Scalar writers/readers here are the host reference implementation; the
vectorized array packers (used by the kernels) live in torchdraco.ops.bitpack.
"""

from __future__ import annotations

from .byte_io import ByteReader, ByteWriter


class BitWriter:
    """Accumulates bits and flushes whole bytes into a ByteWriter.

    Must be explicitly ``close()``d to pad + emit the final partial byte
    (mirrors the reference's Drop impl)."""

    __slots__ = ("writer", "msb_first", "_acc", "_nbits")

    def __init__(self, writer: ByteWriter, msb_first: bool = True) -> None:
        self.writer = writer
        self.msb_first = msb_first
        self._acc = 0  # pending bits, fewer than 8
        self._nbits = 0

    def write_bits(self, size: int, value: int) -> None:
        if size == 0:
            return
        value &= (1 << size) - 1
        if self.msb_first:
            acc = (self._acc << size) | value
            n = self._nbits + size
            while n >= 8:
                n -= 8
                self.writer.write_u8(acc >> n)
            self._acc = acc & ((1 << n) - 1)
            self._nbits = n
        else:
            acc = self._acc | (value << self._nbits)
            n = self._nbits + size
            while n >= 8:
                self.writer.write_u8(acc & 0xFF)
                acc >>= 8
                n -= 8
            self._acc = acc
            self._nbits = n

    def close(self) -> None:
        """Pad the final partial byte with zero bits and emit it."""
        if self._nbits > 0:
            if self.msb_first:
                self.writer.write_u8(self._acc << (8 - self._nbits))
            else:
                self.writer.write_u8(self._acc)
            self._acc = 0
            self._nbits = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class BitReader:
    """Reads bit groups from a ByteReader in MSB- or LSB-first order."""

    __slots__ = ("reader", "msb_first", "_acc", "_nbits")

    def __init__(self, reader: ByteReader, msb_first: bool = True) -> None:
        self.reader = reader
        self.msb_first = msb_first
        self._acc = 0
        self._nbits = 0

    def read_bits(self, size: int) -> int:
        if size == 0:
            return 0
        while self._nbits < size:
            byte = self.reader.read_u8()
            if self.msb_first:
                self._acc = (self._acc << 8) | byte
            else:
                self._acc |= byte << self._nbits
            self._nbits += 8
        if self.msb_first:
            self._nbits -= size
            out = self._acc >> self._nbits
            self._acc &= (1 << self._nbits) - 1
        else:
            out = self._acc & ((1 << size) - 1)
            self._acc >>= size
            self._nbits -= size
        return out

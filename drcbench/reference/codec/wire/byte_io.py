"""Byte-level I/O for the Draco bitstream.

Little-endian byte writers/readers plus a reverse reader used by rANS
(the rANS stream is read back-to-front).

Reference behavior: draco-oxide/src/core/bit_coder.rs:7-344 (ByteWriter /
ByteReader traits), :455-504 (ReverseByteReader).
"""

from __future__ import annotations


class NotEnoughData(Exception):
    """Raised when a reader runs out of bytes."""


class ByteWriter:
    """Appends little-endian integers to a growable byte buffer."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def __len__(self) -> int:
        return len(self.buf)

    def write_u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def write_u16(self, v: int) -> None:
        self.buf += (v & 0xFFFF).to_bytes(2, "little")

    def write_u24(self, v: int) -> None:
        self.buf += (v & 0xFFFFFF).to_bytes(3, "little")

    def write_u32(self, v: int) -> None:
        self.buf += (v & 0xFFFFFFFF).to_bytes(4, "little")

    def write_u64(self, v: int) -> None:
        self.buf += (v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")

    def write_f32(self, v: float) -> None:
        import struct

        self.buf += struct.pack("<f", v)

    def write_bytes(self, b) -> None:
        self.buf += b

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class ReverseByteReader:
    """Reads a byte span back-to-front.

    ``read_uN_back`` returns the value whose *most significant* byte is the
    last byte of the span, matching draco-oxide's ReverseByteReader
    (core/bit_coder.rs:455-504): bytes are popped from the back and the pop
    order is MSB-first.
    """

    __slots__ = ("_view", "_idx")

    def __init__(self, view) -> None:
        self._view = view
        self._idx = len(view)  # next pop is at _idx - 1

    def remaining(self) -> int:
        return self._idx

    def read_u8_back(self) -> int:
        if self._idx <= 0:
            raise NotEnoughData("reverse reader exhausted")
        self._idx -= 1
        return self._view[self._idx]

    def read_u16_back(self) -> int:
        return (self.read_u8_back() << 8) | self.read_u8_back()

    def read_u24_back(self) -> int:
        v = self.read_u8_back() << 16
        v |= self.read_u8_back() << 8
        return v | self.read_u8_back()

    def read_u32_back(self) -> int:
        v = self.read_u16_back() << 16
        return v | self.read_u16_back()


class ByteReader:
    """Forward little-endian reader over an immutable byte buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, data, pos: int = 0) -> None:
        self.buf = memoryview(data) if not isinstance(data, memoryview) else data
        self.pos = pos

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def _take(self, n: int):
        if self.pos + n > len(self.buf):
            raise NotEnoughData(f"need {n} bytes, have {self.remaining()}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_u8(self) -> int:
        return self._take(1)[0]

    def read_u16(self) -> int:
        return int.from_bytes(self._take(2), "little")

    def read_u24(self) -> int:
        return int.from_bytes(self._take(3), "little")

    def read_u32(self) -> int:
        return int.from_bytes(self._take(4), "little")

    def read_u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def read_f32(self) -> float:
        import struct

        return struct.unpack("<f", self._take(4))[0]

    def read_bytes(self, n: int) -> bytes:
        return bytes(self._take(n))

    def spawn_reverse_reader(self, offset: int) -> ReverseByteReader:
        """Consume the next ``offset`` bytes and return a reverse reader over
        them (draco-oxide core/bit_coder.rs:272-281)."""
        return ReverseByteReader(self._take(offset))


class FunctionalByteWriter:
    """Closure-backed writer (core/bit_coder.rs FunctionalByteWriter):
    every byte is handed to ``emit(b)``. Useful for tee/streaming sinks."""

    def __init__(self, emit) -> None:
        self._emit = emit
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def write_u8(self, v: int) -> None:
        self._emit(v & 0xFF)
        self._n += 1

    def write_u16(self, v: int) -> None:
        for i in range(2):
            self.write_u8(v >> (8 * i))

    def write_u24(self, v: int) -> None:
        for i in range(3):
            self.write_u8(v >> (8 * i))

    def write_u32(self, v: int) -> None:
        for i in range(4):
            self.write_u8(v >> (8 * i))

    def write_u64(self, v: int) -> None:
        for i in range(8):
            self.write_u8(v >> (8 * i))

    def write_f32(self, v: float) -> None:
        import struct
        for b in struct.pack("<f", v):
            self.write_u8(b)

    def write_bytes(self, data) -> None:
        for b in bytes(data):
            self.write_u8(b)


class FunctionalByteReader:
    """Closure-backed reader (core/bit_coder.rs FunctionalByteReader):
    pulls bytes from ``fetch()`` on demand."""

    def __init__(self, fetch) -> None:
        self._fetch = fetch

    def read_u8(self) -> int:
        return self._fetch() & 0xFF

    def read_u16(self) -> int:
        return self.read_u8() | (self.read_u8() << 8)

    def read_u24(self) -> int:
        return self.read_u16() | (self.read_u8() << 16)

    def read_u32(self) -> int:
        return self.read_u16() | (self.read_u16() << 16)

    def read_u64(self) -> int:
        return self.read_u32() | (self.read_u32() << 32)

    def read_bytes(self, n: int) -> bytes:
        return bytes(self.read_u8() for _ in range(n))

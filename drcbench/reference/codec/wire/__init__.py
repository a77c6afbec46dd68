from .byte_io import ByteReader, ByteWriter, NotEnoughData, ReverseByteReader
from .bit_io import BitReader, BitWriter
from .varint import leb128_read, leb128_size, leb128_write, unzigzag, zigzag

__all__ = [
    "ByteReader", "ByteWriter", "NotEnoughData", "ReverseByteReader",
    "BitReader", "BitWriter",
    "leb128_read", "leb128_size", "leb128_write", "unzigzag", "zigzag",
]

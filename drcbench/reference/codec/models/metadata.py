"""Draco geometry metadata: key/value records with flat sub-metadata,
attached globally or per attribute.

Wire format follows the reference decoder (draco-oxide/src/decode/metadata/
mod.rs:24-104): u32 entry count; per entry a leb128 attribute id + record;
then one global record. A record is u8 key length + key bytes + u8 value
length + value bytes + leb128 sub-record count + sub-records (key/value
pairs, same u8-length framing). The reference *encoder* is a stub that
writes only ``u32 0`` (encode/metadata/mod.rs:9-20) — a section its own
decoder cannot parse (it unconditionally expects the global record); we
always emit the decodable full form. The reference's record reader also
zero-pads keys/values to twice their length (vec![0; n] + push, decode/
metadata/mod.rs:52-61 — a bug its sibling SubMetadata reader doesn't have);
we implement the evident intent.
"""

from __future__ import annotations

from ..wire.varint import leb128_read, leb128_write


class MetadataEntry:
    """One metadata record: key/value plus flat sub-entries."""

    def __init__(self, key: bytes = b"", value: bytes = b"",
                 sub: dict[bytes, bytes] | None = None) -> None:
        self.key = bytes(key)
        self.value = bytes(value)
        self.sub: dict[bytes, bytes] = dict(sub or {})

    def is_empty(self) -> bool:
        return not (self.key or self.value or self.sub)

    def __eq__(self, other) -> bool:
        return (isinstance(other, MetadataEntry) and self.key == other.key
                and self.value == other.value and self.sub == other.sub)

    def __repr__(self) -> str:
        return (f"MetadataEntry(key={self.key!r}, value={self.value!r}, "
                f"sub={self.sub!r})")

    def write_to(self, writer) -> None:
        for blob in (self.key, self.value):
            if len(blob) > 255:
                raise ValueError("metadata key/value longer than 255 bytes")
            writer.write_u8(len(blob))
            writer.write_bytes(blob)
        leb128_write(len(self.sub), writer)
        for k, v in self.sub.items():
            if len(k) > 255 or len(v) > 255:
                raise ValueError("sub-metadata key/value longer than 255 bytes")
            writer.write_u8(len(k))
            writer.write_bytes(bytes(k))
            writer.write_u8(len(v))
            writer.write_bytes(bytes(v))

    @classmethod
    def read_from(cls, reader) -> "MetadataEntry":
        key = reader.read_bytes(reader.read_u8())
        value = reader.read_bytes(reader.read_u8())
        sub = {}
        for _ in range(leb128_read(reader)):
            k = reader.read_bytes(reader.read_u8())
            v = reader.read_bytes(reader.read_u8())
            sub[k] = v
        return cls(key, value, sub)


class GeometryMetadata:
    """Per-attribute entries keyed by attribute id, plus a global entry."""

    def __init__(self) -> None:
        self.attribute_entries: dict[int, MetadataEntry] = {}
        self.global_entry = MetadataEntry()

    def is_empty(self) -> bool:
        return not self.attribute_entries and self.global_entry.is_empty()

    def set_global(self, key: str | bytes, value: str | bytes) -> None:
        self.global_entry = MetadataEntry(_b(key), _b(value),
                                          self.global_entry.sub)

    def add_attribute_entry(self, att_id: int, key: str | bytes,
                            value: str | bytes,
                            sub: dict | None = None) -> None:
        self.attribute_entries[att_id] = MetadataEntry(
            _b(key), _b(value),
            {_b(k): _b(v) for k, v in (sub or {}).items()})

    def write_to(self, writer) -> None:
        writer.write_u32(len(self.attribute_entries))
        for att_id in sorted(self.attribute_entries):
            leb128_write(att_id, writer)
            self.attribute_entries[att_id].write_to(writer)
        self.global_entry.write_to(writer)

    @classmethod
    def read_from(cls, reader) -> "GeometryMetadata":
        out = cls()
        num = reader.read_u32()
        for _ in range(num):
            att_id = leb128_read(reader)
            out.attribute_entries[att_id] = MetadataEntry.read_from(reader)
        out.global_entry = MetadataEntry.read_from(reader)
        return out


def _b(s) -> bytes:
    return s.encode("utf-8") if isinstance(s, str) else bytes(s)

"""In-band stream-alignment debug markers.

Port of the reference's `debug_format` technique (draco-oxide
src/utils/debug.rs:1-27): when enabled, the encoder interleaves marker
strings into the bitstream at stage boundaries and the decoder asserts each
one on read. A misaligned stream fails fast at the first marker after the
divergence instead of producing garbage downstream — the cheapest
bisection tool for wire bugs.

Markers are length-prefixed (u8) ASCII so the decoder can both verify text
and resynchronize its read cursor. Disabled by default: marked streams are
NOT valid Draco bitstreams; use only for debugging, exactly like the
reference's `debug_format` cargo feature.
"""

from __future__ import annotations

import os

_ENABLED = bool(int(os.environ.get("TORCHDRACO_DEBUG_FORMAT", "0")))


def debug_format_enabled() -> bool:
    return _ENABLED


def set_debug_format(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


class StreamMarkerError(AssertionError):
    """Raised when a decoder hits a marker that doesn't match the encoder's."""


def debug_write(writer, marker: str) -> None:
    """Interleave `marker` into the stream (encoder side). No-op unless
    debug format is enabled. Mirrors `debug_write!` (utils/debug.rs:1-13)."""
    if not _ENABLED:
        return
    data = marker.encode("ascii")
    if len(data) > 255:
        raise ValueError("marker too long")
    writer.write_u8(len(data))
    writer.write_bytes(data)


def debug_expect(reader, marker: str) -> None:
    """Assert the next in-band marker equals `marker` (decoder side). No-op
    unless debug format is enabled. Mirrors `debug_expect!`
    (utils/debug.rs:15-27)."""
    if not _ENABLED:
        return
    expected = marker.encode("ascii")
    n = reader.read_u8()
    got = reader.read_bytes(n)
    if got != expected:
        raise StreamMarkerError(
            f"stream misaligned: expected marker {expected!r}, got {got!r}")

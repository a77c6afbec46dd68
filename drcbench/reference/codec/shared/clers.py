"""CLERS symbol tables for edgebreaker.

Reference behavior: draco-oxide/src/shared/connectivity/edgebreaker/
symbol_encoder.rs (draco ids :30-38, CrLight codes :50-78).
"""

from __future__ import annotations

C, S, L, R, E = range(5)  # draco symbol ids: C=0, S=1, L=2, R=3, E=4

SYMBOL_NAMES = "CSLRE"

# CrLight: (bit size, LSB-first value)
CRLIGHT_CODES = {
    C: (1, 0b0),
    S: (3, 0b001),
    L: (3, 0b011),
    R: (3, 0b101),
    E: (3, 0b111),
}

# array form for vectorized packing, indexed by draco symbol id
import numpy as _np  # noqa: E402

CRLIGHT_SIZES = _np.array([CRLIGHT_CODES[s][0] for s in range(5)],
                          dtype=_np.int64)
CRLIGHT_BITS = _np.array([CRLIGHT_CODES[s][1] for s in range(5)],
                         dtype=_np.int64)


def crlight_decode(bit_reader) -> int:
    """Decode one CrLight symbol from an LSB-first bit reader.

    Inverse of the encoder's codes (symbol_encoder.rs:50-58): C is a single
    0 bit; otherwise the remaining two bits select S/L/R/E. (The reference's
    own dead-code decoder at symbol_encoder.rs:60-78 is bit-rotted and does
    not invert its encoder; this matches Google draco's convention.)"""
    if bit_reader.read_bits(1) == 0:
        return C
    v = bit_reader.read_bits(2)
    return (S, L, R, E)[v]


# Edgebreaker kinds (shared/connectivity/edgebreaker/mod.rs:20-53)
EB_STANDARD = 0
EB_PREDICTIVE = 1
EB_VALENCE = 2

# Traversal types (mod.rs:59-88)
TRAVERSAL_DEPTH_FIRST = 0
TRAVERSAL_PREDICTION_DEGREE = 1

MIN_VALENCE = 2
MAX_VALENCE = 7

ORIENTATION_LEFT = 0
ORIENTATION_RIGHT = 1

from .rans import (
    DEFAULT_RABS_PRECISION,
    DEFAULT_RANS_PRECISION,
    L_RANS_BASE,
    RabsDecoder,
    RabsEncoder,
    RansDecoder,
    RansEncoder,
    RansSymbolDecoder,
    RansSymbolEncoder,
    normalize_freq_counts,
    parse_rans_table,
    rans_precision_for_bit_length,
    serialize_rans_table,
)
from .symbol_coding import (
    DIRECT_CODED,
    LENGTH_CODED,
    bit_length_u64,
    decode_symbols,
    encode_symbols,
)

__all__ = [
    "DEFAULT_RABS_PRECISION", "DEFAULT_RANS_PRECISION", "L_RANS_BASE",
    "RabsDecoder", "RabsEncoder", "RansDecoder", "RansEncoder",
    "RansSymbolDecoder", "RansSymbolEncoder",
    "normalize_freq_counts", "parse_rans_table",
    "rans_precision_for_bit_length", "serialize_rans_table",
    "DIRECT_CODED", "LENGTH_CODED", "bit_length_u64",
    "decode_symbols", "encode_symbols",
]

"""The one door from torchdraco into tpudraco's host codec.

The host codec (wire, models, entropy, encode, native) is numpy and C++ and
is the byte oracle, so the port reuses it rather than forking it. Three of
its modules import ``tpudraco.ops.bitpack`` or ``tpudraco.ops.gathers``
lazily, and importing any ``tpudraco.ops`` submodule runs
``tpudraco/ops/__init__.py``, which imports the Pallas kernels and with them
``jax``. On a machine without JAX that import fails, so there this module
registers ``tpudraco.ops`` as a bare package: its ``__path__`` points at the
real directory, but its ``__init__`` is never executed, so only the
numpy-only submodules the host codec asks for are loaded.

Where JAX is installed, nothing is stubbed: ``tpudraco.ops`` imports
normally, so a process that later runs the JAX package sees the real
package. Every other torchdraco module takes its tpudraco symbols from here.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import sys


def _jax_installed() -> bool:
    try:
        return importlib.util.find_spec("jax") is not None
    except ImportError:  # a meta-path finder that refuses jax
        return False


def _bridge() -> None:
    import tpudraco  # noqa: F401  (its __init__ imports no tpudraco.ops)

    if "tpudraco.ops" in sys.modules or _jax_installed():
        return
    pkg_dir = os.path.dirname(os.path.abspath(sys.modules["tpudraco"].__file__))
    spec = importlib.machinery.ModuleSpec("tpudraco.ops", None,
                                          is_package=True)
    mod = importlib.util.module_from_spec(spec)
    mod.__path__ = [os.path.join(pkg_dir, "ops")]
    mod.__file__ = None
    sys.modules["tpudraco.ops"] = mod


_bridge()

from tpudraco import native  # noqa: E402
from tpudraco.decode import _assemble_mesh, decode, decode_header  # noqa: E402
from tpudraco.decode.attribute import decode_attributes  # noqa: E402
from tpudraco.decode.connectivity import decode_connectivity  # noqa: E402
from tpudraco.encode import (  # noqa: E402
    Config, _traversal_wire_id, encode, encode_header, encode_metadata,
)
from tpudraco.encode.attribute import encode_attributes  # noqa: E402
from tpudraco.encode.connectivity import EdgebreakerEncoder  # noqa: E402
from tpudraco.entropy.rans import (  # noqa: E402
    RansDecoder, RansEncoder, normalize_freq_counts,
    normalize_freq_counts_batch, rans_precision_for_bit_length,
    serialize_rans_table, serialize_rans_tables_batch,
)
from tpudraco.entropy.symbol_coding import (  # noqa: E402
    DIRECT_CODED, bit_length_u64, encode_symbols, parse_direct_coded_stream,
)
from tpudraco.models import (  # noqa: E402
    AttributeDomain, AttributeType, MeshBuilder, TableView,
)
from tpudraco.native import topo as native_topo  # noqa: E402
from tpudraco.ops.gathers import build_parallelogram_gathers  # noqa: E402
from tpudraco.shared.sequencer import compute_sequence  # noqa: E402
from tpudraco.wire.byte_io import ByteReader, ByteWriter  # noqa: E402
from tpudraco.wire.varint import leb128_bytes, leb128_write  # noqa: E402

__all__ = [
    "AttributeDomain", "AttributeType", "ByteReader", "ByteWriter", "Config",
    "DIRECT_CODED", "EdgebreakerEncoder", "MeshBuilder", "RansDecoder",
    "RansEncoder", "TableView", "_assemble_mesh", "_traversal_wire_id",
    "bit_length_u64", "build_parallelogram_gathers", "compute_sequence",
    "decode", "decode_attributes", "decode_connectivity", "decode_header",
    "encode", "encode_attributes", "encode_header", "encode_metadata",
    "encode_symbols", "leb128_bytes", "leb128_write", "native",
    "native_topo", "normalize_freq_counts", "normalize_freq_counts_batch",
    "parse_direct_coded_stream", "rans_precision_for_bit_length",
    "serialize_rans_table", "serialize_rans_tables_batch",
]

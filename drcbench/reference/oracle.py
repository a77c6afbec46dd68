"""The plain reference of the benchmark's cells, on the frozen codec copy
beside it (numpy and Python only, nothing of the program under test).

- ``encode_frames``: the ``.drc`` of each frame, byte for byte as Draco's
  host encoder writes it. Meshes that share faces and value maps share one
  connectivity pass, as the encoder's own output allows: the header, the
  connectivity bytes, then each attribute's stream.
- ``stream_stats``: per attribute of a stream, its symbols, table entries
  and payload bytes, for the rooflines' counts of work.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .codec.encode import Config, encode_header
from .codec.encode.attribute import encode_attributes
from .codec.encode.connectivity import EdgebreakerEncoder
from .codec.encode.portabilization import (
    PORT_OCTAHEDRAL, PORT_QUANTIZATION,
)
from .codec.encode.transforms import (
    XFORM_OCT_ORTHOGONAL, XFORM_OCT_REFLECTION, XFORM_ORTHOGONAL,
    XFORM_WRAPPED_DIFFERENCE,
)
from .codec.entropy.symbol_coding import parse_direct_coded_stream
from .codec.models import (
    AttributeDomain, AttributeType, MeshBuilder, TableView,
)
from .codec.shared.prediction import PRED_NORMAL, PRED_TEX_COORDS
from .codec.shared.sequencer import compute_sequence
from .codec.wire.byte_io import ByteReader, ByteWriter
from .codec.wire.varint import leb128_read

ATTRIBUTE_TYPES = {"position": AttributeType.POSITION,
                   "normal": AttributeType.NORMAL,
                   "tex_coord": AttributeType.TEX_COORD}


def codec_config(quantization: dict) -> Config:
    """The encoder's Config at the configuration's depths (draco_encoder's
    -qp, -qn, -qt)."""
    return Config(quant_bits={ATTRIBUTE_TYPES[k]: int(v)
                              for k, v in quantization.items()})


def build_mesh(faces, positions, normals, uvs):
    """A mesh with the default attribute set: POSITION, then NORMAL and
    TEX_COORD per corner, parented to the positions."""
    mb = MeshBuilder()
    mb.set_connectivity_attribute(faces)
    pid = mb.add_attribute(positions, AttributeType.POSITION,
                           AttributeDomain.POSITION)
    mb.add_attribute(normals, AttributeType.NORMAL, AttributeDomain.CORNER,
                     parents=[pid])
    mb.add_attribute(uvs, AttributeType.TEX_COORD, AttributeDomain.CORNER,
                     parents=[pid])
    return mb.build()


def signature(mesh) -> str:
    """Meshes with equal faces and value maps share one connectivity."""
    h = hashlib.sha256(np.ascontiguousarray(mesh.faces).tobytes())
    for a in mesh.attributes:
        h.update(bytes([a.att_type, a.domain, a.num_components]))
        h.update(np.ascontiguousarray(a.unique_indices()).tobytes())
    return h.hexdigest()


def _sequence(view, seeds, memo: list) -> list[int]:
    """``compute_sequence`` of ``view``. The traversal is a function of the
    view's (effective opposite, corner-to-vertex, left-most) arrays and the
    seeds alone, so a view whose arrays equal an earlier one's (an
    attribute without seams) takes that one's sequence (``memo``)."""
    arrays = view.as_arrays()
    for seen, seq in memo:
        if all(np.array_equal(a, b) for a, b in zip(seen, arrays)):
            return seq
    seq = compute_sequence(view, list(seeds))
    memo.append((arrays, seq))
    return seq


class EncoderTopology:
    """The encoder's connectivity pass of one topology: its bytes, corner
    tables and each attribute's traversal sequence."""

    def __init__(self, mesh) -> None:
        w = ByteWriter()
        self.conn_out = EdgebreakerEncoder(mesh.faces, mesh.attributes).encode(w)
        self.conn_bytes = w.getvalue()
        self.pred_cache: dict = {}
        seeds = self.conn_out.corners_of_edgebreaker
        memo: list = []
        self.sequences = {i: _sequence(self.view(i), seeds, memo)
                          for i in range(len(mesh.attributes))}

    def view(self, i: int) -> TableView:
        aict = self.conn_out.corner_table
        table = (aict.attribute_tables[i - 1]
                 if 0 < i <= len(aict.attribute_tables) else None)
        return TableView(aict.corner_table, table)


def encode_with(mesh, topo: EncoderTopology, cfg: Config) -> bytes:
    w = ByteWriter()
    encode_header(w, cfg)
    w.write_bytes(topo.conn_bytes)
    encode_attributes(mesh.attributes, w, topo.conn_out,
                      sequences=topo.sequences, quant_bits=cfg.quant_bits,
                      pred_cache=topo.pred_cache)
    return w.getvalue()


def encode_frames(meshes: list, cfg: Config, topos: dict | None = None
                  ) -> list[bytes]:
    """The ``.drc`` of each mesh. ``topos`` (signature -> EncoderTopology)
    is filled and reused across calls."""
    topos = {} if topos is None else topos
    out = []
    for m in meshes:
        sig = signature(m)
        if sig not in topos:
            topos[sig] = EncoderTopology(m)
        out.append(encode_with(m, topos[sig], cfg))
    return out


# bytes of a transform's metadata after its stream: wrapped difference
# and the octahedral transforms carry two u32s
_XFORM_META_BYTES = {XFORM_WRAPPED_DIFFERENCE: 8, XFORM_OCT_REFLECTION: 8,
                     XFORM_OCT_ORTHOGONAL: 8, XFORM_ORTHOGONAL: 8}


def _skip_rabs(reader: ByteReader) -> None:
    """A RAbS bit stream: its probability byte, size and bytes."""
    reader.read_u8()
    reader.read_bytes(leb128_read(reader))


def stream_stats(blob: bytes, topo: EncoderTopology) -> list[dict]:
    """Per attribute of ``blob`` (encoded over ``topo``): its symbols,
    table entries, precision and payload bytes, read past each attribute's
    prediction data and metadata."""
    reader = ByteReader(blob, pos=11 + len(topo.conn_bytes))
    n_atts = reader.read_u8()
    heads = [{"dec_id": reader.read_u8(), "domain": reader.read_u8(),
              "traversal": reader.read_u8()} for _ in range(n_atts)]
    for h in heads:
        reader.read_u8()
        h.update(att_type=AttributeType(reader.read_u8()),
                 component_type=reader.read_u8(),
                 num_components=reader.read_u8(),
                 normalized=reader.read_u8(), unique_id=reader.read_u8(),
                 port_type=reader.read_u8())
    out = []
    for h, seq in zip(heads, topo.sequences.values()):
        scheme = reader.read_u8()
        xform = reader.read_u8()
        reader.read_u8()  # rANS flag
        n = 2 if h["port_type"] == PORT_OCTAHEDRAL else h["num_components"]
        dist, precision, payload = parse_direct_coded_stream(reader)
        out.append({"h": h, "scheme": scheme, "xform": xform,
                    "symbols": len(seq) * n, "table_entries": len(dist),
                    "precision": precision, "payload_bytes": len(payload)})
        if scheme == PRED_NORMAL:
            reader.read_bytes(_XFORM_META_BYTES.get(xform, 0))
            _skip_rabs(reader)  # the flips
        elif scheme == PRED_TEX_COORDS:
            reader.read_u32()  # the orientations' count
            _skip_rabs(reader)
            reader.read_bytes(_XFORM_META_BYTES.get(xform, 0))
        else:
            reader.read_bytes(_XFORM_META_BYTES.get(xform, 0))
        if h["port_type"] == PORT_QUANTIZATION:
            reader.read_bytes(4 * n + 4 + 1)  # mins, range, bits
        elif h["port_type"] == PORT_OCTAHEDRAL:
            reader.read_u8()  # bits
    if reader.remaining():
        raise ValueError(f"{reader.remaining()} bytes past the last stream")
    return out

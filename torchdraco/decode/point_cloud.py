"""Point-cloud decoding (Draco geometry type 0) — mirror of
torchdraco/encode/point_cloud.py."""

from __future__ import annotations

import numpy as np

from ..entropy.symbol_coding import decode_symbols
from ..models.attribute import Attribute, AttributeDomain, AttributeType
from ..models.mesh import Mesh
from ..wire.varint import leb128_read
from .attribute import DecodeError


def unzigzag(u: np.ndarray) -> np.ndarray:
    u = np.asarray(u, dtype=np.uint64)
    half = (u >> np.uint64(1)).astype(np.int64)
    return np.where((u & np.uint64(1)) == 0, half, -half - 1)


def decode_point_cloud(reader) -> Mesh:
    num_points = leb128_read(reader)
    if num_points > max(reader.remaining(), 1) << 12:
        # corrupt counts must not bomb the allocator (see the
        # connectivity guard)
        raise ValueError("point count exceeds stream size")
    attributes = decode_sequential_attributes(reader, num_points)
    return Mesh(faces=np.zeros((0, 3), dtype=np.int64),
                attributes=attributes)


def decode_sequential_attributes(reader, num_points: int) -> list:
    """Mirror of encode.point_cloud.encode_sequential_attributes."""
    num_atts = reader.read_u8()
    attributes = []
    for i in range(num_atts):
        att_type = AttributeType(reader.read_u8())
        n_comp = reader.read_u8()
        unique_id = reader.read_u8()
        bits = reader.read_u8()
        if bits and att_type == AttributeType.NORMAL and n_comp == 3:
            # octahedral normals (2 coords, no mins/delta metadata)
            from ..shared.octahedral import octahedral_inverse_transform
            if not 7 <= bits <= 16:
                raise DecodeError(f"invalid octahedral bits {bits}")
            q = decode_symbols(num_points * 2, 2, reader)
            q = q.astype(np.float32).reshape(num_points, 2)
            scale = np.float32((1 << (bits - 1)) - 1)
            uv = (q / scale - np.float32(1.0)).astype(np.float32)
            values = octahedral_inverse_transform(uv).astype(np.float32)
        elif bits:
            mins = np.asarray([reader.read_f32() for _ in range(n_comp)],
                              dtype=np.float32)
            delta_max = np.float32(reader.read_f32())
            q = decode_symbols(num_points * n_comp, n_comp, reader)
            q = q.astype(np.float32).reshape(num_points, n_comp)
            scale = delta_max / np.float32((1 << bits) - 1)
            values = (q * scale + mins).astype(np.float32)
        else:
            syms = decode_symbols(num_points * n_comp, n_comp, reader)
            values = unzigzag(syms).reshape(num_points, n_comp) \
                .astype(np.int32)
        attributes.append(Attribute(values, att_type,
                                    AttributeDomain.POSITION, att_id=i,
                                    unique_id=unique_id, dedup=False))
    return attributes

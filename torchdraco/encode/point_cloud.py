"""Point-cloud encoding (Draco geometry type 0).

The reference carries only dead stubs for point clouds
(draco-oxide/src/core/point_cloud*; geometry type enum at
encode/header/mod.rs:16-21) — this is a working implementation of the
surface the format reserves. Layout (self-consistent with
decode/point_cloud.py):

  header (geometry type 0, method 0 = sequential)
  leb128 num_points
  u8 num_attributes
  per attribute:
    u8 att_type | u8 num_components | u8 unique_id | u8 quant_bits
    quant_bits > 0:  f32 mins[num_components], f32 delta_max, then
                     length-coded quantized values (point-major)
    quant_bits == 0: ToBits passthrough — zigzagged int32 values,
                     length-coded

Quantization reuses the coordinate-wise scheme
(quantization_coordinate_wise.rs:24-91); entropy coding reuses
encode_symbols LengthCoded (symbol_coding.rs:67-106), both identical to
the mesh path, so the point-cloud surface rides the same device kernels.
"""

from __future__ import annotations

import numpy as np

from ..entropy.symbol_coding import LENGTH_CODED, encode_symbols
from ..models.attribute import AttributeType
from ..models.mesh import Mesh
from ..wire.varint import leb128_write

DEFAULT_BITS = {AttributeType.POSITION: 11, AttributeType.NORMAL: 8,
                AttributeType.TEX_COORD: 10}


def zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return np.where(v >= 0, v << 1, ((-(v + 1)) << 1) + 1).astype(np.uint64)


def encode_point_cloud(mesh: Mesh, writer,
                       quant_bits: dict | None = None) -> None:
    atts = mesh.attributes
    num_points = len(atts[0].values) if atts else 0
    for a in atts:
        if len(a.values) != num_points:
            raise ValueError("point cloud attributes must share point count")
    leb128_write(num_points, writer)
    encode_sequential_attributes(
        [(a.att_type, a.unique_id, np.asarray(a.values)) for a in atts],
        num_points, writer, quant_bits=quant_bits)


def encode_sequential_attributes(atts, num_points: int, writer,
                                 quant_bits: dict | None = None) -> None:
    """Point-major sequential attribute payload, shared by point clouds and
    sequential-connectivity meshes. ``atts`` is a list of
    (att_type, unique_id, values (num_points, N)) tuples. ``quant_bits``
    optionally overrides the per-type bit depth (Config.quant_bits)."""
    writer.write_u8(len(atts))
    for att_type, unique_id, vals in atts:
        n_comp = vals.shape[1] if vals.ndim > 1 else 1
        vals = vals.reshape(num_points, n_comp)
        is_float = np.issubdtype(vals.dtype, np.floating)
        if is_float and not np.isfinite(vals).all():
            # same contract as the edgebreaker plane's _require_finite:
            # NaN/inf would quantize into silent garbage
            raise ValueError(
                f"attribute {AttributeType(att_type).name} contains "
                "non-finite values (NaN/inf); refusing to quantize")
        bits = DEFAULT_BITS.get(att_type, 11) if is_float else 0
        oct_normal = is_float and att_type == AttributeType.NORMAL \
            and n_comp == 3
        if is_float and quant_bits and att_type in quant_bits:
            bits = int(quant_bits[att_type])
            if oct_normal:
                if not 7 <= bits <= 16:
                    raise ValueError(
                        "octahedral normal bits must be in 7..16")
            elif not 1 <= bits <= 30:
                raise ValueError(f"invalid quantization bits {bits}")
        writer.write_u8(int(att_type))
        writer.write_u8(n_comp)
        writer.write_u8((unique_id or 0) & 0xFF)
        writer.write_u8(bits)
        if oct_normal and bits:
            # normals ride the octahedral pipeline (2 coords, no
            # mins/delta metadata) — same portabilization as the
            # edgebreaker plane instead of 3-component coordinate-wise
            from ..shared.octahedral import oct_quantize_normals
            q = oct_quantize_normals(vals.astype(np.float32), bits)
            syms = q.astype(np.uint64).ravel()
            encode_symbols(syms, 2, LENGTH_CODED, writer)
            continue
        if bits:
            v = vals.astype(np.float32)
            zero = np.float32(0.0)
            mins = np.minimum(v.min(axis=0), zero).astype(np.float32)
            maxs = np.maximum(v.max(axis=0), zero).astype(np.float32)
            delta_max = np.float32(max(np.float32(0.0), np.max(maxs - mins)))
            for m in mins:
                writer.write_f32(float(m))
            writer.write_f32(float(delta_max))
            diff = (v - mins).astype(np.float32)
            normd = diff if float(delta_max) == 0.0 \
                else (diff / delta_max).astype(np.float32)
            scale = np.float32((1 << bits) - 1)
            q = ((normd * scale).astype(np.float32)
                 + np.float32(0.5)).astype(np.int64)
            syms = q.astype(np.uint64).ravel()
        else:
            syms = zigzag(vals.astype(np.int64)).ravel()
        encode_symbols(syms, n_comp, LENGTH_CODED, writer)

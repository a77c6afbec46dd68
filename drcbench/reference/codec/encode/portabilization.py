"""Portabilization (quantization) of attributes into integer space.

Reference behavior: draco-oxide/src/encode/attribute/portabilization/
(wire ids + defaults mod.rs:84-143; quantization_coordinate_wise.rs;
octahedral_quantization.rs; to_bits.rs).
"""

from __future__ import annotations

import numpy as np

from ..models.attribute import Attribute, AttributeType
from ..shared.octahedral import oct_quantize_normals

# wire ids (portabilization/mod.rs:84-108)
PORT_TO_BITS = 1
PORT_QUANTIZATION = 2
PORT_OCTAHEDRAL = 3


def default_portabilization_for(att_type: AttributeType,
                                quant_bits: dict | None = None
                                ) -> tuple[int, int]:
    """(type id, quantization bits) defaults (mod.rs:101-143):
    Normal -> octahedral 8, TexCoord -> quant 10, Custom -> ToBits,
    else quant 11. ``quant_bits`` optionally overrides the bit depth per
    AttributeType (Config.quant_bits — draco_encoder's -qp/-qt/-qn; a knob
    the reference declares but leaves unwired, encode/mod.rs:23-26)."""
    if att_type == AttributeType.NORMAL:
        out = PORT_OCTAHEDRAL, 8
    elif att_type == AttributeType.TEX_COORD:
        out = PORT_QUANTIZATION, 10
    elif att_type == AttributeType.CUSTOM:
        out = PORT_TO_BITS, 11
    else:
        out = PORT_QUANTIZATION, 11
    if quant_bits and att_type in quant_bits:
        bits = int(quant_bits[att_type])
        if att_type == AttributeType.NORMAL:
            if not 7 <= bits <= 16:
                # oct coords and the OctOrthogonal mod-max arithmetic stay
                # in int32 through 16 bits; the reference hardcodes 8
                # (max=255) but the wire carries max/center, so other
                # depths remain self-describing (draco_encoder's -qn).
                # Depths below 7 are REJECTED: the wire's mod-max residual
                # (a reference-inherited 2^bits-value domain over a
                # (2^bits - 1)-modulus) loses information when |corr|
                # approaches the modulus — the per-vertex flip bits keep
                # predictions in the near hemisphere so real meshes never
                # get close at >= 7 bits, but at tiny depths ring
                # predictions reach the boundary (exhaustive pair checks
                # + 900-trial mesh sweeps: corrupt at <= 6, clean at 7+)
                raise ValueError("octahedral normal bits must be in 7..16")
        elif not 1 <= bits <= 30:
            raise ValueError(f"invalid quantization bits {bits} for "
                             f"{att_type.name}")
        out = (out[0], bits)
    return out


def _clone_with_values(att: Attribute, values: np.ndarray) -> Attribute:
    out = Attribute(values, att.att_type, att.domain, parents=att.parents,
                    att_id=att.att_id, name=att.name, dedup=False)
    out.point_map = att.point_map
    out.unique_id = att.unique_id
    return out


def _require_finite(att: Attribute) -> None:
    """Non-finite float inputs would quantize into silent garbage (NaN ->
    undefined int cast, inf -> degenerate range); fail at the source with
    a clear error instead of emitting a structurally-valid-but-wrong
    stream."""
    if not np.isfinite(att.values).all():
        raise ValueError(
            f"attribute {att.att_type.name} contains non-finite values "
            "(NaN/inf); refusing to quantize")


def quantize_coordinate_wise(att: Attribute, bits: int, writer) -> Attribute:
    """Per reference (quantization_coordinate_wise.rs): min/max are seeded
    with ZERO (a reference quirk — min <= 0 and max >= 0 always), one shared
    delta_max over all components, value = trunc((v-min)/range * (2^bits-1)
    + 0.5), all math in float32. Metadata: min vec f32 LE, delta_max f32,
    u8 bits."""
    _require_finite(att)
    vals = att.values.astype(np.float32)
    if len(vals) and bits <= 16 and vals.shape[1] <= 16:
        # C++ fused twin (native/csrc/quantize.cpp): same IEEE f32 ops in
        # the same order, two memory passes instead of ~8 (equality
        # pinned by tests/test_parallel.py). Inputs are finite here, so
        # None only means "no toolchain" — fall through to numpy.
        from .. import native
        got = native.quantize_batch(vals[None], bits)
        if got is not None:
            q_u16, mins_b, delta_b, _, _ = got
            for m in mins_b[0]:
                writer.write_f32(float(m))
            writer.write_f32(float(delta_b[0]))
            writer.write_u8(bits)
            return _clone_with_values(att, q_u16[0].astype(np.int32))
    zero = np.float32(0.0)
    mins = np.minimum(vals.min(axis=0), zero).astype(np.float32) \
        if len(vals) else np.zeros(att.num_components, np.float32)
    maxs = np.maximum(vals.max(axis=0), zero).astype(np.float32) \
        if len(vals) else np.zeros(att.num_components, np.float32)
    delta_max = np.float32(max(np.float32(0.0), np.max(maxs - mins))) \
        if len(vals) else np.float32(0.0)

    for m in mins:
        writer.write_f32(float(m))
    writer.write_f32(float(delta_max))
    writer.write_u8(bits)

    diff = (vals - mins).astype(np.float32)
    if float(delta_max) == 0.0:
        normalized = diff
    else:
        normalized = (diff / delta_max).astype(np.float32)
    scale = np.float32((1 << bits) - 1)
    quantized = (normalized * scale).astype(np.float32)
    q = (quantized + np.float32(0.5)).astype(np.float32).astype(np.int64)
    return _clone_with_values(att, q.astype(np.int32))


def quantize_octahedral(att: Attribute, bits: int, writer) -> Attribute:
    """Normal attribute -> 2-component octahedral ints
    (octahedral_quantization.rs). Metadata: u8 bits."""
    assert att.att_type == AttributeType.NORMAL
    _require_finite(att)
    writer.write_u8(bits)
    q = oct_quantize_normals(att.values, bits)
    return _clone_with_values(att, q)


def portabilize(att: Attribute, port_type: int, bits: int, writer) -> Attribute:
    if port_type == PORT_QUANTIZATION:
        return quantize_coordinate_wise(att, bits, writer)
    if port_type == PORT_OCTAHEDRAL:
        return quantize_octahedral(att, bits, writer)
    if port_type == PORT_TO_BITS:
        return att  # identity (to_bits.rs)
    raise ValueError(f"unsupported portabilization {port_type}")

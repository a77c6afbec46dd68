"""Prediction-residual transforms (encoder side), vectorized over the whole
traversal sequence.

Reference behavior: draco-oxide/src/encode/attribute/prediction_transform/
(wire ids mod.rs:89-102; wrapped_difference.rs; oct_orthogonal.rs;
difference.rs).
"""

from __future__ import annotations

import numpy as np

from ..wire.varint import zigzag

# wire ids (prediction_transform/mod.rs:89-102)
XFORM_NONE = 0xFF
XFORM_DIFFERENCE = 0
XFORM_WRAPPED_DIFFERENCE = 1
XFORM_OCT_REFLECTION = 2
XFORM_OCT_ORTHOGONAL = 3
XFORM_ORTHOGONAL = 4


class DifferenceTransform:
    """zigzag(orig - pred) (difference.rs)."""
    xform_id = XFORM_DIFFERENCE

    def squeeze(self, origs: np.ndarray, preds: np.ndarray, writer) -> np.ndarray:
        return zigzag(origs.astype(np.int64) - preds.astype(np.int64))


class NoTransform:
    """Passthrough of the original values (prediction_transform/mod.rs:131-165)."""
    xform_id = XFORM_NONE

    def squeeze(self, origs: np.ndarray, preds: np.ndarray, writer) -> np.ndarray:
        return origs.astype(np.uint64)


class WrappedDifferenceTransform:
    """Global min/max of orig; pred clamped into [min,max]; residual wrapped
    into [min_corr, max_corr]; zigzag (wrapped_difference.rs:36-99).
    Metadata: min, max as raw i32 LE."""
    xform_id = XFORM_WRAPPED_DIFFERENCE

    def squeeze(self, origs: np.ndarray, preds: np.ndarray, writer) -> np.ndarray:
        origs = origs.astype(np.int64)
        preds = preds.astype(np.int64)
        if origs.size:
            vmax = int(origs.max())
            vmin = int(origs.min())
        else:
            vmax, vmin = -(1 << 31), (1 << 31) - 1  # i32::MIN / MAX inits
        max_diff = 1 + vmax - vmin
        max_corr = max_diff // 2
        min_corr = -max_corr
        if (max_diff & 1) == 0:
            max_corr -= 1
        pred_c = np.clip(preds, vmin, vmax)
        val = origs - pred_c
        corr = np.where(val > max_corr, val - max_diff,
                        np.where(val < min_corr, val + max_diff, val))
        writer.write_u32(vmin & 0xFFFFFFFF)  # i32 LE
        writer.write_u32(vmax & 0xFFFFFFFF)
        return zigzag(corr)


class OctOrthogonalTransform:
    """Octahedral orthogonal residual for oct-quantized normals
    (oct_orthogonal.rs:23-85). Metadata: u32 max, u32 center — the
    reference hardcodes 8-bit (255/127); other depths use the same
    self-describing wire fields.

    Wire caveat (reference-inherited): the residual is taken mod max
    over a (max+1)-value faithful-code domain, so (orig, pred) pairs
    with |corr| at the modulus boundary are irrecoverably ambiguous —
    the reference's own (never-shipped) decoder could not have noticed.
    The per-vertex flip bits keep predictions in the near hemisphere,
    which keeps |corr| far from the boundary on real meshes at >= 7
    bits; the encoder rejects smaller depths (portabilization.py)."""
    xform_id = XFORM_OCT_ORTHOGONAL

    def __init__(self, bits: int = 8) -> None:
        self.mx = (1 << bits) - 1

    def squeeze(self, origs: np.ndarray, preds: np.ndarray, writer) -> np.ndarray:
        from ..shared.octahedral import invert_diamond
        one = self.mx // 2
        orig = origs.astype(np.int64) - one
        pred = preds.astype(np.int64) - one

        # hemisphere flip when pred is outside the diamond (|p0|+|p1| > 127),
        # using draco's involutive InvertDiamond (see shared.octahedral)
        flip = (np.abs(pred).sum(axis=1)) > one
        pred = np.where(flip[:, None], invert_diamond(pred, one), pred)
        orig = np.where(flip[:, None], invert_diamond(orig, one), orig)

        # rotate in 90° steps until pred lands in the third quadrant
        # (p0 < 0 and p1 <= 0); at most 3 rotations, vectorized
        nonzero = (pred != 0).any(axis=1)
        for _ in range(4):
            todo = nonzero & ((pred[:, 0] >= 0) | (pred[:, 1] > 0))
            if not todo.any():
                break
            rp = np.stack([-pred[:, 1], pred[:, 0]], axis=1)
            ro = np.stack([-orig[:, 1], orig[:, 0]], axis=1)
            pred = np.where(todo[:, None], rp, pred)
            orig = np.where(todo[:, None], ro, orig)

        corr = orig - pred
        corr = np.where(corr < 0, corr + self.mx, corr)
        writer.write_u32(self.mx)
        writer.write_u32(one)
        return corr.astype(np.uint64)


class OctReflectionTransform:
    """Octahedral reflection residual: reflect pred (and orig with it) into
    the upper hemisphere, then plain zigzag difference.

    The reference ships this transform half-built (encode/attribute/
    prediction_transform/oct_reflection.rs flips the negative-z hemisphere
    but leaves squeeze unimplemented!() — it is unreachable from default
    configs). This is the completed form for 2-component octahedral coords:
    the hemisphere flip becomes draco's involutive diamond inversion when
    pred is outside the diamond, with NO rotation step (the rotation is what
    distinguishes OctOrthogonal)."""
    xform_id = XFORM_OCT_REFLECTION

    def __init__(self, bits: int = 8) -> None:
        self.mx = (1 << bits) - 1

    def squeeze(self, origs: np.ndarray, preds: np.ndarray, writer) -> np.ndarray:
        from ..shared.octahedral import invert_diamond
        one = self.mx // 2
        orig = origs.astype(np.int64) - one
        pred = preds.astype(np.int64) - one
        flip = (np.abs(pred).sum(axis=1)) > one
        pred = np.where(flip[:, None], invert_diamond(pred, one), pred)
        orig = np.where(flip[:, None], invert_diamond(orig, one), orig)
        writer.write_u32(self.mx)
        writer.write_u32(one)
        return zigzag(orig - pred)


class OrthogonalTransform:
    """Exact orthogonal-frame residual for octahedral normals (wire id 4).

    The reference declares this id (prediction_transform/mod.rs:89-102) but
    its body is unimplemented!() at the core map
    (encode/attribute/prediction_transform/orthogonal.rs:44) and the partial
    forward it does ship is numerically unsound (the law-of-cosines terms at
    orthogonal.rs:87,94 are not cosines — parenthesization drops the 2·r
    divisor — so acos would see arguments far outside [-1, 1]); no config
    can produce it. This is the completed, integer-exact form: canonicalize
    the prediction with an element of the full dihedral group D4 ⊂ O(2)
    (diamond inversion + 90° rotations as in OctOrthogonal, PLUS a diagonal
    reflection so |p0| >= |p1|), apply the same orthogonal map to the
    original, then plain zigzag difference. Every step is a bijection on
    ℤ², so — unlike OctOrthogonal's mod-max residual — there is NO
    boundary ambiguity at any quantization depth. Metadata: u32 max,
    u32 center (self-describing, same wire shape as the oct transforms).
    The D4 element derives from pred alone, so the decoder recomputes it
    without side data."""
    xform_id = XFORM_ORTHOGONAL

    def __init__(self, bits: int = 8) -> None:
        self.mx = (1 << bits) - 1

    def squeeze(self, origs: np.ndarray, preds: np.ndarray, writer) -> np.ndarray:
        from ..shared.octahedral import invert_diamond
        one = self.mx // 2
        orig = origs.astype(np.int64) - one
        pred = preds.astype(np.int64) - one

        flip = (np.abs(pred).sum(axis=1)) > one
        pred = np.where(flip[:, None], invert_diamond(pred, one), pred)
        orig = np.where(flip[:, None], invert_diamond(orig, one), orig)

        # rotate in 90° steps until pred lands in the third quadrant
        # (p0 < 0 and p1 <= 0), exactly as OctOrthogonal
        nonzero = (pred != 0).any(axis=1)
        for _ in range(4):
            todo = nonzero & ((pred[:, 0] >= 0) | (pred[:, 1] > 0))
            if not todo.any():
                break
            rp = np.stack([-pred[:, 1], pred[:, 0]], axis=1)
            ro = np.stack([-orig[:, 1], orig[:, 0]], axis=1)
            pred = np.where(todo[:, None], rp, pred)
            orig = np.where(todo[:, None], ro, orig)

        # reflect across the diagonal into the canonical half-octant
        # |p0| >= |p1| (in Q3 both components are <= 0, so that is p0 <= p1)
        swap = pred[:, 0] > pred[:, 1]
        pred = np.where(swap[:, None], pred[:, ::-1], pred)
        orig = np.where(swap[:, None], orig[:, ::-1], orig)

        writer.write_u32(self.mx)
        writer.write_u32(self.mx // 2)
        return zigzag(orig - pred)


def make_transform(xform_id: int, normal_bits: int = 8):
    if xform_id == XFORM_DIFFERENCE:
        return DifferenceTransform()
    if xform_id == XFORM_WRAPPED_DIFFERENCE:
        return WrappedDifferenceTransform()
    if xform_id == XFORM_OCT_ORTHOGONAL:
        return OctOrthogonalTransform(normal_bits)
    if xform_id == XFORM_OCT_REFLECTION:
        return OctReflectionTransform(normal_bits)
    if xform_id == XFORM_ORTHOGONAL:
        return OrthogonalTransform(normal_bits)
    if xform_id == XFORM_NONE:
        return NoTransform()
    raise ValueError(f"unsupported prediction transform {xform_id}")

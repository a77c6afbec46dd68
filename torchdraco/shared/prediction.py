"""Prediction schemes over the traversal order.

Used by both encoder and decoder: predictions only ever read vertices already
visited, so the same code drives both directions.

Reference behavior: draco-oxide/src/shared/attribute/prediction_scheme/
(wire ids mod.rs:74-86; parallelogram mesh_parallelogram_prediction.rs:186-237;
delta delta_prediction.rs:56-71; normal mesh_normal_prediction.rs;
texcoord mesh_prediction_for_texture_coordinates.rs).
"""

from __future__ import annotations

import numpy as np

from ..models.corner_table import NONE, TableView, next_corner, prev_corner
from .octahedral import into_faithful_oct_quantization, octahedral_transform

# wire ids (prediction_scheme/mod.rs:74-86)
PRED_DELTA = 0
PRED_PARALLELOGRAM = 1
PRED_MULTI_PARALLELOGRAM = 2
PRED_TEX_COORDS = 5
PRED_NORMAL = 6
PRED_DERIVATIVE = 7
PRED_NONE = 0xFE


def _i32(v: int) -> int:
    return ((int(v) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def trunc_div(a: int, b: int) -> int:
    """Rust-style integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


class PredictionState:
    """Tracks visited vertices in traversal order (the reference's
    ``vertices_processed_up_till_now``)."""

    def __init__(self, num_vertices: int) -> None:
        self.visited = np.zeros(num_vertices, dtype=bool)
        self.order: list[int] = []

    def push(self, v: int) -> None:
        self.order.append(v)
        self.visited[v] = True

    def contains(self, v: int) -> bool:
        return bool(self.visited[v])

    def last(self) -> int | None:
        return self.order[-1] if self.order else None


class BasePrediction:
    scheme_id = PRED_NONE

    def __init__(self, view: TableView, parents) -> None:
        self.view = view
        self.parents = parents

    def predict(self, c: int, state: PredictionState, att_get) -> np.ndarray:
        raise NotImplementedError

    def metadata_bytes(self, writer) -> None:  # most schemes have none
        return None


class NoPrediction(BasePrediction):
    scheme_id = PRED_NONE

    def __init__(self, view, parents, n):
        super().__init__(view, parents)
        self.n = n

    def predict(self, c, state, att_get):
        return np.zeros(self.n, dtype=np.int64)


def ring_width(ctv) -> int:
    """R of the normal rings over a corner -> vertex map: the most corners
    on one vertex (1 for a table without vertices)."""
    ctv = np.asarray(ctv)
    ctv = ctv[ctv >= 0]
    return int(np.bincount(ctv).max()) if ctv.size else 1


def collect_normal_rings(view: TableView, sequence) -> dict:
    """Per-topology ring precompute for normal prediction: the masked
    leftmost-then-swing-right walk of the scalar predict(), batched.
    Shared by the host predict_sequence and the device normal chain
    (ops/normals.py) — single source of truth for the walk.

    Returns numpy arrays: tip_pt (T,) target-corner point index;
    next_pt/prev_pt (T, R) ring-corner neighbor point indices;
    mask (T, R) ring-slot validity."""
    from ..models.corner_table import next_corners, prev_corners

    seq = np.asarray(sequence, dtype=np.int64)
    T = len(seq)
    eff_opp, ctv, _lm = view.as_arrays()
    eff_opp = np.asarray(eff_opp, dtype=np.int64)
    if hasattr(view, "u"):  # encoder TableView: universal point map
        points = np.asarray(view.u.faces_points, dtype=np.int64).ravel()
    else:  # decoder view: point(c) == c
        points = np.arange(view.num_corners, dtype=np.int64)

    def swing(c, left):
        base = np.where(c >= 0, c, 0)
        step = next_corners(base) if left else prev_corners(base)
        o = eff_opp[step]
        ob = np.where(o >= 0, o, 0)
        res = next_corners(ob) if left else prev_corners(ob)
        return np.where((c >= 0) & (o >= 0), res, NONE)

    maxv = ring_width(ctv)

    # leftmost walk (swing left until boundary or full circle)
    cur = seq.copy()
    frozen = np.zeros(T, dtype=bool)
    for _ in range(maxv + 1):
        nl = swing(cur, left=True)
        can = ~frozen & (nl != NONE)
        cur = np.where(can, nl, cur)
        frozen |= ~can | (can & (nl == seq))
        if frozen.all():
            break

    # collect rings by swinging right from the start corner
    rings = np.full((T, maxv), NONE, dtype=np.int64)
    rings[:, 0] = cur
    active = np.ones(T, dtype=bool)
    prev_cur = cur
    for i in range(1, maxv):
        nxt = swing(prev_cur, left=False)
        ok = active & (nxt != NONE) & (nxt != rings[:, 0])
        rings[:, i] = np.where(ok, nxt, NONE)
        active = ok
        prev_cur = np.where(ok, nxt, prev_cur)

    rbase = np.where(rings >= 0, rings, 0)
    return {
        "tip_pt": points[seq].astype(np.int32),
        "next_pt": points[next_corners(rbase)].astype(np.int32),
        "prev_pt": points[prev_corners(rbase)].astype(np.int32),
        "mask": rings >= 0,
    }


def collect_uv_gathers(view, sequence, num_pos_points: int) -> dict:
    """Topology-static precompute for the UV chain: point indices and
    first-occurrence visited masks per traversal step."""
    from ..models.corner_table import next_corners, prev_corners

    seq = np.asarray(sequence, dtype=np.int64)
    T = len(seq)
    _eff_opp, ctv, lm = view.as_arrays()
    if hasattr(view, "u"):
        points = np.asarray(view.u.faces_points, dtype=np.int64).ravel()
    else:
        points = np.arange(view.num_corners, dtype=np.int64)

    nc, pc = next_corners(seq), prev_corners(seq)
    vn, vp = ctv[nc], ctv[pc]
    ks = np.arange(T)
    pos_in_seq = np.full(view.num_vertices, T, dtype=np.int64)
    pos_in_seq[ctv[seq]] = ks
    vis_n = pos_in_seq[np.clip(vn, 0, view.num_vertices - 1)] < ks
    vis_p = pos_in_seq[np.clip(vp, 0, view.num_vertices - 1)] < ks
    vis_n &= vn >= 0
    vis_p &= vp >= 0

    npt, ppt, cpt = points[nc], points[pc], points[seq]
    last_pt = np.zeros(T, dtype=np.int64)
    if T > 1:
        last_pt[1:] = points[lm[ctv[seq[:-1]]]]

    return {
        "cpt": cpt.astype(np.int32), "npt": npt.astype(np.int32),
        "ppt": ppt.astype(np.int32), "last_pt": last_pt.astype(np.int32),
        "vis_n": vis_n, "vis_p": vis_p,
        "pos_ok_n": (npt < num_pos_points),
        "pos_ok_p": (ppt < num_pos_points),
        "pos_ok_c": (cpt < num_pos_points),
    }



def _last_value_fallback(view: TableView, state: PredictionState, att_get, n):
    last_v = state.last()
    if last_v is None:
        return np.zeros(n, dtype=np.int64)
    return att_get(view.point(view.left_most_corner(last_v)))


class DeltaPrediction(BasePrediction):
    """Previous visited vertex's value (delta_prediction.rs:56-71)."""
    scheme_id = PRED_DELTA

    def __init__(self, view, parents, n):
        super().__init__(view, parents)
        self.n = n

    def predict(self, c, state, att_get):
        return _last_value_fallback(self.view, state, att_get, self.n)


class ParallelogramPrediction(BasePrediction):
    """a + b - diagonal across the opposite corner when all three are
    visited, else the most recent vertex value
    (mesh_parallelogram_prediction.rs:186-237)."""
    scheme_id = PRED_PARALLELOGRAM

    def __init__(self, view, parents, n):
        super().__init__(view, parents)
        self.n = n

    def predict(self, c, state, att_get):
        view = self.view
        opp = view.opp(c)
        if opp != NONE:
            nc, pc = next_corner(c), prev_corner(c)
            if (state.contains(view.vertex(opp)) and state.contains(view.vertex(nc))
                    and state.contains(view.vertex(pc))):
                a = att_get(view.point(nc))
                b = att_get(view.point(pc))
                d = att_get(view.point(opp))
                return a.astype(np.int64) + b.astype(np.int64) - d.astype(np.int64)
        return _last_value_fallback(view, state, att_get, self.n)


class MultiParallelogramPrediction(BasePrediction):
    """Average of all valid parallelogram predictions around the target
    vertex (Google Draco's MeshPredictionSchemeMultiParallelogram
    semantics: swing-right walk from the target corner, sum each
    parallelogram whose three source vertices are already visited, then
    truncating integer division by the count); previous-value fallback
    when no parallelogram is valid.

    The reference stubs this scheme (wire id 2, mesh_multi_parallelogram_
    prediction.rs — constructors only, predict unimplemented); this is a
    real implementation the way Spirale/metadata already exceed the
    reference. Opt-in via Config.prediction; streams carry the proper wire
    id so our decoder round-trips them."""
    scheme_id = PRED_MULTI_PARALLELOGRAM

    def __init__(self, view, parents, n):
        super().__init__(view, parents)
        self.n = n

    def predict(self, c, state, att_get):
        view = self.view
        total = np.zeros(self.n, dtype=np.int64)
        num = 0
        ci = c
        while ci != NONE:
            opp = view.opp(ci)
            if opp != NONE:
                nc, pc = next_corner(ci), prev_corner(ci)
                if (state.contains(view.vertex(opp))
                        and state.contains(view.vertex(nc))
                        and state.contains(view.vertex(pc))):
                    a = att_get(view.point(nc)).astype(np.int64)
                    b = att_get(view.point(pc)).astype(np.int64)
                    d = att_get(view.point(opp)).astype(np.int64)
                    total += a + b - d
                    num += 1
            ci = view.swing_right(ci)
            if ci == c:
                break
        if num > 0:
            return np.array([trunc_div(int(t), num) for t in total],
                            dtype=np.int64)
        return _last_value_fallback(view, state, att_get, self.n)

    @staticmethod
    def predict_sequence(view: TableView, sequence,
                         vals_by_point: np.ndarray) -> np.ndarray:
        """Vectorized encoder-side multi-parallelogram for the whole
        traversal: the swing-right corner rings are static corner-table
        walks and the visited checks reduce to first-occurrence masks, so
        the per-ring parallelogram sums batch over (T, ring) — bit-
        identical to the scalar loop (pinned by tests)."""
        from ..models.corner_table import next_corners, prev_corners

        seq = np.asarray(sequence, dtype=np.int64)
        T = len(seq)
        if T == 0:
            return np.zeros((0, vals_by_point.shape[-1]), dtype=np.int64)
        eff_opp, ctv, lm = view.as_arrays()
        eff_opp = np.asarray(eff_opp, dtype=np.int64)
        if hasattr(view, "u"):
            points = np.asarray(view.u.faces_points, dtype=np.int64).ravel()
        else:
            points = np.arange(view.num_corners, dtype=np.int64)
        vals = np.asarray(vals_by_point, dtype=np.int64)

        ks = np.arange(T)
        pos_in_seq = np.full(view.num_vertices, T, dtype=np.int64)
        pos_in_seq[ctv[seq]] = ks

        def swing_right(c):
            base = np.where(c >= 0, c, 0)
            o = eff_opp[prev_corners(base)]
            return np.where((c >= 0) & (o >= 0),
                            prev_corners(np.where(o >= 0, o, 0)), NONE)

        maxv = ring_width(ctv)
        rings = np.full((T, maxv), NONE, dtype=np.int64)
        rings[:, 0] = seq
        cur = seq.copy()
        active = np.ones(T, dtype=bool)
        for i in range(1, maxv):
            nxt = swing_right(cur)
            ok = active & (nxt != NONE) & (nxt != seq)
            rings[:, i] = np.where(ok, nxt, NONE)
            active = ok
            cur = np.where(ok, nxt, cur)

        rbase = np.where(rings >= 0, rings, 0)
        opp = eff_opp[rbase]
        ob = np.where(opp >= 0, opp, 0)
        nc, pc = next_corners(rbase), prev_corners(rbase)
        visited = (pos_in_seq[ctv[ob]] < ks[:, None]) \
            & (pos_in_seq[ctv[nc]] < ks[:, None]) \
            & (pos_in_seq[ctv[pc]] < ks[:, None])
        valid = (rings >= 0) & (opp >= 0) & visited

        contrib = (vals[points[nc]] + vals[points[pc]]
                   - vals[points[ob]])                       # (T, R, N)
        contrib = np.where(valid[..., None], contrib, 0)
        total = contrib.sum(axis=1)                          # (T, N)
        num = valid.sum(axis=1)                              # (T,)

        safe = np.maximum(num, 1)[:, None]
        avg = np.sign(total) * (np.abs(total) // safe)       # trunc toward 0

        # fallback: the most recent visited vertex's value (zeros at t=0)
        lastvals = np.zeros((T, vals.shape[-1]), dtype=np.int64)
        if T > 1:
            lastvals[1:] = vals[points[lm[ctv[seq[:-1]]]]]
        return np.where((num > 0)[:, None], avg, lastvals)


class NormalPrediction(BasePrediction):
    """Ring sum of face-normal cross products from quantized positions,
    octahedral-quantized to 8 bits, with per-vertex flip bits
    (mesh_normal_prediction.rs)."""
    scheme_id = PRED_NORMAL

    def __init__(self, view, parents, n, bits: int = 8):
        super().__init__(view, parents)
        assert parents, "normal prediction needs a position parent"
        self.pos = parents[0]
        self.bits = bits  # octahedral depth (reference hardcodes 8)
        self.flips: list[bool] = []
        self.pending_flip: bool | None = None  # decoder injects stored flips

    def _face_normal(self, c: int, pos_c: np.ndarray) -> np.ndarray:
        view = self.view
        pn = self._pos(view.point(next_corner(c))) - pos_c
        pp = self._pos(view.point(prev_corner(c))) - pos_c
        # cross in i32 then widen (mesh_normal_prediction.rs:31-44)
        cross = np.array([
            _i32(pn[1] * pp[2] - pn[2] * pp[1]),
            _i32(pn[2] * pp[0] - pn[0] * pp[2]),
            _i32(pn[0] * pp[1] - pn[1] * pp[0]),
        ], dtype=np.int64)
        return cross

    def _pos(self, p: int) -> np.ndarray:
        return self.pos.value_at_point(p).astype(np.int64)

    def predict(self, c, state, att_get):
        view = self.view
        pos_c = self._pos(view.point(c))
        # swing to the leftmost corner (or full circle)
        curr = c
        left = view.swing_left(curr)
        while left != NONE:
            curr = left
            if curr == c:
                break
            left = view.swing_left(curr)
        start = curr
        total = self._face_normal(curr, pos_c)
        nxt = view.swing_right(curr)
        while nxt != NONE:
            curr = nxt
            if curr == start:
                break
            total = total + self._face_normal(curr, pos_c)
            nxt = view.swing_right(curr)

        upper = 1 << 29
        abs_sum = int(np.abs(total).sum())
        if abs_sum > upper:
            q = abs_sum // upper
            total = np.array([trunc_div(int(t), q) for t in total], dtype=np.int64)
        total = np.array([_i32(t) for t in total], dtype=np.int64)

        if not total.any():
            out = np.zeros(2, dtype=np.int64)
        else:
            oct = octahedral_transform(total.astype(np.int32)) + np.float32(1.0)
            quant = (oct * np.float32((1 << (self.bits - 1)) - 1)) \
                .astype(np.float32)
            q = quant.astype(np.int64)  # trunc toward zero
            out = into_faithful_oct_quantization(q, self.bits) \
                .astype(np.int64)

        if self.pending_flip is not None:
            if self.pending_flip:
                out = -out
            return out
        actual = att_get(view.point(c)).astype(np.int64)
        d1 = out - actual
        d2 = -out - actual
        if int(d1 @ d1) > int(d2 @ d2):
            self.flips.append(True)
            out = -out
        else:
            self.flips.append(False)
        return out

    @staticmethod
    def predict_sequence(view: TableView, sequence, pos_parent,
                         bits: int = 8) -> np.ndarray:
        """Vectorized ring-sum normal prediction for the whole traversal.

        The ring around each visited vertex is traversal-state-independent
        (the scalar predict() walks the static corner table only), so the
        entire (T, 2) prediction array computes as batched numpy: the
        shared collect_normal_rings walk gathers per-vertex rings,
        face-normal cross products accumulate with the reference's
        per-face i32 wraparound, and the octahedral quantization pipeline
        runs batched. Bit-identical to the scalar path (pinned by
        tests)."""
        seq = np.asarray(sequence, dtype=np.int64)
        T = len(seq)
        if T == 0:
            return np.zeros((0, 2), dtype=np.int64)
        if hasattr(pos_parent, "unique_indices"):  # encoder Attribute
            posvals = pos_parent.values[pos_parent.unique_indices()].astype(
                np.int64)
        else:  # decoder _CornerIndexedParent: per-corner quantized values
            da = pos_parent.da
            posvals = np.asarray(da.quantized_by_vertex, dtype=np.int64)[
                np.asarray(da.vertex_of_corner, dtype=np.int64)]

        rings = collect_normal_rings(view, sequence)
        mask = rings["mask"]

        wrap32 = lambda x: ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # noqa: E731
        pos_tip = posvals[rings["tip_pt"]][:, None, :]       # (T, 1, 3)
        pn = posvals[rings["next_pt"]] - pos_tip             # (T, R, 3)
        pp = posvals[rings["prev_pt"]] - pos_tip
        cr = np.stack([
            wrap32(pn[..., 1] * pp[..., 2] - pn[..., 2] * pp[..., 1]),
            wrap32(pn[..., 2] * pp[..., 0] - pn[..., 0] * pp[..., 2]),
            wrap32(pn[..., 0] * pp[..., 1] - pn[..., 1] * pp[..., 0]),
        ], axis=-1)
        cr = np.where(mask[..., None], cr, 0)
        total = cr.sum(axis=1)                               # (T, 3)

        upper = 1 << 29
        abs_sum = np.abs(total).sum(axis=1)
        big = abs_sum > upper
        q = np.where(big, abs_sum // upper, 1)
        total = np.where(big[:, None],
                         np.sign(total) * (np.abs(total) // q[:, None]),
                         total)
        total = wrap32(total)

        nonzero = total.any(axis=1)
        # zero totals bypass the transform (scalar early-out); substitute a
        # unit vector so the batched normalize never divides by zero
        total = np.where(nonzero[:, None], total,
                         np.array([1, 0, 0], dtype=np.int64))
        oct = octahedral_transform(total.astype(np.int32)) + np.float32(1.0)
        quant = (oct * np.float32((1 << (bits - 1)) - 1)).astype(np.float32)
        out = into_faithful_oct_quantization(
            quant.astype(np.int64), bits).astype(np.int64)
        return np.where(nonzero[:, None], out, 0)

    def metadata_bytes(self, writer) -> None:
        write_normal_flips(self.flips, writer)


def write_normal_flips(flips, writer) -> None:
    """Flip bits RAbS-coded, written in forward order
    (mesh_normal_prediction.rs:147-164). Shared by the host predictor and
    the device normal chain's metadata assembly; ``flips`` is any
    array-like of truth values. No flips raises: the zero probability
    is then 0 / 0."""
    flips = np.asarray(flips, dtype=bool).ravel()
    n0 = flips.size - int(np.count_nonzero(flips))
    zp = int(np.float32(n0) / np.float32(flips.size) * np.float32(256.0)
             + np.float32(0.5))
    zero_prob = max(1, min(255, zp))
    writer.write_u8(zero_prob)
    _write_rabs_bits(flips, zero_prob, writer)


def _write_rabs_bits(bits: np.ndarray, zero_prob: int, writer) -> None:
    """leb128 length, then the RAbS blob of ``bits`` in one coder call."""
    from ..entropy.rans import RabsEncoder
    from ..wire.varint import leb128_write
    enc = RabsEncoder(zero_prob)
    enc.write_all(bits)
    blob = enc.flush()
    leb128_write(len(blob), writer)
    writer.write_bytes(blob)


class DerivativePrediction(BasePrediction):
    """Derivative UV prediction (wire id 7): project the new vertex's
    position delta onto the decoded adjacent triangle's tangent plane and
    apply the same barycentric displacement in UV space.

    The reference reserves this scheme and carries the algorithm only as
    commented-out dead code behind ``unimplemented!()``
    (shared/attribute/prediction_scheme/derivative_prediction.rs:20-111;
    its encoder defaults never select id 7, attribute_encoder.rs:59-108).
    This is a WORKING opt-in implementation of that algorithm — a
    tpudraco dialect surface like MultiParallelogram: strict mode rejects
    it (Config.validate_strict rejects every prediction override), and
    the self-decoder is the oracle. Geometry uses the same next/prev/opp
    corners as the parallelogram; all float math is f64 on both sides
    (encoder and decoder run this same method, so prediction equality is
    by construction), with floor(x + 0.5) rounding to ints."""
    scheme_id = PRED_DERIVATIVE

    def __init__(self, view, parents, n):
        super().__init__(view, parents)
        if not parents:
            raise ValueError(
                "Derivative prediction needs a POSITION parent")
        self.pos = parents[0]
        self.n = n

    def _pos(self, p: int) -> np.ndarray:
        if p < self.pos.num_points:
            return self.pos.value_at_point(p).astype(np.int64)
        return np.zeros(3, dtype=np.int64)

    def _fallback(self, c, state, att_get):
        view = self.view
        nc = next_corner(c)
        if state.contains(view.vertex(nc)):
            return att_get(view.point(nc)).astype(np.int64)
        return _last_value_fallback(view, state, att_get, self.n)

    def predict(self, c, state, att_get):
        view = self.view
        opp = view.opp(c)
        if opp == NONE:
            return self._fallback(c, state, att_get)
        nc, pc = next_corner(c), prev_corner(c)
        if not (state.contains(view.vertex(opp))
                and state.contains(view.vertex(nc))
                and state.contains(view.vertex(pc))):
            return self._fallback(c, state, att_get)
        a_uv = att_get(view.point(nc)).astype(np.int64)
        b_uv = att_get(view.point(pc)).astype(np.int64)
        d_uv = att_get(view.point(opp)).astype(np.int64)
        u_pos = (self._pos(view.point(nc))
                 - self._pos(view.point(opp))).astype(np.float64)
        v_pos = (self._pos(view.point(pc))
                 - self._pos(view.point(opp))).astype(np.float64)
        normal = np.cross(u_pos, v_pos)
        n2 = float(normal @ normal)
        if n2 == 0.0:  # degenerate adjacent triangle
            return self._fallback(c, state, att_get)
        delta = (self._pos(view.point(c))
                 - self._pos(view.point(opp))).astype(np.float64)
        # project the position delta onto the triangle plane, then solve
        # the barycentric coordinates s, t along (u_pos, v_pos)
        proj = normal * (-(float(normal @ delta)) / n2) + delta
        s = float(np.cross(proj, v_pos) @ normal) / n2
        t = float(np.cross(u_pos, proj) @ normal) / n2
        delta_uv = ((a_uv - d_uv).astype(np.float64) * s
                    + (b_uv - d_uv).astype(np.float64) * t)
        return d_uv + np.floor(delta_uv + 0.5).astype(np.int64)


class TexCoordPrediction(BasePrediction):
    """Draco's UV prediction from quantized positions with integer sqrt and
    per-vertex orientation bits; replicates the reference's fallback quirk
    (the prev-vertex branch is intentionally omitted,
    mesh_prediction_for_texture_coordinates.rs:64-73)."""
    scheme_id = PRED_TEX_COORDS

    def __init__(self, view, parents, n):
        super().__init__(view, parents)
        self.pos = parents[0]
        self.orientations: list[bool] = []
        self.pending_orientations: list[bool] | None = None  # decoder side
        self._pending_idx = 0

    def _pos(self, p: int) -> np.ndarray:
        if p < self.pos.num_points:
            return self.pos.value_at_point(p).astype(np.int64)
        return np.zeros(3, dtype=np.int64)

    @staticmethod
    def _int_sqrt(value: int) -> int:
        if value == 0:
            return 0
        act, sqrt = value, 1
        while act >= 2:
            sqrt *= 2
            act //= 4
        sqrt = (sqrt + value // sqrt) // 2
        while sqrt * sqrt > value:
            sqrt = (sqrt + value // sqrt) // 2
        return sqrt

    def _fallback(self, c, state, att_get):
        view = self.view
        nc = next_corner(c)
        if state.contains(view.vertex(nc)):
            return att_get(view.point(nc)).astype(np.int64)
        return _last_value_fallback(view, state, att_get, 2)

    def predict(self, c, state, att_get):
        view = self.view
        nc, pc = next_corner(c), prev_corner(c)
        next_pt, prev_pt, curr_pt = view.point(nc), view.point(pc), view.point(c)
        if state.contains(view.vertex(nc)) and state.contains(view.vertex(pc)):
            next_uv = att_get(next_pt).astype(np.int64)
            prev_uv = att_get(prev_pt).astype(np.int64)
            if np.array_equal(next_uv, prev_uv):
                return prev_uv
            curr_pos = self._pos(curr_pt)
            next_pos = self._pos(next_pt)
            prev_pos = self._pos(prev_pt)
            pn = prev_pos - next_pos
            pn_norm2 = int(pn @ pn)
            if pn_norm2 != 0:
                cn = curr_pos - next_pos
                cn_dot_pn = int(pn @ cn)
                pn_uv = prev_uv - next_uv
                i64max = (1 << 63) - 1
                n_uv_absmax = int(np.abs(next_uv).max())
                if n_uv_absmax > i64max // pn_norm2:
                    return self._fallback(c, state, att_get)
                pn_uv_absmax = int(np.abs(pn_uv).max())
                if pn_uv_absmax and abs(cn_dot_pn) > i64max // pn_uv_absmax:
                    return self._fallback(c, state, att_get)
                x_uv = next_uv * pn_norm2 + pn_uv * cn_dot_pn
                pn_absmax = int(np.abs(pn).max())
                if abs(cn_dot_pn) > i64max // pn_absmax:
                    return self._fallback(c, state, att_get)
                x_pos = next_pos + np.array(
                    [trunc_div(int(p) * cn_dot_pn, pn_norm2) for p in pn],
                    dtype=np.int64)
                cx = curr_pos - x_pos
                cx_norm2 = int(cx @ cx)
                cx_uv = np.array([int(pn_uv[1]), -int(pn_uv[0])], dtype=np.int64)
                norm_sq = self._int_sqrt((cx_norm2 * pn_norm2) & ((1 << 64) - 1))
                cx_uv = cx_uv * norm_sq
                pred0 = np.array([trunc_div(int(x_uv[0] + cx_uv[0]), pn_norm2),
                                  trunc_div(int(x_uv[1] + cx_uv[1]), pn_norm2)],
                                 dtype=np.int64)
                pred1 = np.array([trunc_div(int(x_uv[0] - cx_uv[0]), pn_norm2),
                                  trunc_div(int(x_uv[1] - cx_uv[1]), pn_norm2)],
                                 dtype=np.int64)
                if self.pending_orientations is not None:
                    o = self.pending_orientations[self._pending_idx]
                    self._pending_idx += 1
                    pred = pred0 if o else pred1
                else:
                    curr_uv = att_get(curr_pt).astype(np.int64)
                    d0 = curr_uv - pred0
                    d1 = curr_uv - pred1
                    if int(d0 @ d0) < int(d1 @ d1):
                        self.orientations.append(True)
                        pred = pred0
                    else:
                        self.orientations.append(False)
                        pred = pred1
                return np.array([_i32(pred[0]), _i32(pred[1])], dtype=np.int64)
        return self._fallback(c, state, att_get)

    @staticmethod
    def _int_sqrt_vec(value: np.ndarray) -> np.ndarray:
        """Vectorized replica of _int_sqrt (Newton from a power-of-two seed,
        then downward refinement). Caller guarantees value < 2**62 so the
        sqrt*sqrt probe can't overflow int64."""
        value = value.astype(np.int64)
        act = value.copy()
        sqrt = np.ones_like(value)
        for _ in range(32):
            m = act >= 2
            if not m.any():
                break
            sqrt = np.where(m, sqrt * 2, sqrt)
            act = np.where(m, act // 4, act)
        nz = value > 0
        safe = np.where(nz, sqrt, 1)
        sqrt = np.where(nz, (sqrt + value // safe) // 2, 0)
        for _ in range(64):
            over = nz & (sqrt * sqrt > value)
            if not over.any():
                break
            safe = np.where(sqrt > 0, sqrt, 1)
            sqrt = np.where(over, (sqrt + value // safe) // 2, sqrt)
        return sqrt

    @classmethod
    def predict_sequence(cls, view, sequence, pos_parent, uvals_by_point):
        """Vectorized encoder-side UV prediction for the whole traversal.

        On the encoder every attribute value is known upfront, so the
        visited-vertex checks reduce to first-occurrence masks over the
        sequence and the geometric branch runs as batched int64 math. Rows
        whose intermediates could exceed int64 (impossible for default
        10-bit UV / 11-bit position quantization, where the scalar path's
        arbitrary-precision Python ints would differ) fall back to the
        scalar predict row-by-row. Returns (preds (T,2) int64,
        orientations bool (G,) in geometric-branch order) — bit-identical
        to the scalar loop (pinned by tests)."""
        seq = np.asarray(sequence, dtype=np.int64)
        T = len(seq)
        if T == 0:
            return np.zeros((0, 2), dtype=np.int64), np.zeros(0, dtype=bool)
        _eff_opp, ctv, lm = view.as_arrays()
        if hasattr(view, "u"):
            points = np.asarray(view.u.faces_points, dtype=np.int64).ravel()
        else:
            points = np.arange(view.num_corners, dtype=np.int64)
        uvals = np.asarray(uvals_by_point, dtype=np.int64)

        num_pp = pos_parent.num_points
        if hasattr(pos_parent, "unique_indices"):
            pvals = pos_parent.values[pos_parent.unique_indices()].astype(
                np.int64)
        else:
            da = pos_parent.da
            pvals = np.asarray(da.quantized_by_vertex, dtype=np.int64)[
                np.asarray(da.vertex_of_corner, dtype=np.int64)]

        # topology-static gathers/masks shared with the device UV chain
        # (single source of truth, like collect_normal_rings)
        g = collect_uv_gathers(view, sequence, num_pp)
        vis_n = g["vis_n"]
        vis_p = g["vis_p"]
        npt = g["npt"].astype(np.int64)
        ppt = g["ppt"].astype(np.int64)
        cpt = g["cpt"].astype(np.int64)

        def pos_at(pts, ok):
            base = np.where(ok, pts, 0)
            return np.where(ok[:, None], pvals[base], 0)

        next_uv, prev_uv, curr_uv = uvals[npt], uvals[ppt], uvals[cpt]
        cpos = pos_at(cpt, g["pos_ok_c"])
        npos = pos_at(npt, g["pos_ok_n"])
        ppos = pos_at(ppt, g["pos_ok_p"])

        geo_try = vis_n & vis_p
        eq = (next_uv == prev_uv).all(axis=1)
        pn = ppos - npos
        pn_norm2 = np.einsum("ij,ij->i", pn, pn)
        nz = pn_norm2 != 0
        cn = cpos - npos
        cn_dot_pn = np.einsum("ij,ij->i", pn, cn)
        pn_uv = prev_uv - next_uv

        i64max = (1 << 63) - 1
        # positions wider than ~20 bits could overflow the int64 norm math
        # below; route such rows through the exact scalar path
        wide = np.abs(pn).max(axis=1) >= (1 << 20)
        pn_norm2_s = np.where(nz, pn_norm2, 1)
        g1 = np.abs(next_uv).max(axis=1) > i64max // pn_norm2_s
        pn_uv_am = np.abs(pn_uv).max(axis=1)
        g2 = (pn_uv_am != 0) & (np.abs(cn_dot_pn)
                                > i64max // np.where(pn_uv_am != 0,
                                                     pn_uv_am, 1))
        pn_am = np.abs(pn).max(axis=1)
        g3 = np.abs(cn_dot_pn) > i64max // np.where(pn_am != 0, pn_am, 1)
        geo = geo_try & ~eq & nz & ~(g1 | g2 | g3)

        def tdiv(a, b):
            return np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))

        x_uv = next_uv * pn_norm2_s[:, None] + pn_uv * cn_dot_pn[:, None]
        x_pos = npos + tdiv(pn * cn_dot_pn[:, None], pn_norm2_s[:, None])
        cx = cpos - x_pos
        cx_norm2 = np.einsum("ij,ij->i", cx, cx)
        prod = cx_norm2.astype(np.uint64) * pn_norm2.astype(np.uint64)
        # rows whose sqrt input or uv scaling could exceed the vectorized
        # int64 headroom run the exact scalar path instead
        risky = geo & (prod >= np.uint64(1 << 62))
        prod_c = np.where(risky | ~geo, 0, prod).astype(np.int64)
        norm_sq = cls._int_sqrt_vec(prod_c)
        risky |= geo & ((np.maximum(pn_uv_am, 1) * norm_sq) >= (1 << 62))
        risky |= geo & (np.abs(x_uv).max(axis=1) >= (1 << 62))
        risky |= geo_try & ~eq & wide
        geo_v = geo & ~risky

        cx_uv = np.stack([pn_uv[:, 1], -pn_uv[:, 0]],
                         axis=1) * norm_sq[:, None]
        pred0 = tdiv(x_uv + cx_uv, pn_norm2_s[:, None])
        pred1 = tdiv(x_uv - cx_uv, pn_norm2_s[:, None])
        d0 = curr_uv - pred0
        d1 = curr_uv - pred1
        orient = (np.einsum("ij,ij->i", d0, d0)
                  < np.einsum("ij,ij->i", d1, d1))
        wrap32 = lambda x: ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # noqa: E731
        pred_geo = wrap32(np.where(orient[:, None], pred0, pred1))

        # fallback values: uv[next] when next visited, else the most recent
        # visited vertex's value (zeros at the very first step; g["last_pt"]
        # already encodes the shifted gather with a zeroed row 0)
        lastvals = uvals[g["last_pt"].astype(np.int64)]
        lastvals[0] = 0
        fb = np.where(vis_n[:, None], next_uv, lastvals)

        preds = np.where(geo_v[:, None], pred_geo, fb)
        orient_flags = geo_v.copy()
        orient_vals = orient.copy()

        if risky.any():
            scal = cls(view, [pos_parent], 2)
            for k in np.flatnonzero(risky):
                state = PredictionState(view.num_vertices)
                for v in ctv[seq[:k]]:
                    state.push(int(v))
                preds[k] = scal.predict(
                    int(seq[k]), state, lambda p: uvals[p])
                if scal.orientations:  # scalar hit the orientation choice
                    orient_vals[k] = scal.orientations.pop()
                    orient_flags[k] = True
        return preds, orient_vals[orient_flags]

    def decode_orientation(self, o: bool) -> None:
        self.orientations.append(o)

    def metadata_bytes(self, writer) -> None:
        write_tex_orientations(self.orientations, writer)


def write_tex_orientations(orientations, writer) -> None:
    """u32 count, prob byte, RAbS-coded delta-orientation bits
    (mesh_prediction_for_texture_coordinates.rs:221-260). Shared by the
    host predictor and the device UV chain's metadata assembly;
    ``orientations`` is any array-like of truth values."""
    o = np.asarray(orientations, dtype=bool).ravel()
    # change count computed with a *forward* delta chain from True...
    n0 = int(np.count_nonzero(np.diff(o, prepend=True)))
    denom = np.float32(o.size) + np.float32(0.001)
    zp = int(np.float32(n0) / denom * np.float32(256.0) + np.float32(0.5))
    zero_prob = max(1, min(255, zp))
    writer.write_u32(o.size)
    writer.write_u8(zero_prob)
    # ...but the bits themselves use a reverse delta chain from True,
    # re-reversed before coding (the reference's exact quirk): bit i is
    # o[i] == o[i + 1], with a True past the end
    _write_rabs_bits(~np.diff(o, append=True), zero_prob, writer)


def make_prediction(scheme_id: int, view: TableView, parents, n: int,
                    normal_bits: int = 8) -> BasePrediction:
    if scheme_id == PRED_DELTA:
        return DeltaPrediction(view, parents, n)
    if scheme_id == PRED_PARALLELOGRAM:
        return ParallelogramPrediction(view, parents, n)
    if scheme_id == PRED_MULTI_PARALLELOGRAM:
        return MultiParallelogramPrediction(view, parents, n)
    if scheme_id == PRED_NORMAL:
        return NormalPrediction(view, parents, n, bits=normal_bits)
    if scheme_id == PRED_TEX_COORDS:
        return TexCoordPrediction(view, parents, n)
    if scheme_id == PRED_DERIVATIVE:
        return DerivativePrediction(view, parents, n)
    if scheme_id == PRED_NONE:
        return NoPrediction(view, parents, n)
    raise ValueError(f"unsupported prediction scheme {scheme_id}")

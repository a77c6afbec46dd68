"""Attribute decoding: parse headers, rANS-decode residuals, invert the
prediction/transform pipeline, dequantize.

Mirrors torchdraco.encode.attribute (the reference's decoder is WIP; this is a
fresh inverse built against our encoder and the reference's encoder
semantics, cited per stage).
"""

from __future__ import annotations

import numpy as np

from ..entropy.rans import RabsDecoder
from ..entropy.symbol_coding import decode_symbols
from ..models.attribute import Attribute, AttributeDomain, AttributeType, ComponentType
from ..models.corner_table import (
    NONE, next_corner, prev_corner, recompute_attribute_vertices,
)
from ..shared.octahedral import octahedral_inverse_transform
from ..shared.prediction import (
    PRED_DELTA, PRED_DERIVATIVE, PRED_NONE, PRED_NORMAL,
    PRED_PARALLELOGRAM, PRED_TEX_COORDS, PredictionState, make_prediction,
)
from ..shared.sequencer import compute_sequence
from ..wire.byte_io import ByteReader
from ..wire.varint import leb128_read, unzigzag
from .connectivity import ConnectivityDecodeResult, DecodeError

# transform wire ids (encode/transforms.py)
XFORM_NONE = 0xFF
XFORM_DIFFERENCE = 0
XFORM_WRAPPED_DIFFERENCE = 1
XFORM_OCT_REFLECTION = 2
XFORM_OCT_ORTHOGONAL = 3
XFORM_ORTHOGONAL = 4

PORT_TO_BITS = 1
PORT_QUANTIZATION = 2
PORT_OCTAHEDRAL = 3


class _DecView:
    """TableView-alike over the decoded corner table; ``point(c) == c``."""

    def __init__(self, ct, att_corner_to_vertex=None, att_left_most=None,
                 is_edge_on_seam=None, num_att_vertices=None) -> None:
        self.ct = ct
        self.actv = att_corner_to_vertex
        self.alm = att_left_most
        self.seam = is_edge_on_seam
        self.nav = num_att_vertices

    @property
    def num_corners(self):
        return self.ct.num_corners

    def num_faces(self):
        return self.ct.num_faces()

    @property
    def num_vertices(self):
        return self.nav if self.actv is not None else self.ct.num_vertices

    def point(self, c):
        return c

    def vertex(self, c):
        if self.actv is not None:
            return int(self.actv[c])
        return self.ct.vertex(c)

    def opp(self, c):
        if self.seam is not None and self.seam[c]:
            return NONE
        return self.ct.opp(c)

    def left_most_corner(self, v):
        if self.alm is not None:
            return self.alm[v]
        return self.ct.left_most_corner(v)

    def get_right_corner(self, c):
        return self.opp(next_corner(c))

    def get_left_corner(self, c):
        return self.opp(prev_corner(c))

    def swing_right(self, c):
        o = self.opp(prev_corner(c))
        return prev_corner(o) if o != NONE else NONE

    def swing_left(self, c):
        o = self.opp(next_corner(c))
        return next_corner(o) if o != NONE else NONE

    def is_on_boundary(self, v):
        return self.swing_left(self.left_most_corner(v)) == NONE

    def as_arrays(self):
        """(effective opposite, corner_to_vertex, left_most) for the native
        topology passes. Memoized: the view is immutable once built, and
        the grouped decoder calls this once per BLOB on a shared topology."""
        cached = getattr(self, "_arrays_cache", None)
        if cached is not None:
            return cached
        opp = np.asarray(self.ct.opposite, dtype=np.int64)
        if self.seam is not None:
            opp = np.where(self.seam, NONE, opp)
        ctv = (np.asarray(self.actv, dtype=np.int64) if self.actv is not None
               else np.asarray(self.ct.corner_to_vertex, dtype=np.int64))
        lm = (np.asarray(self.alm, dtype=np.int64) if self.alm is not None
              else np.asarray(self.ct.left_most, dtype=np.int64))
        self._arrays_cache = (opp, ctv, lm)
        return self._arrays_cache


class DecodedAttribute:
    def __init__(self, att_type, domain, component_type, num_components,
                 unique_id, values_by_vertex, vertex_of_corner,
                 quantized_by_vertex=None) -> None:
        self.att_type = att_type
        self.domain = domain
        self.component_type = component_type
        self.num_components = num_components
        self.unique_id = unique_id
        self.values_by_vertex = values_by_vertex  # (V_att, N) final values
        self.vertex_of_corner = vertex_of_corner  # (C,)
        # portabilized integer values — prediction of child attributes reads
        # the *quantized* parent (attribute_encoder.rs: parents are the
        # portabilized attributes)
        self.quantized_by_vertex = quantized_by_vertex


def decode_attributes(reader: ByteReader,
                      conn: ConnectivityDecodeResult,
                      symbol_source=None,
                      collect_only: bool = False,
                      normal_collector=None) -> list:
    """``symbol_source(att_idx, num_symbols, num_components, reader)``
    optionally replaces the host symbol decoder per attribute — it must
    CONSUME the symbol stream from ``reader`` and return the (num_values,
    n) symbol array (device batch path) or, with ``collect_only``, may
    return None after recording the stream: the reconstruction chains are
    then skipped and the entry in the result list is None (the stream-
    collection phase of BatchDecoder's device path).

    ``normal_collector(att_idx, da, payload)`` optionally DEFERS the
    NORMAL reconstruction chain (phased batch decode): when a normal
    attribute has the default OctOrthogonal shape, its DecodedAttribute
    is returned with values_by_vertex=None and the chain inputs (symbols,
    flips, view, sequence, position parent, metadata) in ``payload`` —
    the caller batches the chains across blobs on device and fills the
    values (parallel/decode_batch.py). Normals never parent another
    attribute, so deferral cannot starve a dependent chain."""
    num_atts = reader.read_u8()
    headers = []
    for _ in range(num_atts):
        dec_id = reader.read_u8()
        domain = reader.read_u8()
        traversal = reader.read_u8()
        headers.append({"dec_id": dec_id, "domain": domain,
                        "traversal": traversal})
    for h in headers:
        one = reader.read_u8()
        if one != 1:
            raise DecodeError("expected one attribute per decoder")
        h["att_type"] = AttributeType(reader.read_u8())
        h["component_type"] = ComponentType(reader.read_u8())
        h["num_components"] = reader.read_u8()
        h["normalized"] = reader.read_u8()
        h["unique_id"] = reader.read_u8()
        h["port_type"] = reader.read_u8()

    ct = conn.corner_table
    decoded: list[DecodedAttribute] = []
    parent_candidates: dict[AttributeType, DecodedAttribute] = {}
    # seam views + traversal sequences depend only on the connectivity
    # section — cache them on the conn result so a shared-topology group
    # (BatchDecoder) computes them once, not once per blob
    cache = getattr(conn, "_att_view_cache", None)
    if cache is None:
        cache = conn._att_view_cache = {}
    for i, h in enumerate(headers):
        att_table_idx = (h["dec_id"] + 1) & 0xFF  # inverse of (i-1) wrap
        if h["traversal"] not in (0, 1):  # TraversalType wire ids
            raise DecodeError(
                f"unsupported attribute traversal {h['traversal']}")
        hit = cache.get((att_table_idx, h["traversal"]))
        if hit is not None:
            view, seq = hit
        else:
            if att_table_idx == 0 \
                    or att_table_idx - 1 >= len(conn.att_seams):
                view = _DecView(ct)
            else:
                seam = conn.att_seams[att_table_idx - 1]
                is_v_seam = np.zeros(ct.num_vertices, dtype=bool)
                seam_corners = np.nonzero(seam)[0]
                for c in seam_corners:
                    is_v_seam[ct.vertex(next_corner(int(c)))] = True
                    is_v_seam[ct.vertex(prev_corner(int(c)))] = True
                actv, alm, nav, _ = recompute_attribute_vertices(
                    ct, seam, is_v_seam)
                view = _DecView(ct, actv, alm, seam, nav)
            if h["traversal"] == 1:  # PredictionDegree (mod.rs:59-88)
                from ..shared.sequencer import (
                    compute_sequence_prediction_degree,
                )
                seq = compute_sequence_prediction_degree(
                    view, list(conn.seed_corners))
            else:
                seq = compute_sequence(view, list(conn.seed_corners))
            cache[(att_table_idx, h["traversal"])] = (view, seq)

        da = _decode_one(reader, h, view, conn, decoded,
                         att_idx=i, symbol_source=symbol_source,
                         collect_only=collect_only, sequence=seq,
                         normal_collector=normal_collector)
        decoded.append(da)
        if da is not None:
            parent_candidates[h["att_type"]] = da
    return decoded


def _decode_one(reader: ByteReader, h: dict, view: _DecView,
                conn: ConnectivityDecodeResult,
                decoded_so_far: list, att_idx: int = 0,
                symbol_source=None, collect_only: bool = False,
                sequence=None, normal_collector=None):
    scheme_id = reader.read_u8()
    xform_id = reader.read_u8()

    if sequence is None:
        if h.get("traversal") == 1:
            from ..shared.sequencer import compute_sequence_prediction_degree
            sequence = compute_sequence_prediction_degree(
                view, list(conn.seed_corners))
        else:
            sequence = compute_sequence(view, list(conn.seed_corners))
    num_values = len(sequence)

    rans_flag = reader.read_u8()
    if not rans_flag:
        raise DecodeError("non-rANS attribute payload not supported")

    # number of components *of the portabilized attribute*
    n = 2 if h["port_type"] == PORT_OCTAHEDRAL else h["num_components"]
    if symbol_source is not None:
        symbols = symbol_source(att_idx, num_values * n, n, reader)
        if symbols is not None:
            symbols = np.asarray(symbols).reshape(num_values, n)
    else:
        symbols = decode_symbols(num_values * n, n,
                                 reader).reshape(num_values, n)

    # --- metadata (ordering depends on prediction scheme,
    #     attribute_encoder.rs:362-382) ---
    xmeta = {}
    pred_meta = {}
    if scheme_id == PRED_NORMAL:
        _read_transform_meta(reader, xform_id, xmeta)
        pred_meta["flips"] = _read_normal_flips(reader, num_values)
    elif scheme_id == PRED_TEX_COORDS:
        pred_meta["orientations"] = _read_tex_orientations(reader)
        _read_transform_meta(reader, xform_id, xmeta)
    else:
        _read_transform_meta(reader, xform_id, xmeta)

    port_meta = _read_port_meta(reader, h["port_type"], n)
    if "max_q" in xmeta and h["port_type"] == PORT_OCTAHEDRAL \
            and xmeta["max_q"] != (1 << port_meta["bits"]) - 1:
        raise DecodeError(
            f"octahedral transform max {xmeta['max_q']} inconsistent with "
            f"portabilization depth {port_meta['bits']}")

    if collect_only and symbols is None:
        # stream-collection phase: the reader is positioned past this
        # attribute's full section; reconstruction happens in a later pass
        return None

    # --- reconstruct portabilized values along the traversal ---
    # parents are referenced through the decoded position attribute
    parents = []
    if scheme_id in (PRED_NORMAL, PRED_TEX_COORDS, PRED_PARALLELOGRAM,
                     PRED_DERIVATIVE):
        pos = next((d for d in decoded_so_far
                    if d.att_type == AttributeType.POSITION), None)
        if pos is not None:
            parents = [_CornerIndexedParent(pos)]

    flips = pred_meta.get("flips")
    orientations = pred_meta.get("orientations")

    values_by_vertex = None
    if scheme_id in (PRED_DELTA, PRED_PARALLELOGRAM) and xform_id in (0, 1):
        # native sequential decode chain (falls back below when unavailable)
        from ..native import topo
        arrays = view.as_arrays()
        values_by_vertex = topo.decode_pred_transform(
            arrays[0], arrays[1], arrays[2], np.asarray(sequence),
            symbols.astype(np.uint64),
            1 if scheme_id == PRED_PARALLELOGRAM else 0, xform_id,
            xmeta.get("min", 0), xmeta.get("max", 0), view.num_vertices)

    _mxq = int(xmeta.get("max_q", 255))
    if (values_by_vertex is None and normal_collector is not None
            and scheme_id == PRED_NORMAL and parents and flips is not None
            and xform_id == XFORM_OCT_ORTHOGONAL and symbols is not None
            and h["port_type"] == PORT_OCTAHEDRAL
            # the batched chain derives bits from max_q, so only the
            # faithful 2^k - 1 shape may defer; foreign/crafted streams
            # with other maxima keep the host chain (which honors the
            # wire value exactly)
            and _mxq >= 3 and _mxq == (1 << _mxq.bit_length()) - 1):
        # phased batch decode: hand the chain inputs to the caller and
        # return the attribute with values to be filled after the batched
        # device pass (decode_attributes docstring)
        actv = (view.actv if view.actv is not None
                else np.asarray(view.ct.corner_to_vertex))
        da = DecodedAttribute(
            h["att_type"], AttributeDomain(h["domain"]),
            h["component_type"], h["num_components"], h["unique_id"],
            None, np.asarray(actv), quantized_by_vertex=None)
        normal_collector(att_idx, da, {
            "symbols": symbols, "flips": flips,
            "max_q": xmeta.get("max_q", 255), "h": h,
            "port_meta": port_meta, "view": view, "sequence": sequence,
            "pos": parents[0]})
        return da

    if (values_by_vertex is None and scheme_id == PRED_NORMAL and parents
            and flips is not None and xform_id in (
                XFORM_OCT_ORTHOGONAL, XFORM_OCT_REFLECTION,
                XFORM_ORTHOGONAL)):
        values_by_vertex = _decode_normals_vectorized(
            view, sequence, symbols, flips, parents[0],
            xmeta.get("max_q", 255), xform_id=xform_id)

    if (values_by_vertex is None and scheme_id == PRED_TEX_COORDS
            and parents and orientations is not None
            and xform_id == XFORM_WRAPPED_DIFFERENCE):
        # native sequential UV chain (prediction reads previously decoded
        # values, so this stays a per-step recurrence — in C++)
        from ..native import topo as _ntopo
        arrays = view.as_arrays()
        da = parents[0].da
        pos_by_corner = np.asarray(da.quantized_by_vertex, dtype=np.int64)[
            np.asarray(da.vertex_of_corner, dtype=np.int64)]
        values_by_vertex = _ntopo.decode_texcoords(
            arrays[0], arrays[1], arrays[2], np.asarray(sequence),
            symbols.astype(np.uint64), orientations, pos_by_corner,
            xmeta["min"], xmeta["max"], view.num_vertices)

    if values_by_vertex is None:
        pred = make_prediction(scheme_id, view, parents, n,
                               normal_bits=port_meta.get("bits", 8))
        state = PredictionState(view.num_vertices)
        values_by_vertex = np.zeros((view.num_vertices, n), dtype=np.int64)

        def att_get(c_point: int) -> np.ndarray:
            v = view.vertex(c_point)
            return values_by_vertex[v]

        if orientations is not None:
            pred.pending_orientations = list(orientations)
        inv = _make_inverse_transform(xform_id, xmeta)

        for k, c in enumerate(sequence):
            if flips is not None:
                pred.pending_flip = bool(flips[k])
            p = pred.predict(c, state, att_get)
            v = view.vertex(c)
            state.push(v)
            values_by_vertex[v] = inv(symbols[k].astype(np.int64),
                                      p.astype(np.int64))

    # --- dequantize ---
    out_vals = _deportabilize(values_by_vertex, h, port_meta)

    actv = (view.actv if view.actv is not None
            else np.asarray(view.ct.corner_to_vertex))
    return DecodedAttribute(
        h["att_type"], AttributeDomain(h["domain"]), h["component_type"],
        h["num_components"], h["unique_id"], out_vals, np.asarray(actv),
        quantized_by_vertex=values_by_vertex)


class _CornerIndexedParent:
    """Adapter exposing a decoded attribute through the encoder-side parent
    interface (value_at_point / num_points with point == corner)."""

    def __init__(self, da: DecodedAttribute) -> None:
        self.da = da
        self.num_points = len(da.vertex_of_corner)

    def value_at_point(self, c: int) -> np.ndarray:
        return self.da.quantized_by_vertex[self.da.vertex_of_corner[c]]

    @property
    def att_type(self):
        return self.da.att_type


def _decode_normals_vectorized(view, sequence, symbols, flips,
                               pos_parent, max_q: int = 255,
                               xform_id: int = XFORM_OCT_ORTHOGONAL
                               ) -> np.ndarray:
    """Whole-traversal normal decode: batched ring-sum prediction (the ring
    is traversal-state-independent) + batched inverse transform for all
    three octahedral transforms (OctOrthogonal mod-residual; OctReflection
    zigzag, no rotation; Orthogonal zigzag with the full D4 swap).
    Bit-identical to the scalar loop (pinned by round-trip tests); the
    scalar path remains for other transform combinations."""
    from ..shared.octahedral import invert_diamond, invert_diamond_inverse_batched
    from ..shared.prediction import NormalPrediction

    T = len(sequence)
    bits = int(max_q).bit_length()  # max_q == 2^bits - 1
    preds = NormalPrediction.predict_sequence(view, sequence, pos_parent,
                                              bits=bits)
    fl = np.asarray(flips[:T], dtype=bool)
    preds = np.where(fl[:, None], -preds, preds)
    corr = np.asarray(symbols[:T], dtype=np.int64)

    one = max_q // 2
    p = preds - one
    flip = np.abs(p).sum(axis=1) > one
    p = np.where(flip[:, None], invert_diamond(p, one), p)

    if xform_id == XFORM_OCT_REFLECTION:
        o = p + unzigzag(corr.astype(np.uint64))
        o = np.where(flip[:, None],
                     invert_diamond_inverse_batched(o, one), o)
        vals = o + one
        _opp, ctv, _lm = view.as_arrays()
        vbv = np.zeros((view.num_vertices, 2), dtype=np.int64)
        vbv[ctv[np.asarray(sequence, dtype=np.int64)]] = vals
        return vbv

    # rotation count: smallest r in 0..3 with rot^r(p) in the third
    # quadrant (x < 0, y <= 0); zero vectors don't rotate
    rots = [p]
    for _ in range(3):
        q = rots[-1]
        rots.append(np.stack([-q[:, 1], q[:, 0]], axis=1))
    rots = np.stack(rots)                                  # (4, T, 2)
    in_q3 = (rots[..., 0] < 0) & (rots[..., 1] <= 0)
    r = np.where(p.any(axis=1), np.argmax(in_q3, axis=0), 0)
    idx = np.arange(T)
    p_rot = rots[r, idx]

    if xform_id == XFORM_ORTHOGONAL:
        # diagonal reflection into |p0| >= |p1|, then exact zigzag residual
        swap = p_rot[:, 0] > p_rot[:, 1]
        p_rot = np.where(swap[:, None], p_rot[:, ::-1], p_rot)
        o = p_rot + unzigzag(corr.astype(np.uint64))
        o = np.where(swap[:, None], o[:, ::-1], o)
    else:
        o = ((p_rot + corr + one) % max_q) - one
    # undo rotations (inverse rot (x,y)->(y,-x) applied r times)
    outs = [o]
    for _ in range(3):
        q = outs[-1]
        outs.append(np.stack([q[:, 1], -q[:, 0]], axis=1))
    o = np.stack(outs)[r, idx]
    o = np.where(flip[:, None],
                 invert_diamond_inverse_batched(o, one), o)
    vals = o + one

    _opp, ctv, _lm = view.as_arrays()
    vbv = np.zeros((view.num_vertices, 2), dtype=np.int64)
    vbv[ctv[np.asarray(sequence, dtype=np.int64)]] = vals
    return vbv


def _read_transform_meta(reader, xform_id, out: dict) -> None:
    if xform_id == XFORM_WRAPPED_DIFFERENCE:
        vmin = reader.read_u32()
        vmax = reader.read_u32()
        out["min"] = vmin - (1 << 32) if vmin >= (1 << 31) else vmin
        out["max"] = vmax - (1 << 32) if vmax >= (1 << 31) else vmax
    elif xform_id in (XFORM_OCT_ORTHOGONAL, XFORM_OCT_REFLECTION,
                      XFORM_ORTHOGONAL):
        out["max_q"] = reader.read_u32()
        out["center"] = reader.read_u32()
    elif xform_id in (XFORM_DIFFERENCE, XFORM_NONE):
        pass
    else:
        raise DecodeError(f"unsupported transform {xform_id}")


def _read_normal_flips(reader, count: int) -> list[bool]:
    """Flips were RAbS-coded in forward order (mesh_normal_prediction.rs:
    147-164), so decoding yields them reversed."""
    prob_zero = reader.read_u8()
    size = leb128_read(reader)
    blob = reader.read_bytes(size)
    dec = RabsDecoder(ByteReader(blob), len(blob), prob_zero)
    bits = dec.read_all(count)
    return [bool(b) for b in bits[::-1]]


def _read_tex_orientations(reader) -> list[bool]:
    """u32 count + RAbS delta bits anchored at the stream end
    (mesh_prediction_for_texture_coordinates.rs:221-260)."""
    count = reader.read_u32()
    prob_zero = reader.read_u8()
    size = leb128_read(reader)
    blob = reader.read_bytes(size)
    if count > max(len(blob), 1) << 12:
        # corrupt u32 counts must not bomb the allocator (RAbS carries
        # far fewer than 2^16 bits per stream byte even at prob 255/256)
        raise ValueError("corrupt orientation count exceeds stream size")
    dec = RabsDecoder(ByteReader(blob), len(blob), prob_zero)
    bits = dec.read_all(count)
    last = True
    rev = []
    for b in bits.tolist():
        if b == 0:
            last = not last
        rev.append(last)
    return list(reversed(rev))


def _read_port_meta(reader, port_type: int, n: int) -> dict:
    if port_type == PORT_QUANTIZATION:
        mins = np.array([reader.read_f32() for _ in range(n)], dtype=np.float32)
        delta_max = np.float32(reader.read_f32())
        bits = reader.read_u8()
        if not 1 <= bits <= 31:
            raise DecodeError(f"invalid quantization bits {bits}")
        return {"mins": mins, "delta_max": delta_max, "bits": bits}
    if port_type == PORT_OCTAHEDRAL:
        bits = reader.read_u8()
        if not 7 <= bits <= 16:  # mirror the encoder's accepted range
            raise DecodeError(f"invalid octahedral bits {bits}")
        return {"bits": bits}
    if port_type == PORT_TO_BITS:
        return {}
    raise DecodeError(f"unsupported portabilization {port_type}")


def _make_inverse_transform(xform_id: int, meta: dict):
    if xform_id == XFORM_DIFFERENCE:
        def inv(corr, pred):
            return pred + unzigzag(corr.astype(np.uint64))
        return inv
    if xform_id == XFORM_NONE:
        def inv(corr, pred):
            return corr
        return inv
    if xform_id == XFORM_WRAPPED_DIFFERENCE:
        vmin, vmax = meta["min"], meta["max"]
        max_diff = 1 + vmax - vmin

        def inv(corr, pred):
            pred_c = np.clip(pred, vmin, vmax)
            t = pred_c + unzigzag(corr.astype(np.uint64))
            t = np.where(t > vmax, t - max_diff,
                         np.where(t < vmin, t + max_diff, t))
            return t
        return inv
    if xform_id == XFORM_OCT_ORTHOGONAL:
        from ..shared.octahedral import invert_diamond, invert_diamond_inverse

        mx = meta.get("max_q", 255)

        def inv(corr, pred):
            one = mx // 2
            p = pred.astype(np.int64) - one
            # replicate the encoder's forward canonicalization of pred
            flip = abs(int(p[0])) + abs(int(p[1])) > one
            if flip:
                p = invert_diamond(p, one)
            rot = 0
            if p.any():
                while p[0] >= 0 or p[1] > 0:
                    p = np.array([-p[1], p[0]], dtype=np.int64)
                    rot += 1
            # o' == p' + corr (mod max), canonicalized into [-center, center]
            o = ((p + corr + one) % mx) - one
            # undo rotations (inverse of (x,y)->(-y,x) is (x,y)->(y,-x))
            for _ in range(rot):
                o = np.array([o[1], -o[0]], dtype=np.int64)
            if flip:
                o = invert_diamond_inverse(o, one)
            return o + one
        return inv
    if xform_id == XFORM_OCT_REFLECTION:
        from ..shared.octahedral import invert_diamond, invert_diamond_inverse

        mx = meta.get("max_q", 255)

        def inv(corr, pred):
            one = mx // 2
            p = pred.astype(np.int64) - one
            flip = abs(int(p[0])) + abs(int(p[1])) > one
            if flip:
                p = invert_diamond(p, one)
            o = p + unzigzag(corr.astype(np.uint64))
            if flip:
                o = invert_diamond_inverse(o, one)
            return o + one
        return inv
    if xform_id == XFORM_ORTHOGONAL:
        from ..shared.octahedral import invert_diamond, invert_diamond_inverse

        mx = meta.get("max_q", 255)

        def inv(corr, pred):
            one = mx // 2
            p = pred.astype(np.int64) - one
            # replicate the encoder's D4 canonicalization of pred
            # (encode/transforms.py OrthogonalTransform)
            flip = abs(int(p[0])) + abs(int(p[1])) > one
            if flip:
                p = invert_diamond(p, one)
            rot = 0
            if p.any():
                while p[0] >= 0 or p[1] > 0:
                    p = np.array([-p[1], p[0]], dtype=np.int64)
                    rot += 1
            swap = p[0] > p[1]
            if swap:
                p = p[::-1]
            o = p + unzigzag(corr.astype(np.uint64))
            if swap:
                o = o[::-1]
            for _ in range(rot):
                o = np.array([o[1], -o[0]], dtype=np.int64)
            if flip:
                o = invert_diamond_inverse(o, one)
            return o + one
        return inv
    raise DecodeError(f"unsupported transform {xform_id}")


def _deportabilize(values: np.ndarray, h: dict, meta: dict) -> np.ndarray:
    port_type = h["port_type"]
    if port_type == PORT_TO_BITS:
        return values.astype(ComponentType(h["component_type"]).np_dtype)
    if port_type == PORT_QUANTIZATION:
        bits = meta["bits"]
        scale = np.float32(meta["delta_max"]) / np.float32((1 << bits) - 1)
        vals = (values.astype(np.float32) * scale + meta["mins"]).astype(np.float32)
        return vals.astype(ComponentType(h["component_type"]).np_dtype)
    if port_type == PORT_OCTAHEDRAL:
        scale = np.float32((1 << (meta["bits"] - 1)) - 1)
        uv = (values.astype(np.float32) / scale - np.float32(1.0)).astype(np.float32)
        return octahedral_inverse_transform(uv).astype(
            ComponentType(h["component_type"]).np_dtype)
    raise DecodeError(f"unsupported portabilization {port_type}")

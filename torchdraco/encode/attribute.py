"""Attribute encoding: header, then per attribute
portabilize -> traverse -> predict -> transform -> rANS.

Reference behavior: draco-oxide/src/encode/attribute/mod.rs:13-93 (dispatch +
headers) and attribute_encoder.rs:138-390 (pipeline; metadata ordering
quirks :362-382).
"""

from __future__ import annotations

import numpy as np

from ..entropy.symbol_coding import DIRECT_CODED, LENGTH_CODED, encode_symbols
from ..models.attribute import Attribute, AttributeType
from ..models.corner_table import TableView
from ..shared.clers import TRAVERSAL_DEPTH_FIRST, TRAVERSAL_PREDICTION_DEGREE
from ..shared.prediction import (
    PRED_DELTA, PRED_DERIVATIVE, PRED_MULTI_PARALLELOGRAM, PRED_NORMAL,
    PRED_PARALLELOGRAM, PRED_TEX_COORDS, PredictionState, make_prediction,
)
from ..shared.sequencer import (
    compute_sequence, compute_sequence_prediction_degree,
)
from .connectivity import ConnectivityOutput
from .portabilization import default_portabilization_for, portabilize
from .transforms import (
    XFORM_DIFFERENCE, XFORM_OCT_ORTHOGONAL, XFORM_OCT_REFLECTION,
    XFORM_ORTHOGONAL, XFORM_WRAPPED_DIFFERENCE, make_transform,
)


def default_prediction_for(att_type: AttributeType,
                           prediction: dict | None = None,
                           transform: dict | None = None) -> tuple[int, int]:
    """(prediction scheme, transform) defaults
    (attribute_encoder.rs:59-108). ``prediction`` optionally overrides the
    scheme per AttributeType (Config.prediction); ``transform`` optionally
    overrides the residual transform per AttributeType (Config.transform) —
    only octahedral transforms may substitute for NORMAL (the only type
    whose portabilization yields the 2-component oct domain they expect)."""
    if att_type == AttributeType.POSITION:
        out = PRED_PARALLELOGRAM, XFORM_WRAPPED_DIFFERENCE
    elif att_type == AttributeType.NORMAL:
        out = PRED_NORMAL, XFORM_OCT_ORTHOGONAL
    elif att_type == AttributeType.TEX_COORD:
        out = PRED_TEX_COORDS, XFORM_WRAPPED_DIFFERENCE
    elif att_type == AttributeType.CUSTOM:
        out = PRED_PARALLELOGRAM, XFORM_WRAPPED_DIFFERENCE
    else:
        out = PRED_DELTA, XFORM_DIFFERENCE
    if prediction and att_type in prediction:
        scheme = int(prediction[att_type])
        allowed = (PRED_DELTA, PRED_PARALLELOGRAM,
                   PRED_MULTI_PARALLELOGRAM)
        if att_type == AttributeType.TEX_COORD:
            # Derivative (wire id 7) predicts UVs from the position
            # parent — a working opt-in where the reference ships only
            # unimplemented!() dead code (derivative_prediction.rs)
            allowed = allowed + (PRED_DERIVATIVE,)
        if scheme not in allowed:
            raise ValueError(
                f"prediction override {scheme} not supported for "
                f"{att_type.name}; pick one of {allowed}")
        out = (scheme, out[1])
    if transform and att_type in transform:
        xf = int(transform[att_type])
        if att_type != AttributeType.NORMAL or xf not in (
                XFORM_OCT_ORTHOGONAL, XFORM_OCT_REFLECTION,
                XFORM_ORTHOGONAL):
            raise ValueError(
                f"transform override {xf} not supported for "
                f"{att_type.name}; NORMAL accepts OctOrthogonal (3), "
                "OctReflection (2), or Orthogonal (4)")
        out = (out[0], xf)
    return out


# batched normal/texcoord prediction (bit-identical to the scalar loops);
# the flag exists so byte-equality tests can force the scalar path
VECTORIZED_PREDICTIONS = True


def carries_port(entry: dict | None, att: Attribute,
                 named: set[int]) -> bool:
    """Whether the precomputed ``entry`` of ``att`` carries its
    portabilization for ``_encode_one`` to emit as it stands: the bytes
    (``port_meta``), and its values (``port_values``) wherever an attribute
    reads them as a parent (``named``: the ids the mesh's attributes name
    as parents). Otherwise ``portabilize`` runs."""
    return entry is not None and "port_meta" in entry and (
        "port_values" in entry or att.att_id not in named)


def encode_attributes(attributes: list[Attribute], writer,
                      conn_out: ConnectivityOutput, recorder=None,
                      sequences: dict | None = None,
                      precomputed: dict | None = None,
                      quant_bits: dict | None = None,
                      symbol_coding: str = "direct",
                      prediction: dict | None = None,
                      transform: dict | None = None,
                      pred_cache: dict | None = None,
                      attribute_traversal: int = TRAVERSAL_DEPTH_FIRST
                      ) -> None:
    """``precomputed`` optionally maps attribute index -> {"payload": bytes
    (the encode_symbols output, computed on the accelerator),
    "xform_meta": bytes} to skip the host predict/transform/entropy stages
    for that attribute (device batch path; bit-exactness pinned by
    tests/test_parallel.py); an entry may also carry the attribute's
    portabilization (``carries_port``). ``attribute_traversal`` is the wire
    TraversalType (mod.rs:59-88) every attribute is sequenced with."""
    from ..eval import NULL
    if attribute_traversal not in (TRAVERSAL_DEPTH_FIRST,
                                   TRAVERSAL_PREDICTION_DEGREE):
        raise ValueError(
            f"unsupported attribute traversal {attribute_traversal}")
    if attribute_traversal != TRAVERSAL_DEPTH_FIRST:
        # cached sequences/gathers are depth-first artifacts — recompute
        sequences = None
        precomputed = None
        pred_cache = None
    rec = recorder if recorder is not None else NULL
    rec.write_pair("attributes count", len(attributes))
    writer.write_u8(len(attributes))
    for i, att in enumerate(attributes):
        # decoder id: (i-1) wrapping, so position (index 0) gets 0xFF
        # meaning "universal corner table" (encode/attribute/mod.rs:33)
        writer.write_u8((i - 1) & 0xFF)
        writer.write_u8(att.domain)
        writer.write_u8(attribute_traversal)

    for att in attributes:
        writer.write_u8(1)  # one attribute per decoder
        writer.write_u8(att.att_type)
        writer.write_u8(att.component_type)
        writer.write_u8(att.num_components)
        writer.write_u8(0)  # normalized flag
        uid = att.unique_id if att.unique_id is not None else att.att_id
        writer.write_u8(uid & 0xFF)
        port_type, _bits = default_portabilization_for(att.att_type,
                                                       quant_bits)
        writer.write_u8(port_type)

    named = {p for att in attributes for p in att.parents}
    port_atts: dict[int, Attribute] = {}
    for i, att in enumerate(attributes):
        parents = [port_atts[pid] for pid in att.parents]
        if precomputed is None or i not in precomputed:
            # the batch plane hands back uint16 port values (its upload
            # buffer, returned as-is to avoid a full-batch int32 copy);
            # host prediction arithmetic on a PARENT would wrap in
            # uint16, so widen lazily — only when a non-precomputed
            # child actually reads them
            from .portabilization import _clone_with_values
            for k, p in enumerate(parents):
                if p.values.dtype == np.uint16:
                    p = _clone_with_values(p, p.values.astype(np.int32))
                    port_atts[att.parents[k]] = p
                    parents[k] = p
        rec.scope_begin(f"attribute {i} ({att.att_type.name})", writer)
        seq = sequences.get(i) if sequences else None
        pre = precomputed.get(i) if precomputed else None
        if pre is not None and not carries_port(pre, att, named):
            pre = {k: v for k, v in pre.items()
                   if k not in ("port_meta", "port_values")}
        port_att = _encode_one(att, i, parents, conn_out, writer, rec,
                               sequence=seq, precomputed=pre,
                               quant_bits=quant_bits,
                               symbol_coding=symbol_coding,
                               prediction=prediction,
                               transform=transform,
                               pred_cache=pred_cache,
                               attribute_traversal=attribute_traversal)
        rec.write_pair("num_values", int(att.num_points))
        rec.write_pair("num_unique_values", int(att.num_unique_values))
        rec.scope_end(writer)
        port_atts[att.att_id] = port_att


def _pick_symbol_method(flat_symbols, symbol_coding: str) -> int:
    """Symbol-coding selection. The reference hardcodes DirectCoded
    (attribute_encoder.rs:344-351), whose serialized frequency table grows
    with the alphabet — and its zero-run coding degrades to one byte per
    zero for runs > 64 (rans.rs:203-210 loop quirk), so sparse wide
    alphabets are doubly punished. "auto" switches to LengthCoded when the
    alphabet is wide (>= 2^11) or would dominate the payload (max symbol
    exceeding ~2x the stream length means mostly-empty table entries).
    "direct" (default) matches the reference byte-for-byte; the decoder
    dispatches on the stream's own method byte either way."""
    if symbol_coding == "direct":
        return DIRECT_CODED
    if symbol_coding == "length":
        return LENGTH_CODED
    max_symbol = int(flat_symbols.max()) if len(flat_symbols) else 0
    if max_symbol >= (1 << 11) or max_symbol > 2 * len(flat_symbols):
        return LENGTH_CODED
    return DIRECT_CODED


def _encode_one(att: Attribute, att_data_id: int, parents: list[Attribute],
                conn_out: ConnectivityOutput, writer, rec=None,
                sequence=None, precomputed=None,
                quant_bits=None, symbol_coding: str = "direct",
                prediction: dict | None = None,
                transform: dict | None = None,
                pred_cache: dict | None = None,
                attribute_traversal: int = TRAVERSAL_DEPTH_FIRST
                ) -> Attribute | None:
    """Writes ``att``; returns its portabilized twin, which a child
    attribute reads as a parent, or None where ``precomputed`` carries
    ``port_meta`` without ``port_values`` (``carries_port``)."""
    from ..eval import NULL
    if rec is None:
        rec = NULL
    scheme_id, xform_id = default_prediction_for(att.att_type, prediction,
                                                 transform)
    rec.write_pair("prediction_scheme", scheme_id)
    rec.write_pair("prediction_transform", xform_id)
    writer.write_u8(scheme_id)
    writer.write_u8(xform_id)

    aict = conn_out.corner_table
    att_table = None
    if att_data_id > 0 and att_data_id - 1 < len(aict.attribute_tables):
        att_table = aict.attribute_tables[att_data_id - 1]
    view = TableView(aict.corner_table, att_table)

    if sequence is None:
        seeds = list(conn_out.corners_of_edgebreaker)
        if attribute_traversal == TRAVERSAL_PREDICTION_DEGREE:
            sequence = compute_sequence_prediction_degree(view, seeds)
        else:
            sequence = compute_sequence(view, seeds)

    # portabilize (writes quantization metadata into a side buffer)
    port_type, bits = default_portabilization_for(att.att_type, quant_bits)
    if precomputed is not None and "port_meta" in precomputed:
        # the batch plane already portabilized this attribute (positions
        # and UVs quantized across the whole group on host, normals on
        # the device) — emit its metadata bytes and skip the per-mesh
        # re-quantization, the dominant assembly cost
        from .portabilization import _clone_with_values
        writer.write_u8(1)  # rans_encoding flag
        writer.write_bytes(precomputed["payload"])
        writer.write_bytes(precomputed["xform_meta"])
        writer.write_bytes(precomputed["port_meta"])
        values = precomputed.get("port_values")
        return None if values is None else _clone_with_values(att, values)
    port_buf = _Buf()
    port_att = portabilize(att, port_type, bits, port_buf)

    if precomputed is not None:
        # accelerator already produced the symbol payload + transform
        # metadata; emit them verbatim (byte-identical to the host path)
        writer.write_u8(1)  # rans_encoding flag
        writer.write_bytes(precomputed["payload"])
        writer.write_bytes(precomputed["xform_meta"])
        writer.write_bytes(port_buf.buf)
        return port_att

    # predict + record traversal. Parallelogram and delta predictions are
    # pure gathers on the encoder side and run vectorized; normal/texcoord
    # keep the reference per-vertex loop (value-dependent decisions).
    n = port_att.num_components
    if (scheme_id == PRED_PARALLELOGRAM
            and xform_id == XFORM_WRAPPED_DIFFERENCE and len(sequence)
            and VECTORIZED_PREDICTIONS):
        # native fused step (predict + wrap + zigzag in one C pass);
        # falls through to the numpy twin without a toolchain. The wire
        # bytes are identical (equality pinned by tests + golden pins).
        fused = _fused_predict_squeeze(view, sequence, port_att,
                                       cache=pred_cache,
                                       cache_key=att_data_id)
        if fused is not None:
            symbols, vmin, vmax = fused
            writer.write_u8(1)  # rans_encoding flag
            method = _pick_symbol_method(symbols.ravel(), symbol_coding)
            encode_symbols(symbols.ravel(), n, method, writer)
            xbuf = _Buf()
            xbuf.write_u32(vmin & 0xFFFFFFFF)
            xbuf.write_u32(vmax & 0xFFFFFFFF)
            writer.write_bytes(xbuf.buf)
            writer.write_bytes(port_buf.buf)
            return port_att
    pred = make_prediction(scheme_id, view, parents, n, normal_bits=bits)
    state = PredictionState(view.num_vertices)
    per_point = port_att.values[port_att.unique_indices()].astype(np.int64)

    if scheme_id in (PRED_PARALLELOGRAM, PRED_DELTA) and len(sequence):
        origs, preds = _vectorized_predict(
            scheme_id, view, sequence, port_att, per_point,
            cache=pred_cache, cache_key=att_data_id)
    elif (scheme_id == PRED_MULTI_PARALLELOGRAM and len(sequence)
          and VECTORIZED_PREDICTIONS):
        # the swing-right rings are static walks; visited checks reduce to
        # first-occurrence masks -> fully batched on the encoder
        from ..shared.prediction import MultiParallelogramPrediction
        preds = MultiParallelogramPrediction.predict_sequence(
            view, sequence, per_point)
        seq_arr = np.asarray(sequence, dtype=np.int64)
        pts = np.asarray(view.u.faces_points, dtype=np.int64).ravel()[seq_arr]
        origs = per_point[pts]
    elif scheme_id == PRED_NORMAL and len(sequence) and VECTORIZED_PREDICTIONS:
        # ring sums are traversal-state-independent -> fully batched
        from ..shared.prediction import NormalPrediction
        preds = NormalPrediction.predict_sequence(view, sequence, parents[0],
                                                  bits=bits)
        seq_arr = np.asarray(sequence, dtype=np.int64)
        pts = np.asarray(view.u.faces_points, dtype=np.int64).ravel()[seq_arr]
        origs = per_point[pts]
        d1 = preds - origs
        d2 = -preds - origs
        flips = np.einsum("ij,ij->i", d1, d1) > np.einsum("ij,ij->i", d2, d2)
        preds = np.where(flips[:, None], -preds, preds)
        pred.flips = [bool(f) for f in flips]
    elif (scheme_id == PRED_TEX_COORDS and len(sequence)
          and VECTORIZED_PREDICTIONS):
        # visited-state checks reduce to first-occurrence masks on the
        # encoder, so the UV prediction runs fully batched
        from ..shared.prediction import TexCoordPrediction
        preds, orients = TexCoordPrediction.predict_sequence(
            view, sequence, parents[0], per_point)
        seq_arr = np.asarray(sequence, dtype=np.int64)
        pts = np.asarray(view.u.faces_points, dtype=np.int64).ravel()[seq_arr]
        origs = per_point[pts]
        pred.orientations = [bool(o) for o in orients]
    else:
        def att_get(p: int) -> np.ndarray:
            return per_point[p]

        origs = np.empty((len(sequence), n), dtype=np.int64)
        preds = np.empty((len(sequence), n), dtype=np.int64)
        for k, c in enumerate(sequence):
            preds[k] = pred.predict(c, state, att_get)
            state.push(view.vertex(c))
            origs[k] = per_point[view.point(c)]

    xform = make_transform(xform_id, normal_bits=bits)
    xbuf = _Buf()
    symbols = xform.squeeze(origs, preds, xbuf)

    writer.write_u8(1)  # rans_encoding flag
    flat = symbols.astype(np.uint64).ravel()
    method = _pick_symbol_method(flat, symbol_coding)
    encode_symbols(flat, n, method, writer)

    # metadata ordering is prediction-type-dependent for draco compatibility
    # (attribute_encoder.rs:362-382)
    if scheme_id == PRED_NORMAL:
        writer.write_bytes(xbuf.buf)
        pred.metadata_bytes(writer)
    elif scheme_id == PRED_TEX_COORDS:
        pred.metadata_bytes(writer)
        writer.write_bytes(xbuf.buf)
    else:
        writer.write_bytes(xbuf.buf)
    writer.write_bytes(port_buf.buf)
    return port_att


def _parallelogram_gather_cache(view, sequence, port_att,
                                cache: dict | None = None, cache_key=None):
    """Build (or fetch) the topology-pinned parallelogram gather dict:
    value indices for orig/next/prev/opp/fallback plus the predictability
    masks, in the dtypes the native fused step consumes directly."""
    from ..native import topo
    from ..ops.gathers import build_parallelogram_gathers

    g = cache.get(cache_key) if cache is not None else None
    if g is not None:
        return g
    seq = np.asarray(sequence, dtype=np.int64)
    eff_opp, ctv, lm = view.as_arrays()
    unique_of_point = port_att.unique_indices()
    point_of_corner = view.u.faces_points.ravel() \
        if hasattr(view, "u") else None
    val_of_corner = unique_of_point[point_of_corner]
    g = topo.parallelogram_gathers(eff_opp, ctv, lm, val_of_corner, seq)
    if g is None:
        g = build_parallelogram_gathers(view, seq.tolist(),
                                        unique_of_point)
    # augment with the other topology-pinned pieces so cache hits
    # skip every per-mesh index/mask build, not just the walk
    g = dict(g)
    g["origs_idx"] = unique_of_point[point_of_corner[seq]].astype(np.int32)
    g["can_para_b"] = np.asarray(g["can_para"], dtype=bool)[:, None]
    g["has_fb_b"] = np.asarray(g["has_fallback"], dtype=bool)[:, None]
    g["can_para_u8"] = np.ascontiguousarray(
        g["can_para_b"].ravel().view(np.uint8))
    g["has_fb_u8"] = np.ascontiguousarray(
        g["has_fb_b"].ravel().view(np.uint8))
    for k in ("next", "prev", "opp", "fallback"):
        g[k] = np.ascontiguousarray(g[k], dtype=np.int32)
    if cache is not None:
        cache[cache_key] = g
    return g


def _fused_predict_squeeze(view, sequence, port_att,
                           cache: dict | None = None, cache_key=None):
    """Native fused parallelogram + wrapped-difference + zigzag over the
    whole traversal (native/csrc/quantize.cpp::tdn_predict_wrapped_
    zigzag): one C pass instead of ~10 numpy passes per mesh. Returns
    (symbols uint64 (T, n), vmin, vmax) or None (no toolchain /
    unsupported dtype — callers run the numpy twin, which stays the
    VECTORIZED_PREDICTIONS off-switch twin as well)."""
    from ..native import predict_wrapped_zigzag

    vals = port_att.values
    if vals.dtype != np.int32 or vals.ndim != 2 or not vals.flags.c_contiguous:
        return None
    g = _parallelogram_gather_cache(view, sequence, port_att,
                                    cache=cache, cache_key=cache_key)
    return predict_wrapped_zigzag(vals, g["origs_idx"], g["next"],
                                  g["prev"], g["opp"], g["fallback"],
                                  g["can_para_u8"], g["has_fb_u8"])


def _vectorized_predict(scheme_id, view, sequence, port_att, per_point,
                        cache: dict | None = None, cache_key=None):
    """Vectorized parallelogram/delta prediction over the whole traversal
    (the gathers come from the native topology pass when available).
    ``cache`` (PreparedTopology.pred_gathers) memoizes the parallelogram
    gathers per attribute: they depend only on the topology, traversal
    sequence, and the value-dedup map, all pinned by the topology
    signature (parallel/batch.py:topology_signature)."""
    seq = np.asarray(sequence, dtype=np.int64)
    eff_opp, ctv, lm = view.as_arrays()
    unique_of_point = port_att.unique_indices()
    point_of_corner = view.u.faces_points.ravel() if hasattr(view, "u") else None
    vals = port_att.values.astype(np.int64)

    if scheme_id == PRED_DELTA:
        origs = vals[unique_of_point[point_of_corner[seq]]]
        preds = np.zeros_like(origs)
        if len(seq) > 1:
            prev_vs = ctv[seq[:-1]]
            fb_corners = lm[prev_vs]
            fb_idx = unique_of_point[point_of_corner[fb_corners]]
            preds[1:] = vals[fb_idx]
        return origs, preds

    g = _parallelogram_gather_cache(view, sequence, port_att,
                                    cache=cache, cache_key=cache_key)
    origs = vals[g["origs_idx"]]
    a = vals[g["next"]]
    b = vals[g["prev"]]
    d = vals[g["opp"]]
    fb = vals[g["fallback"]]
    para = a + b - d
    preds = np.where(g["can_para_b"], para, np.where(g["has_fb_b"], fb, 0))
    return origs, preds


class _Buf:
    def __init__(self) -> None:
        self.buf = bytearray()

    def write_u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def write_u32(self, v: int) -> None:
        self.buf += (v & 0xFFFFFFFF).to_bytes(4, "little")

    def write_f32(self, v: float) -> None:
        import struct
        self.buf += struct.pack("<f", v)

    def write_bytes(self, b) -> None:
        self.buf += b

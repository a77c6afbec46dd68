"""ctypes wrappers for the native topology passes (topology.cpp).

Every function returns None when the native library is unavailable; callers
fall back to the Python reference implementation.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import load_library

# raw addresses for c_void_p argument slots (data_as/cast is slow per
# call); callers keep the owning arrays alive — every site
# passes named locals or views of named locals
_i64p = lambda a: a.ctypes.data  # noqa: E731
_i32p = lambda a: a.ctypes.data  # noqa: E731
_u8p = lambda a: a.ctypes.data   # noqa: E731
_configured = False


def _lib():
    global _configured
    lib = load_library()
    if lib is None:
        return None
    if not _configured:
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        I64P = ctypes.c_void_p
        I32P = ctypes.c_void_p
        U8P = ctypes.c_void_p
        lib.tdn_compute_table.restype = None
        lib.tdn_compute_table.argtypes = [I64P, i64, i64, I64P]
        lib.tdn_has_non_manifold_edges.restype = i32
        lib.tdn_has_non_manifold_edges.argtypes = [I64P, i64]
        lib.tdn_break_non_manifold_edges.restype = None
        lib.tdn_break_non_manifold_edges.argtypes = [I64P, I64P, i64]
        lib.tdn_left_most.restype = i64
        lib.tdn_left_most.argtypes = [I64P, I64P, i64, i64, I64P, I64P, I64P]
        lib.tdn_sequence.restype = i64
        lib.tdn_sequence.argtypes = [I64P, I64P, I64P, i64, i64, I64P, i64, I64P]
        lib.tdn_parallelogram_gathers.restype = None
        lib.tdn_parallelogram_gathers.argtypes = [
            I64P, I64P, I64P, I64P, I64P, i64, i64,
            I32P, I32P, I32P, I32P, I32P, U8P, U8P]
        lib.tdn_edgebreaker.restype = i32
        lib.tdn_edgebreaker.argtypes = [
            I64P, I64P, i64, i64, U8P, I64P, I64P, U8P, I64P, I64P, I64P,
            I64P, I64P, I64P, I64P]
        U64P = ctypes.c_void_p
        lib.tdn_decode_pred_transform.restype = i32
        lib.tdn_decode_pred_transform.argtypes = [
            I64P, I64P, I64P, I64P, i64, U64P, i32, i32, i32, i64, i64,
            i64, I64P]
        lib.tdn_crlight_decode.restype = i32
        lib.tdn_crlight_decode.argtypes = [U8P, i64, i64, I32P]
        lib.tdn_decode_texcoords.restype = i32
        lib.tdn_decode_texcoords.argtypes = [
            I64P, I64P, I64P, I64P, i64, U64P, U8P, i64, I64P, i64,
            i64, i64, i64, I64P]
        lib.tdn_recompute_attribute_vertices.restype = i64
        lib.tdn_recompute_attribute_vertices.argtypes = [
            I64P, I64P, I64P, U8P, U8P, I64P, i32, i64, i64,
            I64P, I64P, I64P]
        lib.tdn_spirale.restype = i64
        lib.tdn_spirale.argtypes = [
            I32P, i64, i64, i64, i64, I64P, I64P, I64P, i64,
            I64P, I64P, I64P, I64P, I64P, I64P, I64P, I64P]
        lib.tdn_spirale_valence.restype = i64
        lib.tdn_spirale_valence.argtypes = [
            I32P, I64P, i64, i64, i64, i64, I64P, I64P, I64P, i64,
            I64P, I64P, I64P, I64P, I64P, I64P, I64P, I64P]
        lib.tdn_spirale_contexts.restype = i64
        lib.tdn_spirale_contexts.argtypes = [
            I32P, I32P, i64, i64, i64, i64, I64P, I64P, I64P, i64,
            I64P, I64P, I64P, I64P, I64P, I64P, I64P, I64P]
        _configured = True
    return lib


def compute_table(ctv: np.ndarray, num_vertices: int) -> np.ndarray | None:
    lib = _lib()
    if lib is None:
        return None
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    opposite = np.full(len(ctv), -1, dtype=np.int64)
    lib.tdn_compute_table(_i64p(ctv), len(ctv), num_vertices, _i64p(opposite))
    return opposite


def has_non_manifold_edges(ctv: np.ndarray) -> bool | None:
    lib = _lib()
    if lib is None:
        return None
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    return bool(lib.tdn_has_non_manifold_edges(_i64p(ctv), len(ctv)))


def break_non_manifold_edges(opposite: np.ndarray, ctv: np.ndarray) -> bool:
    lib = _lib()
    if lib is None:
        return False
    assert opposite.dtype == np.int64 and opposite.flags.c_contiguous
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    lib.tdn_break_non_manifold_edges(_i64p(opposite), _i64p(ctv), len(ctv))
    return True


def left_most(ctv: np.ndarray, opposite: np.ndarray, num_vertices: int):
    lib = _lib()
    if lib is None:
        return None
    assert ctv.dtype == np.int64 and ctv.flags.c_contiguous
    opposite = np.ascontiguousarray(opposite, dtype=np.int64)
    C = len(ctv)
    lm = np.empty(num_vertices + C, dtype=np.int64)
    parents = np.empty(C, dtype=np.int64)
    n_par = np.zeros(1, dtype=np.int64)
    new_v = lib.tdn_left_most(_i64p(ctv), _i64p(opposite), C, num_vertices,
                               _i64p(lm), _i64p(parents), _i64p(n_par))
    return int(new_v), lm[:new_v], parents[:int(n_par[0])].tolist()


def sequence(opposite_eff: np.ndarray, ctv: np.ndarray, lm: np.ndarray,
             init_stack) -> np.ndarray | None:
    lib = _lib()
    if lib is None:
        return None
    opposite_eff = np.ascontiguousarray(opposite_eff, dtype=np.int64)
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    lm = np.ascontiguousarray(lm, dtype=np.int64)
    init = np.ascontiguousarray(init_stack, dtype=np.int64)
    out = np.empty(len(lm), dtype=np.int64)
    n = lib.tdn_sequence(_i64p(opposite_eff), _i64p(ctv), _i64p(lm),
                          len(ctv), len(lm), _i64p(init), len(init),
                          _i64p(out))
    return out[:n]


def parallelogram_gathers(opposite_eff, ctv, lm, val_of_corner, seq):
    lib = _lib()
    if lib is None:
        return None
    opposite_eff = np.ascontiguousarray(opposite_eff, dtype=np.int64)
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    lm = np.ascontiguousarray(lm, dtype=np.int64)
    voc = np.ascontiguousarray(val_of_corner, dtype=np.int64)
    seq = np.ascontiguousarray(seq, dtype=np.int64)
    T = len(seq)
    order = np.empty(T, dtype=np.int32)
    g_next = np.empty(T, dtype=np.int32)
    g_prev = np.empty(T, dtype=np.int32)
    g_opp = np.empty(T, dtype=np.int32)
    g_fb = np.empty(T, dtype=np.int32)
    can_para = np.empty(T, dtype=np.uint8)
    has_fb = np.empty(T, dtype=np.uint8)
    lib.tdn_parallelogram_gathers(
        _i64p(opposite_eff), _i64p(ctv), _i64p(lm), _i64p(voc), _i64p(seq),
        T, len(lm), _i32p(order), _i32p(g_next), _i32p(g_prev), _i32p(g_opp),
        _i32p(g_fb), _u8p(can_para), _u8p(has_fb))
    return {"order": order, "next": g_next, "prev": g_prev, "opp": g_opp,
            "fallback": g_fb, "can_para": can_para.astype(bool),
            "has_fallback": has_fb.astype(bool)}


def decode_pred_transform(opposite_eff, ctv, lm, seq, corr: np.ndarray,
                          scheme: int, xform: int, vmin: int, vmax: int,
                          num_vertices: int) -> np.ndarray | None:
    """Sequential decode chain. corr (T, N) uint64 zigzagged residuals;
    returns values_by_vertex (V, N) int64."""
    lib = _lib()
    if lib is None:
        return None
    opposite_eff = np.ascontiguousarray(opposite_eff, dtype=np.int64)
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    lm = np.ascontiguousarray(lm, dtype=np.int64)
    seq = np.ascontiguousarray(seq, dtype=np.int64)
    corr = np.ascontiguousarray(corr, dtype=np.uint64)
    T, N = corr.shape
    out = np.zeros((num_vertices, N), dtype=np.int64)
    u64p = corr.ctypes.data
    rc = lib.tdn_decode_pred_transform(
        _i64p(opposite_eff), _i64p(ctv), _i64p(lm), _i64p(seq), T, u64p,
        N, scheme, xform, vmin, vmax, num_vertices, _i64p(out))
    if rc != 0:
        return None
    return out


def edgebreaker(opposite: np.ndarray, ctv: np.ndarray, num_vertices: int):
    lib = _lib()
    if lib is None:
        return None
    opposite = np.ascontiguousarray(opposite, dtype=np.int64)
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    C = len(ctv)
    F = C // 3
    symbols = np.empty(F, dtype=np.uint8)
    processed = np.empty(F, dtype=np.int64)
    interior = np.empty(F + 1, dtype=np.uint8)
    init_corners = np.empty(F + 1, dtype=np.int64)
    splits = np.empty(3 * max(F, 1), dtype=np.int64)
    hole_id = np.empty(num_vertices, dtype=np.int64)
    n_sym = np.zeros(1, dtype=np.int64)
    n_comp = np.zeros(1, dtype=np.int64)
    n_init = np.zeros(1, dtype=np.int64)
    n_splits = np.zeros(1, dtype=np.int64)
    n_split_symbols = np.zeros(1, dtype=np.int64)
    rc = lib.tdn_edgebreaker(
        _i64p(opposite), _i64p(ctv), C, num_vertices,
        _u8p(symbols), _i64p(n_sym), _i64p(processed), _u8p(interior),
        _i64p(n_comp), _i64p(init_corners), _i64p(n_init), _i64p(splits),
        _i64p(n_splits), _i64p(n_split_symbols), _i64p(hole_id))
    if rc != 0:
        return None
    ns = int(n_splits[0])
    return {
        "symbols": symbols[:int(n_sym[0])].tolist(),
        "processed": processed[:int(n_sym[0])].tolist(),
        "interior_cfg": [bool(x) for x in interior[:int(n_comp[0])]],
        "init_face_corners": init_corners[:int(n_init[0])].tolist(),
        "splits": [(int(splits[3 * i]), int(splits[3 * i + 1]),
                    int(splits[3 * i + 2])) for i in range(ns)],
        "num_split_symbols": int(n_split_symbols[0]),
        "vertex_hole_id": hole_id,
    }


def crlight_decode(sym_bytes: bytes, num_symbols: int) -> np.ndarray | None:
    """Bulk LSB-first CrLight CLERS decode (shared/clers.py crlight_decode)."""
    lib = _lib()
    if lib is None:
        return None
    buf = np.frombuffer(sym_bytes, dtype=np.uint8)
    if len(buf) == 0:
        buf = np.zeros(1, dtype=np.uint8)
    out = np.empty(num_symbols, dtype=np.int32)
    rc = lib.tdn_crlight_decode(_u8p(buf), len(sym_bytes), num_symbols,
                                 _i32p(out))
    if rc != 0:
        return None
    return out


def spirale(symbols: np.ndarray, num_split_symbols: int, num_vertices: int,
            num_faces: int, splits: list) -> dict | None:
    """Standard-path Spirale Reversi (shared/spirale.py core) in C++.

    Returns None if the native library is missing or the stream is
    malformed (callers re-run the Python core for the precise error)."""
    lib = _lib()
    if lib is None:
        return None
    symbols = np.ascontiguousarray(symbols, dtype=np.int32)
    ns = len(symbols)
    sm = np.ascontiguousarray([s[0] for s in splits], dtype=np.int64)
    ss = np.ascontiguousarray([s[1] for s in splits], dtype=np.int64)
    so = np.ascontiguousarray([s[2] for s in splits], dtype=np.int64)
    C = 3 * num_faces
    opposite = np.full(C, -1, dtype=np.int64)
    ctv = np.full(C, -1, dtype=np.int64)
    max_nv = num_vertices + num_split_symbols
    left_most = np.full(max(max_nv, 1), -1, dtype=np.int64)
    out_nv = np.zeros(1, dtype=np.int64)
    stack = np.empty(ns + 1, dtype=np.int64)
    stack_len = np.zeros(1, dtype=np.int64)
    invalid = np.empty(ns + 1, dtype=np.int64)
    invalid_len = np.zeros(1, dtype=np.int64)
    faces = lib.tdn_spirale(
        _i32p(symbols), ns, num_split_symbols, num_vertices, num_faces,
        _i64p(sm), _i64p(ss), _i64p(so), len(splits),
        _i64p(opposite), _i64p(ctv), _i64p(left_most), _i64p(out_nv),
        _i64p(stack), _i64p(stack_len), _i64p(invalid), _i64p(invalid_len))
    if faces < 0:
        return None
    return {
        "opposite": opposite,
        "corner_to_vertex": ctv,
        "left_most": left_most,
        "num_vertices": int(out_nv[0]),
        "active_stack": stack[:int(stack_len[0])].tolist(),
        "invalid_vertices": invalid[:int(invalid_len[0])].tolist(),
        "num_decoded_faces": int(faces),
    }


def decode_texcoords(opposite_eff, ctv, lm, seq, corr: np.ndarray,
                     orientations, pos_by_corner: np.ndarray,
                     vmin: int, vmax: int,
                     num_vertices: int) -> np.ndarray | None:
    """Sequential UV decode chain (TexCoordPrediction + wrapped-difference
    inverse) in C++. corr (T, 2) uint64 zigzagged residuals; orientations
    the RAbS-decoded per-choice bits; pos_by_corner (C, 3) the decoded
    position values per corner. Returns values_by_vertex (V, 2)."""
    lib = _lib()
    if lib is None:
        return None
    opposite_eff = np.ascontiguousarray(opposite_eff, dtype=np.int64)
    ctv = np.ascontiguousarray(ctv, dtype=np.int64)
    lm = np.ascontiguousarray(lm, dtype=np.int64)
    seq = np.ascontiguousarray(seq, dtype=np.int64)
    corr = np.ascontiguousarray(corr, dtype=np.uint64)
    orients = np.ascontiguousarray(
        [1 if o else 0 for o in orientations], dtype=np.uint8)
    if len(orients) == 0:
        orients = np.zeros(1, dtype=np.uint8)
    pos_by_corner = np.ascontiguousarray(pos_by_corner, dtype=np.int64)
    T = len(seq)
    out = np.zeros((num_vertices, 2), dtype=np.int64)
    u64p = corr.ctypes.data
    rc = lib.tdn_decode_texcoords(
        _i64p(opposite_eff), _i64p(ctv), _i64p(lm), _i64p(seq), T, u64p,
        _u8p(orients), len(orientations), _i64p(pos_by_corner),
        len(pos_by_corner), vmin, vmax, num_vertices, _i64p(out))
    if rc != 0:
        return None
    return out


def recompute_attribute_vertices(opposite, points, lm, edge_seam,
                                 vertex_seam, att_unique_of_point,
                                 num_vertices: int):
    """Seam-splitting vertex recomputation (attribute corner tables) in
    C++. Returns (corner_to_vertex, left_most list, num_new, v2a-or-None)
    or None when unavailable / on a malformed seam loop (the Python path
    raises the detailed error)."""
    lib = _lib()
    if lib is None:
        return None
    opposite = np.ascontiguousarray(opposite, dtype=np.int64)
    points = np.ascontiguousarray(points, dtype=np.int64)
    lm = np.ascontiguousarray(lm, dtype=np.int64)
    edge_seam = np.ascontiguousarray(edge_seam, dtype=np.uint8)
    vertex_seam = np.ascontiguousarray(vertex_seam, dtype=np.uint8)
    C = len(points)
    has_v2a = att_unique_of_point is not None
    aup = (np.ascontiguousarray(att_unique_of_point, dtype=np.int64)
           if has_v2a else np.zeros(1, dtype=np.int64))
    ctv = np.zeros(C, dtype=np.int64)
    lm_out = np.empty(C + num_vertices, dtype=np.int64)
    v2a_out = np.empty(C + num_vertices, dtype=np.int64)
    n = lib.tdn_recompute_attribute_vertices(
        _i64p(opposite), _i64p(points), _i64p(lm), _u8p(edge_seam),
        _u8p(vertex_seam), _i64p(aup), 1 if has_v2a else 0, C,
        num_vertices, _i64p(ctv), _i64p(lm_out), _i64p(v2a_out))
    if n < 0:
        return None
    v2a = [int(x) for x in v2a_out[:n]] if has_v2a else None
    return ctv, [int(x) for x in lm_out[:n]], int(n), v2a


def _spirale_buffers(num_symbols, num_split_symbols, num_vertices,
                     num_faces, splits):
    sm = np.ascontiguousarray([s[0] for s in splits], dtype=np.int64)
    ss = np.ascontiguousarray([s[1] for s in splits], dtype=np.int64)
    so = np.ascontiguousarray([s[2] for s in splits], dtype=np.int64)
    C = 3 * num_faces
    return {
        "sm": sm, "ss": ss, "so": so,
        "opposite": np.full(C, -1, dtype=np.int64),
        "ctv": np.full(C, -1, dtype=np.int64),
        "left_most": np.full(max(num_vertices + num_split_symbols, 1), -1,
                             dtype=np.int64),
        "out_nv": np.zeros(1, dtype=np.int64),
        "stack": np.empty(num_symbols + 1, dtype=np.int64),
        "stack_len": np.zeros(1, dtype=np.int64),
        "invalid": np.empty(num_symbols + 1, dtype=np.int64),
        "invalid_len": np.zeros(1, dtype=np.int64),
    }


def _spirale_result(b, faces):
    if faces < 0:
        return None
    return {
        "opposite": b["opposite"],
        "corner_to_vertex": b["ctv"],
        "left_most": b["left_most"],
        "num_vertices": int(b["out_nv"][0]),
        "active_stack": b["stack"][:int(b["stack_len"][0])].tolist(),
        "invalid_vertices": b["invalid"][:int(b["invalid_len"][0])].tolist(),
        "num_decoded_faces": int(faces),
    }


def spirale_valence(queues: list, num_symbols: int, num_split_symbols: int,
                    num_vertices: int, num_faces: int,
                    splits: list) -> dict | None:
    """Valence-mode Spirale Reversi: per-context pre-decoded symbol queues,
    contexts computed from the reconstruction state in C++."""
    lib = _lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(q, dtype=np.int32) for q in queues])
        if any(len(q) for q in queues) else np.zeros(1, dtype=np.int32),
        dtype=np.int32)
    off = np.zeros(len(queues) + 1, dtype=np.int64)
    for i, q in enumerate(queues):
        off[i + 1] = off[i] + len(q)
    b = _spirale_buffers(num_symbols, num_split_symbols, num_vertices,
                         num_faces, splits)
    faces = lib.tdn_spirale_valence(
        _i32p(flat), _i64p(off), num_symbols, num_split_symbols,
        num_vertices, num_faces, _i64p(b["sm"]), _i64p(b["ss"]),
        _i64p(b["so"]), len(splits), _i64p(b["opposite"]), _i64p(b["ctv"]),
        _i64p(b["left_most"]), _i64p(b["out_nv"]), _i64p(b["stack"]),
        _i64p(b["stack_len"]), _i64p(b["invalid"]), _i64p(b["invalid_len"]))
    return _spirale_result(b, faces)


def spirale_contexts(symbols: np.ndarray, num_split_symbols: int,
                     num_vertices: int, num_faces: int,
                     splits: list) -> np.ndarray | None:
    """Encoder-side valence simulation: run the reconstruction on the known
    decode-order symbols and return the per-symbol context ids."""
    lib = _lib()
    if lib is None:
        return None
    symbols = np.ascontiguousarray(symbols, dtype=np.int32)
    ns = len(symbols)
    ctx = np.empty(max(ns, 1), dtype=np.int32)
    b = _spirale_buffers(ns, num_split_symbols, num_vertices, num_faces,
                         splits)
    faces = lib.tdn_spirale_contexts(
        _i32p(symbols), _i32p(ctx), ns, num_split_symbols, num_vertices,
        num_faces, _i64p(b["sm"]), _i64p(b["ss"]), _i64p(b["so"]),
        len(splits), _i64p(b["opposite"]), _i64p(b["ctv"]),
        _i64p(b["left_most"]), _i64p(b["out_nv"]), _i64p(b["stack"]),
        _i64p(b["stack_len"]), _i64p(b["invalid"]), _i64p(b["invalid_len"]))
    if faces < 0:
        return None
    return ctx[:ns]

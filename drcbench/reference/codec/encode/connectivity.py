"""Connectivity encoders: edgebreaker (Standard traversal) and sequential.

Reference behavior:
  - draco-oxide/src/encode/connectivity/edgebreaker.rs (DFS symbol emission
    :261-350, boundary processing :226-256, begin_from :411-431, stream
    layout :458-530, DefaultTraversal encode :575-657)
  - .../sequential.rs (u64 face count, method byte, width-switched indices)
"""

from __future__ import annotations

import numpy as np

from ..entropy.rans import RabsEncoder
from ..entropy.symbol_coding import DIRECT_CODED, encode_symbols
from ..models.attribute import Attribute, AttributeType
from ..models.corner_table import (
    NONE, AllInclusiveCornerTable, AttributeCornerTable, CornerTable,
    next_corner, next_corners, prev_corner, prev_corners,
)
from ..shared.clers import (
    C, CRLIGHT_CODES, E, EB_PREDICTIVE, EB_STANDARD, EB_VALENCE, L,
    ORIENTATION_LEFT,
    ORIENTATION_RIGHT, R, S,
)
from ..shared.spirale import (
    NUM_VALENCE_CONTEXTS, DecodedCornerTable, spirale_reversi_core,
    valence_context,
)
from ..wire.bit_io import BitWriter
from ..wire.varint import leb128_write


class EdgebreakerError(Exception):
    pass


class ConnectivityOutput:
    """Carried from the connectivity encoder to the attribute encoder
    (edgebreaker.rs Output)."""

    def __init__(self, corner_table: AllInclusiveCornerTable,
                 corners_of_edgebreaker: list[int], method: str) -> None:
        self.corner_table = corner_table
        self.corners_of_edgebreaker = corners_of_edgebreaker
        self.method = method


class _CombinedVertexMap:
    """Duck-typed stand-in for the position attribute handed to
    CornerTable: its point->vertex map is the combined identity over ALL
    attributes' value indices (single-connectivity vertex space)."""

    def __init__(self, inverse: np.ndarray) -> None:
        self._inverse = inverse

    def unique_indices(self) -> np.ndarray:
        return self._inverse


def combined_vertex_map(attributes: list[Attribute]) -> np.ndarray:
    """(P,) point -> combined-vertex index where two points share a vertex
    only when EVERY attribute agrees on its value index (first-occurrence
    order, so position-only meshes keep their original vertex ids)."""
    cols = np.stack([np.asarray(a.unique_indices(), dtype=np.int64)
                     for a in attributes], axis=1)
    _, first, inverse = np.unique(cols, axis=0, return_index=True,
                                  return_inverse=True)
    # np.unique sorts keys; remap to first-occurrence order so the vertex
    # numbering matches the no-seam case exactly
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inverse]


class EdgebreakerEncoder:
    """Edgebreaker over the corner table: Standard (CrLight) or Valence
    (per-context rANS symbol streams) traversal encoding.

    ``single_connectivity`` mirrors the reference Config knob
    (edgebreaker.rs:85; its implementation panics, edgebreaker.rs:129-130 —
    ours is real): every attribute shares ONE corner table whose vertex
    space is the combined identity over all attributes' value indices
    (attribute seams become real cuts), and the per-attribute seam
    machinery is skipped entirely (num_attribute_tables = 0, no seam
    streams — the edgebreaker.rs:173 early-return generalized to any
    attribute count)."""

    def __init__(self, faces: np.ndarray, attributes: list[Attribute],
                 traversal: int = EB_STANDARD,
                 single_connectivity: bool = False) -> None:
        if traversal not in (EB_STANDARD, EB_VALENCE, EB_PREDICTIVE):
            raise EdgebreakerError(f"unsupported traversal kind {traversal}")
        self.traversal_kind = traversal
        if single_connectivity:
            conn_att = _CombinedVertexMap(combined_vertex_map(attributes))
            self.ct = CornerTable(faces, conn_att)
            self.att_data = []
        else:
            pos = next(a for a in attributes
                       if a.att_type == AttributeType.POSITION)
            self.ct = CornerTable(faces, pos)
            # per-attribute seam tables, skipping the position attribute
            # (edgebreaker.rs:171-193)
            self.att_data = [
                AttributeCornerTable(self.ct, a)
                for a in attributes if a.att_type != AttributeType.POSITION
            ]
        V = self.ct.num_vertices
        self.visited_vertices = np.zeros(V, dtype=bool)
        self.visited_faces = np.zeros(self.ct.num_faces(), dtype=bool)
        self.visited_holes: list[bool] = []
        self.vertex_hole_id = np.full(V, NONE, dtype=np.int64)
        self.corner_stack: list[int] = []
        self.last_symbol_idx = -1
        self.processed_corners: list[int] = []
        self.face_to_split_symbol: dict[int, int] = {}
        self.num_split_symbols = 0
        self.init_face_corners: list[int] = []
        self.symbols: list[int] = []
        self.interior_cfg: list[bool] = []
        self.topology_splits: list[tuple[int, int, int]] = []  # (merge, split, orient)

    # --- boundary bookkeeping (edgebreaker.rs:195-256) -------------------
    def _compute_boundaries(self) -> None:
        ct = self.ct
        for c in range(ct.num_corners):
            if ct.opp(c) == NONE:
                v = ct.vertex(next_corner(c))
                if self.vertex_hole_id[v] != NONE:
                    continue
                boundary_idx = len(self.visited_holes)
                self.visited_holes.append(False)
                cc = c
                while self.vertex_hole_id[v] == NONE:
                    self.vertex_hole_id[v] = boundary_idx
                    cc = next_corner(cc)
                    while ct.opp(cc) != NONE:
                        cc = next_corner(ct.opp(cc))
                    v = ct.vertex(next_corner(cc))

    def _process_boundary(self, start_corner: int,
                          encode_first_vertex: bool) -> int:
        ct = self.ct
        corner = prev_corner(start_corner)
        while ct.opp(corner) != NONE:
            corner = next_corner(ct.opp(corner))
        start_v = ct.vertex(start_corner)
        n = 0
        if encode_first_vertex:
            self.visited_vertices[start_v] = True
            n += 1
        self.visited_holes[self.vertex_hole_id[start_v]] = True
        curr_v = ct.vertex(prev_corner(corner))
        while curr_v != start_v:
            self.visited_vertices[curr_v] = True
            n += 1
            corner = next_corner(corner)
            while ct.opp(corner) != NONE:
                corner = next_corner(ct.opp(corner))
            curr_v = ct.vertex(prev_corner(corner))
        return n

    # --- traversal helpers ------------------------------------------------
    def _right_visited(self, c: int) -> bool:
        rc = self.ct.get_right_corner(c)
        return True if rc == NONE else bool(self.visited_faces[rc // 3])

    def _left_visited(self, c: int) -> bool:
        lc = self.ct.get_left_corner(c)
        return True if lc == NONE else bool(self.visited_faces[lc // 3])

    def _check_split(self, merging_symbol_idx: int, orientation: int,
                     split_face: int) -> None:
        idx = self.face_to_split_symbol.get(split_face)
        if idx is not None:
            self.topology_splits.append((merging_symbol_idx, idx, orientation))

    def _begin_from(self, face_idx: int) -> tuple[bool, int]:
        ct = self.ct
        corner = 3 * face_idx
        for _ in range(3):
            if ct.opp(corner) == NONE:
                return False, corner
            if self.vertex_hole_id[ct.vertex(corner)] != NONE:
                right = corner
                while right != NONE:
                    corner = right
                    right = ct.swing_right(right)
                return False, prev_corner(corner)
            corner = next_corner(corner)
        return True, corner

    def _edgebreaker_from(self, c: int) -> None:
        """DFS emitting one CLERS symbol per face (edgebreaker.rs:261-350)."""
        ct = self.ct
        self.corner_stack.clear()
        self.corner_stack.append(c)
        num_faces = ct.num_faces()
        while self.corner_stack:
            c = self.corner_stack[-1]
            if self.visited_faces[c // 3]:
                self.corner_stack.pop()
                continue
            num_visited = 0
            while num_visited < num_faces:
                num_visited += 1
                self.last_symbol_idx += 1
                face_idx = c // 3
                self.visited_faces[face_idx] = True
                self.processed_corners.append(c)
                v = ct.vertex(c)
                if not self.visited_vertices[v]:
                    self.visited_vertices[v] = True
                    if self.vertex_hole_id[v] == NONE:
                        self.symbols.append(C)
                        c = ct.get_right_corner(c)
                        continue
                right_c = ct.get_right_corner(c)
                left_c = ct.get_left_corner(c)
                if self._right_visited(c):
                    if right_c != NONE:
                        self._check_split(self.last_symbol_idx,
                                          ORIENTATION_RIGHT, right_c // 3)
                    if self._left_visited(c):
                        if left_c != NONE:
                            self._check_split(self.last_symbol_idx,
                                              ORIENTATION_LEFT, left_c // 3)
                        self.symbols.append(E)
                        self.corner_stack.pop()
                        break
                    else:
                        self.symbols.append(R)
                        c = left_c
                else:
                    if self._left_visited(c):
                        if left_c != NONE:
                            self._check_split(self.last_symbol_idx,
                                              ORIENTATION_LEFT, left_c // 3)
                        self.symbols.append(L)
                        c = right_c
                    else:
                        self.symbols.append(S)
                        self.num_split_symbols += 1
                        hole = self.vertex_hole_id[v]
                        if hole != NONE and not self.visited_holes[hole]:
                            self._process_boundary(c, False)
                        self.face_to_split_symbol[face_idx] = self.last_symbol_idx
                        self.corner_stack[-1] = left_c
                        self.corner_stack.append(right_c)
                        break

    def encode(self, writer) -> ConnectivityOutput:
        """Full edgebreaker stream (edgebreaker.rs:458-530)."""
        ct = self.ct
        writer.write_u8(self.traversal_kind)  # traversal decoder type
        leb128_write(ct.num_vertices, writer)
        leb128_write(ct.num_faces(), writer)
        writer.write_u8(len(self.att_data))

        from ..native import topo
        native_out = topo.edgebreaker(ct.opposite, ct.corner_to_vertex,
                                      ct.num_vertices)
        if native_out is not None:
            self.symbols = native_out["symbols"]
            self.processed_corners = native_out["processed"]
            self.interior_cfg = native_out["interior_cfg"]
            self.init_face_corners = native_out["init_face_corners"]
            self.topology_splits = native_out["splits"]
            self.num_split_symbols = native_out["num_split_symbols"]
        else:
            self._compute_boundaries()
            for c in range(ct.num_corners):
                face_idx = c // 3
                if self.visited_faces[face_idx]:
                    continue
                is_interior, start_corner = self._begin_from(face_idx)
                self.interior_cfg.append(is_interior)
                if is_interior:
                    v = ct.vertex(start_corner)
                    n = ct.vertex(next_corner(start_corner))
                    p = ct.vertex(prev_corner(start_corner))
                    self.visited_vertices[v] = True
                    self.visited_vertices[n] = True
                    self.visited_vertices[p] = True
                    self.visited_faces[face_idx] = True
                    self.init_face_corners.append(next_corner(start_corner))
                    corner_opp = ct.opp(next_corner(start_corner))
                    self._edgebreaker_from(corner_opp)
                else:
                    self._process_boundary(next_corner(start_corner), True)
                    self._edgebreaker_from(start_corner)

        leb128_write(len(self.symbols), writer)
        leb128_write(self.num_split_symbols, writer)
        self._encode_topology_splits(writer)
        if self.traversal_kind == EB_VALENCE:
            self._encode_valence_traversal(writer)
        elif self.traversal_kind == EB_PREDICTIVE:
            self._encode_predictive_traversal(writer)
        else:
            self._encode_traversal(writer)

        corners = list(reversed(self.init_face_corners)) + self.processed_corners
        all_tables = AllInclusiveCornerTable(ct, self.att_data)
        return ConnectivityOutput(all_tables, corners, "edgebreaker")

    def _encode_topology_splits(self, writer) -> None:
        """leb128 count + per-split deltas + 1 orientation bit each
        (edgebreaker.rs:375-403)."""
        leb128_write(len(self.topology_splits), writer)
        last = 0
        for merge, split, _orient in self.topology_splits:
            leb128_write(merge - last, writer)
            leb128_write(merge - split, writer)
            last = merge
        bw = BitWriter(writer, msb_first=False)
        for _, _, orient in self.topology_splits:
            bw.write_bits(1, 1 if orient == ORIENTATION_RIGHT else 0)
        bw.close()

    def _encode_traversal(self, writer) -> None:
        """DefaultTraversal::encode (edgebreaker.rs:575-657): reversed CrLight
        symbols (LSB-first, leb128 size prefix), RAbS start-face flags, then
        per-attribute RAbS seam flags."""
        from ..ops.bitpack import pack_bits_lsb
        from ..shared.clers import CRLIGHT_BITS, CRLIGHT_SIZES
        rev = np.asarray(self.symbols[::-1], dtype=np.int64)
        sizes = CRLIGHT_SIZES[rev]
        codes = CRLIGHT_BITS[rev]
        buf = pack_bits_lsb(sizes, codes)
        leb128_write(len(buf), writer)
        writer.write_bytes(buf)
        self._encode_start_faces(writer)
        self._encode_seams(writer)

    def _encode_valence_traversal(self, writer) -> None:
        """Valence traversal body: RAbS start-face flags + seam flags (same
        as Standard), then per-context direct-coded rANS symbol streams.

        Contexts are assigned by *simulating the decoder*: the shared
        Spirale Reversi core replays the symbols in decode order and buckets
        each by the clamped valence of the attach vertex (shared/spirale.py
        valence_context). Because the decoder runs the identical core, the
        context sequence always matches — by construction, not by protocol
        convention. Mirrors the intent of the reference's ValenceTraversal
        (edgebreaker.rs:659-804), whose own valence path is bit-rotted."""
        self._encode_start_faces(writer)
        self._encode_seams(writer)

        rev_symbols = list(reversed(self.symbols))

        # native decoder-simulation: contexts computed in C++ from the
        # known decode-order symbols
        from ..native import topo as ntopo
        ctx_arr = ntopo.spirale_contexts(
            np.asarray(rev_symbols, dtype=np.int32), self.num_split_symbols,
            self.ct.num_vertices, self.ct.num_faces(),
            [list(t) for t in self.topology_splits])
        if ctx_arr is not None:
            rev_arr = np.asarray(rev_symbols, dtype=np.int64)
            queues = [rev_arr[ctx_arr == c].tolist()
                      for c in range(NUM_VALENCE_CONTEXTS)]
        else:
            queues = [[] for _ in range(NUM_VALENCE_CONTEXTS)]

            def get_symbol(ct, active_stack, symbol_id):
                ctx = valence_context(ct, active_stack)
                sym = rev_symbols[symbol_id]
                queues[ctx].append(sym)
                return sym

            sim_ct = DecodedCornerTable(self.ct.num_faces())
            splits_copy = [list(t) for t in self.topology_splits]
            spirale_reversi_core(sim_ct, len(self.symbols),
                                 self.num_split_symbols,
                                 self.ct.num_vertices,
                                 splits_copy, get_symbol)

        for q in queues:
            leb128_write(len(q), writer)
            if q:
                encode_symbols(np.asarray(q, dtype=np.uint64), 1,
                               DIRECT_CODED, writer)

    def _encode_predictive_traversal(self, writer) -> None:
        """Predictive traversal body (EdgebreakerKind=1): start-face and
        seam flags exactly as Standard, then the CLERS symbols coded with
        an order-1 context model — each symbol rides the rANS stream
        selected by the PREVIOUS decoded symbol (a sixth context seeds the
        chain), one direct-coded stream per context, written in decode
        order.

        The reference declares the Predictive variant but gives it no
        semantics or code at all (shared/connectivity/edgebreaker/
        mod.rs:20-53 — enum + wire byte only); this dialect defines it as
        the natural context-model coder: the previous symbol strongly
        predicts the next (C runs on regular interiors, R chains along
        strips), so per-context adaptive tables beat CrLight's fixed
        1/3-bit code on most meshes. Unlike Valence, the context chain
        depends only on the symbol sequence itself — the decoder
        pre-decodes all six streams, replays the chain with no
        reconstruction state, and feeds the whole sequence to the native
        Spirale core (decode/connectivity.py)."""
        self._encode_start_faces(writer)
        self._encode_seams(writer)
        rev = list(reversed(self.symbols))  # decode order
        queues: list[list[int]] = [[] for _ in range(6)]
        prev = 5  # start context
        for s in rev:
            queues[prev].append(int(s))
            prev = int(s)
        for q in queues:
            leb128_write(len(q), writer)
            if q:
                encode_symbols(np.asarray(q, dtype=np.uint64), 1,
                               DIRECT_CODED, writer)

    def _encode_start_faces(self, writer) -> None:
        # start-face interior flags
        n0 = sum(1 for cfg in self.interior_cfg if not cfg)
        zp = int(np.float32(n0) / np.float32(len(self.interior_cfg))
                 * np.float32(256.0) + np.float32(0.5)) if self.interior_cfg else 0
        zero_prob = max(1, min(255, zp))
        writer.write_u8(zero_prob)
        enc = RabsEncoder(zero_prob)
        for cfg in reversed(self.interior_cfg):
            enc.write(1 if cfg else 0)
        blob = enc.flush()
        leb128_write(len(blob), writer)
        writer.write_bytes(blob)

    def _encode_seams(self, writer) -> None:
        # attribute seam flags: replay corners in reverse, for each
        # non-boundary edge of each newly visited face record whether the
        # attribute-table opposite is a seam (edgebreaker.rs:610-653).
        # Vectorized: "opposite face not yet visited when face k is
        # processed" == first-occurrence position of that face > k, and the
        # per-attribute seam bit is exactly is_edge_on_seam[corner].
        ct = self.ct
        rev = np.asarray(self.processed_corners[::-1], dtype=np.int64)
        P = len(rev)
        if P:
            faces = rev // 3
            pos_of_face = np.full(ct.num_faces(), P, dtype=np.int64)
            # first occurrence wins (reverse assignment order)
            pos_of_face[faces[::-1]] = np.arange(P - 1, -1, -1)
            corners3 = np.stack(
                [rev, next_corners(rev), prev_corners(rev)], axis=1)
            opp3 = ct.opposite[corners3]
            valid = opp3 != NONE
            opp_face = np.where(valid, opp3, 0) // 3
            k_idx = np.broadcast_to(np.arange(P)[:, None], corners3.shape)
            emit = valid & (pos_of_face[opp_face] > k_idx)
            emit_corners = corners3[emit]  # row-major: (c, next, prev) per k
        else:
            emit_corners = np.zeros(0, dtype=np.int64)
        for ad in self.att_data:
            seam_bits = ad.is_edge_on_seam[emit_corners].astype(np.uint8)
            n = len(seam_bits)
            n0 = int(n - seam_bits.sum())
            zp = int(np.float32(n0) / np.float32(n)
                     * np.float32(256.0) + np.float32(0.5)) if n else 0
            prob_zero = max(1, min(255, zp))
            writer.write_u8(prob_zero)
            enc = RabsEncoder(prob_zero)
            enc.write_all(seam_bits[::-1])
            blob = enc.flush()
            leb128_write(len(blob), writer)
            writer.write_bytes(blob)


class _ByteBuf:
    """Minimal ByteWriter for in-memory sub-buffers."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def write_u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)


def encode_sequential(faces: np.ndarray, num_points: int, writer,
                      method: str = "direct") -> None:
    """Sequential connectivity (sequential.rs): u64 face count, u8 method,
    then the index payload.

    method "direct" (id 1, the only one the reference's encoder emits —
    encode/connectivity/sequential.rs:97): indices at 8/16/32 bits or
    leb128 for the 21-bit range, switched on the point count.

    method "compressed" (id 0 — the reference MODELS it in its method enum,
    shared/connectivity/sequential.rs:23-38, but never implements either
    side): consecutive-index deltas with the sign folded into bit 0
    (|d|<<1 | (d<0)), then one symbol_coding stream — the same
    delta scheme Google Draco's sequential CompressAndEncodeIndices uses.
    Wins on meshes with locally coherent index order."""
    writer.write_u64(len(faces))
    flat = np.asarray(faces, dtype=np.int64).ravel()
    if method == "compressed":
        from ..entropy.symbol_coding import DIRECT_CODED, encode_symbols
        writer.write_u8(0)  # Compressed
        diffs = np.diff(flat, prepend=np.int64(0))
        syms = np.where(diffs < 0, ((-diffs) << 1) | 1,
                        diffs << 1).astype(np.uint64)
        encode_symbols(syms, 1, DIRECT_CODED, writer)
        return
    if method != "direct":
        raise ValueError(f"unknown sequential method {method!r}")
    writer.write_u8(1)  # DirectIndices
    if num_points < 0x100:
        writer.write_bytes(flat.astype(np.uint8).tobytes())
    elif num_points < 0x10000:
        writer.write_bytes(flat.astype("<u2").tobytes())
    elif num_points < (1 << 21):
        for v in flat.tolist():
            leb128_write(v, writer)
    elif num_points < 0x1000000:
        writer.write_bytes(flat.astype("<u4").tobytes())
    else:
        raise ValueError("too many vertices for sequential connectivity")

"""Spirale Reversi reconstruction core, shared by the connectivity decoder
and the valence-traversal encoder.

The decoder rebuilds the corner table face by face while consuming CLERS
symbols in reverse emission order (algorithm structure follows Google
Draco's mesh_edgebreaker_decoder_impl, studied via the annotated
transliteration in draco-oxide/src/decode/connectivity/
spirale_reversi.rs:200-660). The valence encoder *simulates* this exact
reconstruction to derive the per-symbol valence contexts, which guarantees
the encoder and decoder always agree on the context sequence.
"""

from __future__ import annotations

import numpy as np

from ..models.corner_table import NONE, next_corner, prev_corner
from .clers import C, E, L, MAX_VALENCE, MIN_VALENCE, ORIENTATION_RIGHT, R, S


class DecodeError(Exception):
    pass


class DecodedCornerTable:
    """Growable corner table built during Spirale Reversi. Provides the same
    navigation interface as models.corner_table.CornerTable, with
    ``point(c) == c`` (decoder points are corners until final assembly)."""

    def __init__(self, num_faces: int) -> None:
        self.opposite = np.full(3 * num_faces, NONE, dtype=np.int64)
        self.corner_to_vertex = np.full(3 * num_faces, NONE, dtype=np.int64)
        self.left_most: list[int] = []
        self.num_corners = 3 * num_faces
        self.num_vertices = 0

    def add_vertex(self) -> int:
        self.left_most.append(NONE)
        self.num_vertices += 1
        return self.num_vertices - 1

    def num_faces(self) -> int:
        return self.num_corners // 3

    def vertex(self, c: int) -> int:
        return int(self.corner_to_vertex[c])

    def point(self, c: int) -> int:
        return c

    def opp(self, c: int) -> int:
        return int(self.opposite[c])

    def set_opposite(self, a: int, b: int) -> None:
        self.opposite[a] = b
        self.opposite[b] = a

    def swing_right(self, c: int) -> int:
        o = self.opposite[prev_corner(c)]
        return prev_corner(o) if o != NONE else NONE

    def swing_left(self, c: int) -> int:
        o = self.opposite[next_corner(c)]
        return next_corner(o) if o != NONE else NONE

    def get_right_corner(self, c: int) -> int:
        return int(self.opposite[next_corner(c)])

    def get_left_corner(self, c: int) -> int:
        return int(self.opposite[prev_corner(c)])

    def left_most_corner(self, v: int) -> int:
        return self.left_most[v]

    def is_on_boundary(self, v: int) -> bool:
        return self.swing_left(self.left_most[v]) == NONE

    def vertex_corners(self, v: int):
        """All corners on vertex v, starting at the left-most corner and
        swinging right. Bounded by the corner count: a corrupt stream can
        wire an opposite cycle that never revisits ``start`` (soak-found
        round 3 — the start-only check span forever)."""
        start = self.left_most[v]
        out = []
        c = start
        limit = len(self.corner_to_vertex) + 1
        while c != NONE and len(out) < limit:
            out.append(c)
            c = self.swing_right(c)
            if c == start:
                break
        return out

    def vertex_valence(self, v: int) -> int:
        """Number of corners currently attached to vertex v (bounded —
        see vertex_corners)."""
        start = self.left_most[v]
        n = 0
        c = start
        limit = len(self.corner_to_vertex) + 1
        while c != NONE and n < limit:
            n += 1
            c = self.swing_right(c)
            if c == start:
                break
        return n


def valence_context(ct: DecodedCornerTable, active_stack: list[int]) -> int:
    """Symbol-coding context for the valence traversal: the clamped valence
    of the vertex the next face will attach to. Both sides compute this on
    the reconstruction state *before* the symbol is consumed, so the first
    symbol of each component (empty stack, always E) lands in context 0.

    Mirrors the intent of the reference's ValenceTraversal context bucketing
    (encode/connectivity/edgebreaker.rs:785-803: context =
    clamp(valence, 2, 7) - 2), but keyed off the decoder-visible valence so
    the scheme is decodable (the reference's own valence path is bit-rotted
    and its decoder was never written)."""
    if not active_stack:
        return 0
    c = active_stack[-1]
    v = ct.vertex(next_corner(c))
    val = ct.vertex_valence(v)
    return min(max(val, MIN_VALENCE), MAX_VALENCE) - MIN_VALENCE


NUM_VALENCE_CONTEXTS = MAX_VALENCE - MIN_VALENCE + 1


def spirale_reversi_core(ct: DecodedCornerTable, num_symbols: int,
                         num_split_symbols: int, num_vertices: int,
                         splits: list[list[int]], get_symbol):
    """Run the face-by-face reconstruction, pulling one CLERS symbol per
    step from ``get_symbol(ct, active_stack, symbol_id)``.

    ``splits`` is consumed destructively from the back (entries are
    [encoder_merge_symbol_idx, encoder_split_symbol_idx, orientation] in
    ascending merge order, as parsed off the wire).

    Returns (active_stack, invalid_vertices, num_decoded_faces)."""
    active_stack: list[int] = []
    split_active_corners: dict[int, int] = {}
    invalid_vertices: list[int] = []
    max_num_vertices = num_vertices + num_split_symbols

    num_decoded_faces = 0
    for symbol_id in range(num_symbols):
        face = num_decoded_faces
        num_decoded_faces += 1
        corner = 3 * face
        symbol = get_symbol(ct, active_stack, symbol_id)
        check_split = False
        if symbol == C:
            if not active_stack:
                raise DecodeError("C with empty active stack")
            corner_a = active_stack[-1]
            vertex_x = ct.vertex(next_corner(corner_a))
            corner_b = next_corner(ct.left_most_corner(vertex_x))
            if corner_a == corner_b:
                raise DecodeError("C matched corners equal")
            ct.set_opposite(corner_a, corner + 1)
            ct.set_opposite(corner_b, corner + 2)
            vert_a_prev = ct.vertex(prev_corner(corner_a))
            vert_b_next = ct.vertex(next_corner(corner_b))
            if vertex_x in (vert_a_prev, vert_b_next):
                raise DecodeError("degenerate C face")
            ct.corner_to_vertex[corner] = vertex_x
            ct.corner_to_vertex[corner + 1] = vert_b_next
            ct.corner_to_vertex[corner + 2] = vert_a_prev
            ct.left_most[vert_a_prev] = corner + 2
            active_stack[-1] = corner
        elif symbol in (R, L):
            if not active_stack:
                raise DecodeError("R/L with empty active stack")
            corner_a = active_stack[-1]
            if symbol == R:
                opp_corner, corner_l, corner_r = corner + 2, corner + 1, corner
            else:
                opp_corner, corner_l, corner_r = corner + 1, corner, corner + 2
            ct.set_opposite(opp_corner, corner_a)
            new_vert = ct.add_vertex()
            if ct.num_vertices > max_num_vertices:
                raise DecodeError("too many decoded vertices")
            ct.corner_to_vertex[opp_corner] = new_vert
            ct.left_most[new_vert] = opp_corner
            vertex_r = ct.vertex(prev_corner(corner_a))
            ct.corner_to_vertex[corner_r] = vertex_r
            ct.left_most[vertex_r] = corner_r
            ct.corner_to_vertex[corner_l] = ct.vertex(next_corner(corner_a))
            active_stack[-1] = corner
            check_split = True
        elif symbol == S:
            if not active_stack:
                raise DecodeError("S with empty active stack")
            corner_b = active_stack.pop()
            stored = split_active_corners.pop(symbol_id, None)
            if stored is not None:
                active_stack.append(stored)
            if not active_stack:
                raise DecodeError("S with no second active corner")
            corner_a = active_stack[-1]
            if corner_a == corner_b:
                raise DecodeError("S matched corners equal")
            ct.set_opposite(corner_a, corner + 2)
            ct.set_opposite(corner_b, corner + 1)
            vertex_p = ct.vertex(prev_corner(corner_a))
            ct.corner_to_vertex[corner] = vertex_p
            ct.corner_to_vertex[corner + 1] = ct.vertex(next_corner(corner_a))
            vert_b_prev = ct.vertex(prev_corner(corner_b))
            ct.corner_to_vertex[corner + 2] = vert_b_prev
            ct.left_most[vert_b_prev] = corner + 2
            corner_n = next_corner(corner_b)
            vertex_n = ct.vertex(corner_n)
            ct.left_most[vertex_p] = ct.left_most_corner(vertex_n)
            # remap all corners on vertex_n (CCW swing-left walk); the
            # walk must terminate within the corner count — a corrupt
            # stream can wire an opposite cycle that never returns to
            # first_c (soak-found round 3: infinite loop)
            first_c = corner_n
            steps = 0
            max_steps = len(ct.corner_to_vertex)
            while corner_n != NONE:
                ct.corner_to_vertex[corner_n] = vertex_p
                corner_n = ct.swing_left(corner_n)
                steps += 1
                if corner_n == first_c or steps > max_steps:
                    raise DecodeError("S vertex walk looped")
            ct.left_most[vertex_n] = NONE  # isolated
            invalid_vertices.append(vertex_n)
            active_stack[-1] = corner
        elif symbol == E:
            v0 = ct.add_vertex()
            v1 = ct.add_vertex()
            v2 = ct.add_vertex()
            if ct.num_vertices > max_num_vertices:
                raise DecodeError("too many decoded vertices")
            ct.corner_to_vertex[corner] = v0
            ct.corner_to_vertex[corner + 1] = v1
            ct.corner_to_vertex[corner + 2] = v2
            ct.left_most[v0] = corner
            ct.left_most[v1] = corner + 1
            ct.left_most[v2] = corner + 2
            active_stack.append(corner)
            check_split = True
        else:
            raise DecodeError(f"invalid symbol {symbol}")

        if check_split:
            encoder_symbol_id = num_symbols - symbol_id - 1
            while splits and splits[-1][0] == encoder_symbol_id:
                _, enc_split_id, orientation = splits.pop()
                act_top = active_stack[-1]
                if orientation == ORIENTATION_RIGHT:
                    new_active = next_corner(act_top)
                else:
                    new_active = prev_corner(act_top)
                dec_split_id = num_symbols - enc_split_id - 1
                split_active_corners[dec_split_id] = new_active

    return active_stack, invalid_vertices, num_decoded_faces

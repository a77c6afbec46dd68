"""Corner tables: the central connectivity structure.

SoA int64 arrays: ``opposite[C]`` (-1 = none), ``corner_to_vertex[C]``,
``left_most[V]``. Construction order and tie-breaking replicate the
reference exactly — the edgebreaker symbol stream depends on them.

Reference behavior:
  - draco-oxide/src/core/corner_table/mod.rs (CornerTable: half-edge
    matching :252-340, non-manifold edge break-up :149-234, left-most
    corners + non-manifold vertex duplication :342-416)
  - .../attribute_corner_table.rs (seam detection :25-64, vertex
    recomputation :79-137)
  - .../all_inclusive_corner_table.rs (bundle)
"""

from __future__ import annotations

import numpy as np

NONE = -1


def next_corner(c: int) -> int:
    return c - 2 if c % 3 == 2 else c + 1


def prev_corner(c: int) -> int:
    return c + 2 if c % 3 == 0 else c - 1


def next_corners(c: np.ndarray) -> np.ndarray:
    return np.where(c % 3 == 2, c - 2, c + 1)


def prev_corners(c: np.ndarray) -> np.ndarray:
    return np.where(c % 3 == 0, c + 2, c - 1)


class CornerTable:
    """Connectivity over the *position-unique* vertex space.

    ``faces_points`` are the mesh faces (point space); ``conn_faces`` are the
    same faces remapped through the position attribute's unique-value map
    (mod.rs:85-93)."""

    def __init__(self, faces_points: np.ndarray, pos_att) -> None:
        self.faces_points = np.asarray(faces_points, dtype=np.int64)
        pos_idx = pos_att.unique_indices()
        conn_faces = pos_idx[self.faces_points]
        self.num_corners = conn_faces.size
        self.corner_to_vertex = conn_faces.ravel().astype(np.int64).copy()

        used = np.zeros(int(self.corner_to_vertex.max()) + 1 if self.num_corners else 0,
                        dtype=bool)
        used[self.corner_to_vertex] = True
        if not used.all():
            raise ValueError(
                f"mesh contains unused vertices: {np.nonzero(~used)[0][:8]}")

        self.num_vertices = len(used)
        self.non_manifold_vertex_parents: list[int] = []

        from ..native import topo
        opp = topo.compute_table(self.corner_to_vertex, self.num_vertices)
        if opp is not None:
            self.opposite = opp
            if topo.has_non_manifold_edges(self.corner_to_vertex):
                topo.break_non_manifold_edges(self.opposite,
                                              self.corner_to_vertex)
            new_v, lm, parents = topo.left_most(
                self.corner_to_vertex, self.opposite, self.num_vertices)
            self.num_vertices = new_v
            self.left_most = lm
            self.non_manifold_vertex_parents = parents
        else:
            self.opposite = np.full(self.num_corners, NONE, dtype=np.int64)
            self._compute_table()
            if self._contains_non_manifold_edges():
                self._handle_non_manifold_edges()
            self.left_most = np.full(self.num_vertices, NONE, dtype=np.int64)
            self._compute_left_most_corners()

    # --- basic navigation -------------------------------------------------
    def num_faces(self) -> int:
        return self.num_corners // 3

    def vertex(self, c: int) -> int:
        return int(self.corner_to_vertex[c])

    def point(self, c: int) -> int:
        return int(self.faces_points[c // 3, c % 3])

    def opp(self, c: int) -> int:
        return int(self.opposite[c])

    def swing_right(self, c: int) -> int:
        o = self.opposite[prev_corner(c)]
        return prev_corner(o) if o != NONE else NONE

    def swing_left(self, c: int) -> int:
        o = self.opposite[next_corner(c)]
        return next_corner(o) if o != NONE else NONE

    def get_left_corner(self, c: int) -> int:
        return int(self.opposite[prev_corner(c)])

    def get_right_corner(self, c: int) -> int:
        return int(self.opposite[next_corner(c)])

    def left_most_corner(self, v: int) -> int:
        return int(self.left_most[v])

    def is_on_boundary(self, v: int) -> bool:
        return self.swing_left(int(self.left_most[v])) == NONE

    def vertex_valence(self, v: int) -> int:
        """Number of corners on the vertex (correct implementation; the
        reference's version at mod.rs:419-430 loops on a constant corner)."""
        c0 = int(self.left_most[v])
        count = 1
        c = self.swing_right(c0)
        while c != NONE and c != c0:
            count += 1
            c = self.swing_right(c)
        return count

    # --- construction -------------------------------------------------------
    def _contains_non_manifold_edges(self) -> bool:
        v = self.corner_to_vertex.reshape(-1, 3)
        edges = np.concatenate([v[:, [0, 1]], v[:, [1, 2]], v[:, [2, 0]]])
        edges.sort(axis=1)
        _, counts = np.unique(edges, axis=0, return_counts=True)
        return bool((counts > 2).any())

    def _compute_table(self):
        """Half-edge matching in corner order (mod.rs:252-340), including the
        reference's quirks: degenerate skip only at a face's first corner,
        and the tip-vertex-match abort."""
        C = self.num_corners
        ctv = self.corner_to_vertex
        counts = np.bincount(ctv, minlength=self.num_vertices)
        offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))

        edge_sink = np.full(C, NONE, dtype=np.int64)   # sink vertex per slot
        edge_corner = np.full(C, NONE, dtype=np.int64)

        for c in range(C):
            tip_v = ctv[c]
            source_v = ctv[next_corner(c)]
            sink_v = ctv[prev_corner(c)]

            if c % 3 == 0 and (tip_v == source_v or tip_v == sink_v
                               or source_v == sink_v):
                continue  # degenerate face, skipped at its first corner only

            opposite_c = NONE
            n_on_sink = counts[sink_v]
            off = offsets[sink_v]
            for _ in range(n_on_sink):
                other_v = edge_sink[off]
                if other_v == NONE:
                    break
                if other_v == source_v:
                    if tip_v == ctv[edge_corner[off]]:
                        # reference quirk (mod.rs:308-310): same tip vertex —
                        # the scan never advances, so no match is made
                        break
                    opposite_c = edge_corner[off]
                    # remove the matched half-edge by shifting the bucket
                    for _ in range(1, n_on_sink - (off - offsets[sink_v])):
                        edge_sink[off] = edge_sink[off + 1]
                        edge_corner[off] = edge_corner[off + 1]
                        if edge_sink[off] == NONE:
                            break
                        off += 1
                    edge_sink[off] = NONE
                    break
                off += 1

            if opposite_c == NONE:
                first = offsets[source_v]
                for slot in range(first, first + counts[source_v]):
                    if edge_sink[slot] == NONE:
                        edge_sink[slot] = sink_v
                        edge_corner[slot] = c
                        break
            else:
                self.opposite[c] = opposite_c
                self.opposite[opposite_c] = c

    def _handle_non_manifold_edges(self):
        """Break connectivity at non-manifold edges (mod.rs:149-234).

        Note: ``visited`` persists across outer passes, as in the reference —
        later passes only process corners left unvisited by a mid-fan break."""
        visited = np.zeros(self.num_corners, dtype=bool)
        while True:
            connectivity_updated = False
            for c in range(self.num_corners):
                if visited[c]:
                    continue
                sink_vertices: list[tuple[int, int]] = []

                # swing left to the left-most corner
                first_c = c
                curr_c = c
                nxt = self.swing_left(curr_c)
                while nxt != NONE and nxt != first_c and not visited[nxt]:
                    curr_c = nxt
                    nxt = self.swing_left(curr_c)

                first_c = curr_c
                while True:
                    visited[curr_c] = True
                    sink_c = next_corner(curr_c)
                    sink_v = self.vertex(sink_c)
                    edge_c = prev_corner(curr_c)
                    updated = False
                    for other_sink_v, other_edge_c in sink_vertices:
                        if other_sink_v != sink_v:
                            continue
                        opp_edge_c = self.opp(edge_c)
                        if opp_edge_c != NONE and opp_edge_c == other_edge_c:
                            continue
                        opp_other_edge_c = self.opp(other_edge_c)
                        if opp_edge_c != NONE:
                            self.opposite[opp_edge_c] = NONE
                        if opp_other_edge_c != NONE:
                            self.opposite[opp_other_edge_c] = NONE
                        self.opposite[edge_c] = NONE
                        self.opposite[other_edge_c] = NONE
                        updated = True
                        break
                    if updated:
                        connectivity_updated = True
                        break
                    sink_vertices.append(
                        (self.vertex(prev_corner(curr_c)), sink_c))
                    curr_c = self.swing_right(curr_c)
                    if curr_c == NONE or curr_c == first_c:
                        break
            if not connectivity_updated:
                break

    def _compute_left_most_corners(self):
        """Left-most corner per vertex; duplicates non-manifold vertices
        (mod.rs:342-416)."""
        visited_vertices = np.zeros(self.num_vertices, dtype=bool).tolist()
        visited_corners = np.zeros(self.num_corners, dtype=bool)
        left_most = self.left_most.tolist()

        for c in range(self.num_corners):
            if visited_corners[c]:
                continue
            v = self.vertex(c)
            is_non_manifold = False
            if visited_vertices[v]:
                # non-manifold vertex: split off a new vertex
                left_most.append(NONE)
                self.non_manifold_vertex_parents.append(v)
                visited_vertices.append(False)
                v = self.num_vertices
                self.num_vertices += 1
                is_non_manifold = True
            visited_vertices[v] = True
            visited_corners[c] = True
            left_most[v] = c
            if is_non_manifold:
                self.corner_to_vertex[c] = v

            act_c = self.swing_left(c)
            hit_start = False
            while act_c != NONE:
                if act_c == c:
                    hit_start = True
                    break
                visited_corners[act_c] = True
                left_most[v] = act_c
                if is_non_manifold:
                    self.corner_to_vertex[act_c] = v
                act_c = self.swing_left(act_c)

            if not hit_start:
                # open boundary: sweep right to mark the whole fan
                act_c = c
                while act_c != NONE:
                    visited_corners[act_c] = True
                    if is_non_manifold:
                        self.corner_to_vertex[act_c] = v
                    act_c = self.swing_right(act_c)

        self.left_most = np.asarray(left_most, dtype=np.int64)


def recompute_attribute_vertices(ct, is_edge_on_seam: np.ndarray,
                                 is_vertex_on_seam: np.ndarray,
                                 att_unique_of_point=None):
    """Split vertices at seam edges (attribute_corner_table.rs:79-137).

    ``ct`` provides universal navigation (left_most, swing_right, point,
    num_vertices); seam-aware swing-left uses ``is_edge_on_seam``.
    Returns (corner_to_vertex, left_most_per_new_vertex, num_new_vertices,
    vertex_to_attribute_map-or-None)."""
    from ..native import topo as _ntopo

    opposite = getattr(ct, "opposite", None)
    if opposite is not None:
        if hasattr(ct, "faces_points"):
            pts = np.asarray(ct.faces_points, dtype=np.int64).ravel()
        else:  # decoder table: point(c) == c
            pts = np.arange(ct.num_corners, dtype=np.int64)
        res = _ntopo.recompute_attribute_vertices(
            opposite, pts, np.asarray(ct.left_most, dtype=np.int64),
            is_edge_on_seam, is_vertex_on_seam, att_unique_of_point,
            ct.num_vertices)
        if res is not None:
            return res

    def seam_swing_left(c: int) -> int:
        nc = next_corner(c)
        if is_edge_on_seam[nc]:
            return NONE
        o = ct.opp(nc)
        return next_corner(o) if o != NONE else NONE

    corner_to_vertex = np.zeros(ct.num_corners, dtype=np.int64)
    left_most: list[int] = []
    v2a: list[int] | None = [] if att_unique_of_point is not None else None
    num_new = 0
    for v in range(ct.num_vertices):
        c = ct.left_most_corner(v)
        first_vert_id = num_new
        num_new += 1
        if v2a is not None:
            v2a.append(int(att_unique_of_point[ct.point(c)]))
        first_c = c
        if is_vertex_on_seam[v]:
            curr = seam_swing_left(first_c)
            while curr != NONE:
                first_c = curr
                if curr == c:
                    raise ValueError("closed loop on a seam vertex")
                curr = seam_swing_left(curr)
        corner_to_vertex[first_c] = first_vert_id
        left_most.append(first_c)
        curr = ct.swing_right(first_c)  # universal swing (reference quirk)
        while curr != NONE and curr != first_c:
            if is_edge_on_seam[next_corner(curr)]:
                first_vert_id = num_new
                num_new += 1
                if v2a is not None:
                    v2a.append(int(att_unique_of_point[ct.point(curr)]))
                left_most.append(curr)
            corner_to_vertex[curr] = first_vert_id
            curr = ct.swing_right(curr)
    return corner_to_vertex, left_most, num_new, v2a


class AttributeCornerTable:
    """Per-attribute connectivity with seam edges where the attribute value
    differs across an edge (attribute_corner_table.rs)."""

    def __init__(self, corner_table: CornerTable, att) -> None:
        ct = corner_table
        C = ct.num_corners
        self.is_edge_on_seam = np.zeros(C, dtype=bool)
        self.is_vertex_on_seam = np.zeros(ct.num_vertices, dtype=bool)

        corners = np.arange(C, dtype=np.int64)
        opp = ct.opposite
        ctv = ct.corner_to_vertex
        att_idx_of_corner = att.unique_indices()[ct.faces_points.ravel()]

        # boundary edges are seams
        boundary = opp == NONE
        self.is_edge_on_seam[boundary] = True
        bc = corners[boundary]
        self.is_vertex_on_seam[ctv[next_corners(bc)]] = True
        self.is_vertex_on_seam[ctv[prev_corners(bc)]] = True

        # interior edges: seam if the attribute value differs on either end
        # (attribute_corner_table.rs:43-63: compare next(c) vs prev(opp) and
        # prev(c) vs next(opp))
        interior = (~boundary) & (opp > corners)
        ic = corners[interior]
        io = opp[interior]
        seam = ((att_idx_of_corner[next_corners(ic)]
                 != att_idx_of_corner[prev_corners(io)])
                | (att_idx_of_corner[prev_corners(ic)]
                   != att_idx_of_corner[next_corners(io)]))
        sc, so = ic[seam], io[seam]
        self.is_edge_on_seam[sc] = True
        self.is_edge_on_seam[so] = True
        for arr in (sc, so):
            self.is_vertex_on_seam[ctv[next_corners(arr)]] = True
            self.is_vertex_on_seam[ctv[prev_corners(arr)]] = True

        self._ct_ref = ct
        (self.corner_to_vertex, self.left_most, self.num_vertices,
         self.vertex_to_attribute_map) = recompute_attribute_vertices(
            ct, self.is_edge_on_seam, self.is_vertex_on_seam,
            att.unique_indices())

    # seam-aware navigation (universal next/prev, seam-filtered opposite)
    def opp(self, c: int, ct: CornerTable) -> int:
        if self.is_edge_on_seam[c]:
            return NONE
        return ct.opp(c)

    def swing_right(self, c: int, ct: CornerTable) -> int:
        o = self.opp(prev_corner(c), ct)
        return prev_corner(o) if o != NONE else NONE

    def swing_left(self, c: int, ct: CornerTable) -> int:
        o = self.opp(next_corner(c), ct)
        return next_corner(o) if o != NONE else NONE

    def vertex(self, c: int) -> int:
        return int(self.corner_to_vertex[c])

    def left_most_corner(self, v: int) -> int:
        return int(self.left_most[v])

    def is_on_boundary(self, v: int) -> bool:
        return self.swing_left(int(self.left_most[v]), self._ct_ref) == NONE


class TableView:
    """Uniform navigation interface over the universal corner table or an
    attribute corner table (mirror of GenericCornerTable /
    RefAttributeCornerTable in all_inclusive_corner_table.rs)."""

    def __init__(self, universal: CornerTable,
                 att_table: "AttributeCornerTable | None" = None) -> None:
        self.u = universal
        self.a = att_table

    @property
    def num_corners(self) -> int:
        return self.u.num_corners

    def num_faces(self) -> int:
        return self.u.num_faces()

    @property
    def num_vertices(self) -> int:
        return self.a.num_vertices if self.a is not None else self.u.num_vertices

    def point(self, c: int) -> int:
        return self.u.point(c)

    def vertex(self, c: int) -> int:
        return self.a.vertex(c) if self.a is not None else self.u.vertex(c)

    def opp(self, c: int) -> int:
        if self.a is not None:
            return self.a.opp(c, self.u)
        return self.u.opp(c)

    def left_most_corner(self, v: int) -> int:
        if self.a is not None:
            return self.a.left_most_corner(v)
        return int(self.u.left_most[v])

    def get_right_corner(self, c: int) -> int:
        return self.opp(next_corner(c))

    def get_left_corner(self, c: int) -> int:
        return self.opp(prev_corner(c))

    def swing_right(self, c: int) -> int:
        o = self.opp(prev_corner(c))
        return prev_corner(o) if o != NONE else NONE

    def swing_left(self, c: int) -> int:
        o = self.opp(next_corner(c))
        return next_corner(o) if o != NONE else NONE

    def is_on_boundary(self, v: int) -> bool:
        return self.swing_left(self.left_most_corner(v)) == NONE

    def as_arrays(self):
        """(effective opposite, corner_to_vertex, left_most) numpy arrays for
        the native topology passes (seam-masked for attribute tables)."""
        if self.a is not None:
            eff_opp = np.where(self.a.is_edge_on_seam, NONE, self.u.opposite)
            return (eff_opp, self.a.corner_to_vertex,
                    np.asarray(self.a.left_most, dtype=np.int64))
        return self.u.opposite, self.u.corner_to_vertex, self.u.left_most


class AllInclusiveCornerTable:
    """Universal table + per-attribute tables, handed from the connectivity
    encoder to the attribute encoder (all_inclusive_corner_table.rs).

    ``attribute_tables[i]`` is None when attribute i uses the universal
    table (the position attribute / attributes without seams)."""

    def __init__(self, corner_table: CornerTable,
                 attribute_tables: list[AttributeCornerTable | None]) -> None:
        self.corner_table = corner_table
        self.attribute_tables = attribute_tables

"""Attribute traversal sequencers: produce the vertex-visit sequence
consumed by the attribute prediction pipeline (both encoder and decoder).

Depth-first (wire TraversalType=0) replays the edgebreaker decode order.
Reference behavior: draco-oxide/src/shared/attribute/sequence.rs. The
reference prunes handle entries with an O(stack) scan per face
(sequence.rs:98-131); we keep identical semantics with O(1) amortized lazy
deletion (entries are tagged and tombstoned per face).

Prediction-degree (wire TraversalType=1) prioritizes corners whose tip
vertex already has prediction support. The reference declares the variant
but ships no sequencer (shared/connectivity/edgebreaker/mod.rs:59-88 —
enum + wire bytes only, flagged dead_code); this is the working form.
"""

from __future__ import annotations

import numpy as np

from ..models.corner_table import NONE, TableView


def compute_sequence(view: TableView, init_stack: list[int]) -> list[int]:
    """Returns the corner-visit sequence (one corner per newly visited
    vertex), seeded with the edgebreaker's component corners
    (sequence.rs:48-152). ``init_stack`` is consumed (popped from the end)."""
    if hasattr(view, "as_arrays"):
        from ..native import topo
        arrays = view.as_arrays()
        out = topo.sequence(arrays[0], arrays[1], arrays[2], init_stack)
        if out is not None:
            return out.tolist()
    visited_vertices = [False] * view.num_vertices
    visited_faces = [False] * view.num_faces()
    out: list[int] = []

    # stack entries are (corner, serial); prune marks serials dead
    stack: list[tuple[int, int]] = [(c, i) for i, c in enumerate(init_stack)]
    serial = len(init_stack)
    dead: set[int] = set()
    face_entries: dict[int, list[int]] = {}
    for c, s in stack:
        face_entries.setdefault(c // 3, []).append(s)

    def push(c: int) -> None:
        nonlocal serial
        stack.append((c, serial))
        face_entries.setdefault(c // 3, []).append(serial)
        serial += 1

    def prune(face_idx: int) -> None:
        ids = face_entries.get(face_idx)
        if ids:
            dead.update(ids)
            ids.clear()

    def visit(v: int, c: int) -> None:
        if not visited_vertices[v]:
            out.append(c)
        visited_vertices[v] = True

    while stack:
        curr, sid = stack.pop()
        if sid in dead:
            dead.discard(sid)
            continue
        # keep face_entries consistent: this entry is consumed
        ids = face_entries.get(curr // 3)
        if ids and sid in ids:
            ids.remove(sid)
        if visited_faces[curr // 3]:
            continue
        v = view.vertex(curr)
        next_c = curr - 2 if curr % 3 == 2 else curr + 1
        prev_c = curr + 2 if curr % 3 == 0 else curr - 1
        next_v = view.vertex(next_c)
        prev_v = view.vertex(prev_c)
        if not visited_vertices[next_v] or not visited_vertices[prev_v]:
            # draco order: next corner first, then previous, then current
            visit(next_v, next_c)
            visit(prev_v, prev_c)
            push(curr)
            continue

        face_idx = curr // 3
        visited_faces[face_idx] = True

        if not visited_vertices[v]:
            visit(v, curr)
            if not view.is_on_boundary(v):
                push(view.get_right_corner(curr))
                continue

        visit(v, curr)

        right_c = view.get_right_corner(curr)
        left_c = view.get_left_corner(curr)
        right_visited = right_c != NONE and visited_faces[right_c // 3]
        left_visited = left_c != NONE and visited_faces[left_c // 3]

        if right_visited:
            prune(face_idx)
            if not left_visited and left_c != NONE:
                push(left_c)
        else:
            if left_visited:
                prune(face_idx)
                if right_c != NONE:
                    push(right_c)
            else:
                if left_c != NONE:
                    push(left_c)
                if right_c != NONE:
                    push(right_c)
    return out


# prediction-degree priority levels: 0 = tip already visited (free),
# 1 = tip has parallelogram support building up (degree > 1), 2 = first
# touch. Mirrors Google Draco's MaxPredictionDegreeTraverser (kMaxPriority)
_PD_MAX_PRIORITY = 3


def compute_sequence_prediction_degree(view, init_stack: list[int]
                                       ) -> list[int]:
    """Max-prediction-degree traversal (wire TraversalType=1): corners wait
    in three priority stacks; corners whose tip vertex is already visited
    drain first, then tips whose prediction degree (number of traversal
    touches so far) exceeds one, then first-touch corners — so vertices
    tend to be sequenced when a full parallelogram is available, improving
    residual compression on regular meshes. Depends only on topology, so
    the decoder replays the identical sequence from the connectivity
    section. Visits the same vertex set as compute_sequence (pinned by
    tests); ``init_stack`` seeds are consumed from the end, matching the
    depth-first sequencer's pop order."""
    if hasattr(view, "as_arrays"):
        opp_a, ctv_a, _lm = view.as_arrays()
        opp = np.asarray(opp_a, dtype=np.int64)
        ctv = np.asarray(ctv_a, dtype=np.int64)
        num_faces = len(ctv) // 3
    else:  # pragma: no cover - every view in the codec has as_arrays
        num_faces = view.num_faces()
        ctv = np.array([view.vertex(c) for c in range(3 * num_faces)],
                       dtype=np.int64)
        opp = np.array([view.opp(c) for c in range(3 * num_faces)],
                       dtype=np.int64)

    visited_v = np.zeros(view.num_vertices, dtype=bool)
    visited_f = np.zeros(num_faces, dtype=bool)
    pred_degree = np.zeros(view.num_vertices, dtype=np.int32)
    out: list[int] = []
    stacks: tuple[list[int], ...] = ([], [], [])
    best = 0

    def visit(v: int, c: int) -> None:
        visited_v[v] = True
        out.append(c)

    def compute_priority(c: int) -> int:
        v = int(ctv[c])
        if visited_v[v]:
            return 0
        pred_degree[v] += 1
        return 1 if pred_degree[v] > 1 else 2

    def pop_next() -> int:
        nonlocal best
        for i in range(best, _PD_MAX_PRIORITY):
            if stacks[i]:
                best = i
                return stacks[i].pop()
        return NONE

    for seed in reversed(init_stack):
        if visited_f[seed // 3]:
            continue
        best = 0
        stacks[0].append(seed)
        nc = seed - 2 if seed % 3 == 2 else seed + 1
        pc = seed + 2 if seed % 3 == 0 else seed - 1
        for cc in (nc, pc, seed):  # draco order: next, previous, tip
            vv = int(ctv[cc])
            if not visited_v[vv]:
                visit(vv, cc)
        while True:
            c = pop_next()
            if c == NONE:
                break
            if visited_f[c // 3]:
                continue
            while True:
                visited_f[c // 3] = True
                v = int(ctv[c])
                if not visited_v[v]:
                    visit(v, c)
                ncc = c - 2 if c % 3 == 2 else c + 1
                pcc = c + 2 if c % 3 == 0 else c - 1
                rc = int(opp[ncc])
                lc = int(opp[pcc])
                r_done = rc == NONE or visited_f[rc // 3]
                l_done = lc == NONE or visited_f[lc // 3]
                if not l_done:
                    pr = compute_priority(lc)
                    if r_done and pr <= best:
                        c = lc
                        continue
                    stacks[pr].append(lc)
                    if pr < best:
                        best = pr
                if not r_done:
                    pr = compute_priority(rc)
                    if pr <= best:
                        c = rc
                        continue
                    stacks[pr].append(rc)
                    if pr < best:
                        best = pr
                break
    return out

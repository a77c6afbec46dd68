"""Host topology pass producing the gather/mask arrays consumed by the
device prediction kernels.

The encoder-side parallelogram prediction is a pure gather once the
traversal order and visited-before masks are known (the decoder's
sequential dependency does not exist on the encoder: all values are
available). This is the central device-side restructuring of the reference's
per-vertex loop (attribute_encoder.rs:332-338).
"""

from __future__ import annotations

import numpy as np

from ..models.corner_table import NONE, next_corner, prev_corner


def build_parallelogram_gathers(view, sequence, unique_of_point: np.ndarray) -> dict:
    """For each traversal step, the value indices of next/prev/opposite
    corners, the fallback (most recent) value index, and validity masks.

    Mirrors mesh_parallelogram_prediction.rs:186-237 exactly."""
    T = len(sequence)
    order = np.zeros(T, dtype=np.int32)
    g_next = np.zeros(T, dtype=np.int32)
    g_prev = np.zeros(T, dtype=np.int32)
    g_opp = np.zeros(T, dtype=np.int32)
    g_fb = np.zeros(T, dtype=np.int32)
    can_para = np.zeros(T, dtype=bool)
    has_fb = np.zeros(T, dtype=bool)

    visited = np.zeros(view.num_vertices, dtype=bool)
    last_v = -1
    for k, c in enumerate(sequence):
        p = view.point(c)
        order[k] = unique_of_point[p]
        opp = view.opp(c)
        if opp != NONE:
            nc, pc = next_corner(c), prev_corner(c)
            if (visited[view.vertex(opp)] and visited[view.vertex(nc)]
                    and visited[view.vertex(pc)]):
                can_para[k] = True
                g_next[k] = unique_of_point[view.point(nc)]
                g_prev[k] = unique_of_point[view.point(pc)]
                g_opp[k] = unique_of_point[view.point(opp)]
        if not can_para[k] and last_v >= 0:
            has_fb[k] = True
            g_fb[k] = unique_of_point[view.point(view.left_most_corner(last_v))]
        v = view.vertex(c)
        visited[v] = True
        last_v = v
    return {"order": order, "next": g_next, "prev": g_prev, "opp": g_opp,
            "fallback": g_fb, "can_para": can_para, "has_fallback": has_fb}

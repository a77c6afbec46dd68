"""Geometry helpers (vectorized): point-to-triangle / point-to-line
distances used by the diff_l2_norm quality metric.

Reference behavior: draco-oxide/src/utils/geom.rs:9-42.
"""

from __future__ import annotations

import numpy as np


def _normalize(v: np.ndarray, axis: int = -1) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.where(n == 0, 1.0, n)


def point_to_line_distance(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance from points p (..., 3) to the infinite line through a-b."""
    d = _normalize(b - a)
    pa = p - a
    perp = pa - d * np.sum(pa * d, axis=-1, keepdims=True)
    return np.linalg.norm(perp, axis=-1)


def point_to_face_distance(p: np.ndarray, v0, v1, v2) -> np.ndarray:
    """Distance from points p (..., 3) to triangles (v0, v1, v2), matching
    the reference heuristic (geom.rs:9-32): plane distance when the
    projection lands inside the face, else the min of the three line
    distances and the three edge lengths."""
    x = v1 - v0
    y = v2 - v0
    n = _normalize(np.cross(x, y))
    dist_plane = np.abs(np.sum(n * (p - v0), axis=-1))

    proj = p - n * dist_plane[..., None]

    def _side(q, a, b, c):
        return (np.sum((q - a) * (b - a), axis=-1)
                * np.sum((c - a) * (b - a), axis=-1))

    inside = ((_side(proj, v0, v1, v2) > 0)
              & (_side(proj, v1, v2, v0) > 0)
              & (_side(proj, v2, v0, v1) > 0))

    alt = np.minimum.reduce([
        point_to_line_distance(p, v0, v1),
        point_to_line_distance(p, v1, v2),
        point_to_line_distance(p, v2, v0),
        np.linalg.norm(v1 - v0, axis=-1) * np.ones_like(dist_plane),
        np.linalg.norm(v2 - v1, axis=-1) * np.ones_like(dist_plane),
        np.linalg.norm(v0 - v2, axis=-1) * np.ones_like(dist_plane),
    ])
    return np.where(inside, dist_plane, alt)


def min_dist_points_to_faces(points: np.ndarray, faces: np.ndarray,
                             pos_att) -> np.ndarray:
    """Min distance from each point to any face of the target mesh."""
    if len(faces) == 0:
        return np.zeros(len(points))
    idx = pos_att.unique_indices()
    verts = pos_att.values.astype(np.float64)
    tri = verts[idx[faces]]  # (F, 3, 3)
    # broadcast points (P, 1, 3) against faces (1, F, 3)
    p = points[:, None, :]
    d = point_to_face_distance(p, tri[None, :, 0], tri[None, :, 1], tri[None, :, 2])
    return d.min(axis=1)

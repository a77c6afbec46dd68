"""Connectivity isomorphism check via the edge Hodge-Laplacian spectrum.

Mirrors the reference test utility `weak_eq_by_laplacian`
(draco-oxide/src/shared/connectivity/eq.rs:4-120): two triangle meshes are
"weakly equal" when the sorted eigenvalue spectra of their edge Laplacians
(L1 = L1-down + L1-up) agree. Invariant under vertex relabeling and face
reordering, so it is the oracle for decoder output whose vertex order
legitimately differs from the input. This is a *necessary* condition for
isomorphism (cospectral non-isomorphic meshes exist), which is what "weak"
means here — same contract as the reference.
"""

from __future__ import annotations

import numpy as np


def _edge_laplacian_spectrum(faces: np.ndarray) -> np.ndarray:
    """Sorted eigenvalues of L1 = d0 d0^T + d1^T d1 for the mesh's edge
    complex: d0 maps vertices to oriented edges, d1 maps edges to oriented
    triangles."""
    faces = np.asarray(faces, dtype=np.int64)
    if faces.size == 0:
        return np.zeros(0)
    # canonical undirected edges with orientation sign
    e0 = faces[:, [0, 1, 2]].ravel()
    e1 = faces[:, [1, 2, 0]].ravel()
    lo, hi = np.minimum(e0, e1), np.maximum(e0, e1)
    sign = np.where(e0 < e1, 1.0, -1.0)
    keys = lo * (faces.max() + 1) + hi
    uniq, edge_idx = np.unique(keys, return_inverse=True)
    E = len(uniq)
    V = int(faces.max()) + 1
    F = len(faces)

    # d0: (E, V) — edge (lo -> hi): -1 at lo, +1 at hi
    d0 = np.zeros((E, V))
    # first occurrence of each unique edge gives its endpoints
    first = np.full(E, len(keys), dtype=np.int64)
    np.minimum.at(first, edge_idx, np.arange(len(keys)))
    d0[np.arange(E), lo[first]] = -1.0
    d0[np.arange(E), hi[first]] = 1.0

    # d1: (F, E) — face boundary with orientation sign per half-edge
    d1 = np.zeros((F, E))
    rows = np.repeat(np.arange(F), 3)
    np.add.at(d1, (rows, edge_idx), sign)

    l1 = d0 @ d0.T + d1.T @ d1
    return np.sort(np.linalg.eigvalsh(l1))


def weak_eq_by_laplacian(faces_a: np.ndarray, faces_b: np.ndarray,
                         tol: float = 1e-6) -> bool:
    """True when the two connectivities have identical edge-Laplacian
    spectra (up to ``tol``), i.e. are plausibly isomorphic."""
    sa = _edge_laplacian_spectrum(faces_a)
    sb = _edge_laplacian_spectrum(faces_b)
    if sa.shape != sb.shape:
        return False
    if sa.size == 0:
        return True
    return bool(np.max(np.abs(sa - sb)) <= tol * max(1.0, np.max(np.abs(sa))))

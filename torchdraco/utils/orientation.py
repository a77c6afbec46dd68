"""Consistent face orientation for triangle meshes.

The Draco corner table (reference core/corner_table/mod.rs:252-341, and
ours) pairs half-edges only in opposite directions, exactly like Google
Draco: an inconsistently-oriented mesh therefore decomposes at every
same-direction duplicate edge (those edges become boundary). Neither Draco
nor the reference reorients input. This utility lets callers normalize
orientation beforehand when they want such meshes to stay connected.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np


def orient_faces(faces: np.ndarray) -> np.ndarray:
    """Flip faces (BFS over shared edges) so every interior edge appears in
    both directions. Per connected component the seed face's winding is
    kept, so globally the result is deterministic. Non-orientable surfaces
    (Möbius-like) are left best-effort: some edge pair will remain
    same-direction and will decompose in the corner table, mirroring
    Draco's behavior."""
    faces = np.asarray(faces, dtype=np.int64).copy()
    n = len(faces)
    edge_faces: dict[tuple[int, int], list[int]] = defaultdict(list)
    for i in range(n):
        f = faces[i]
        for k in range(3):
            a, b = int(f[k]), int(f[(k + 1) % 3])
            edge_faces[(min(a, b), max(a, b))].append(i)

    seen = np.zeros(n, dtype=bool)
    for s in range(n):
        if seen[s]:
            continue
        seen[s] = True
        queue = deque([s])
        while queue:
            i = queue.popleft()
            f = faces[i]
            dirs = {(int(f[k]), int(f[(k + 1) % 3])) for k in range(3)}
            for k in range(3):
                a, b = int(f[k]), int(f[(k + 1) % 3])
                for j in edge_faces[(min(a, b), max(a, b))]:
                    if j == i or seen[j]:
                        continue
                    g = faces[j]
                    gdirs = {(int(g[m]), int(g[(m + 1) % 3]))
                             for m in range(3)}
                    if (a, b) in gdirs:  # same direction -> flip neighbor
                        faces[j] = faces[j][[0, 2, 1]]
                    seen[j] = True
                    queue.append(j)
    return faces


def is_consistently_oriented(faces: np.ndarray) -> bool:
    """True iff no directed edge appears twice."""
    faces = np.asarray(faces, dtype=np.int64)
    a = faces
    b = np.roll(faces, -1, axis=1)
    keys = (a.ravel().astype(np.uint64) << np.uint64(32)) | \
        b.ravel().astype(np.uint64)
    return len(np.unique(keys)) == keys.size

"""Wavefront OBJ loader.

Replicates the reference's tobj usage with ``triangulate + single_index``
(io/obj/mod.rs:14-64): every distinct (v, vt, vn) index triple becomes one
point (in first-appearance order), polygons are fan-triangulated, positions
load as a POSITION/Position-domain attribute, normals/texcoords as
Corner-domain attributes with the position attribute as parent.

Exceeds the reference: ``v x y z r g b`` vertex colors (the de-facto
extension Google draco / MeshLab read and write — the reference's tobj
options drop them) round-trip as a float32 COLOR attribute.
"""

from __future__ import annotations

import numpy as np

from ..models import AttributeDomain, AttributeType, Mesh, MeshBuilder


def load_obj(path) -> Mesh:
    positions: list[list[float]] = []
    colors: list[list[float] | None] = []
    texcoords: list[list[float]] = []
    normals: list[list[float]] = []
    triple_to_point: dict[tuple, int] = {}
    point_triples: list[tuple] = []
    faces: list[list[int]] = []

    def resolve(idx: str, n: int) -> int | None:
        if not idx:
            return None
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
                # "v x y z r g b" vertex-color extension
                colors.append([float(x) for x in parts[4:7]]
                              if len(parts) >= 7 else None)
            elif tag == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                pts = []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = resolve(comps[0], len(positions))
                    ti = resolve(comps[1] if len(comps) > 1 else "", len(texcoords))
                    ni = resolve(comps[2] if len(comps) > 2 else "", len(normals))
                    triple = (vi, ti, ni)
                    if triple not in triple_to_point:
                        triple_to_point[triple] = len(point_triples)
                        point_triples.append(triple)
                    pts.append(triple_to_point[triple])
                for k in range(1, len(pts) - 1):  # fan triangulation
                    faces.append([pts[0], pts[k], pts[k + 1]])

    pos = np.asarray(positions, dtype=np.float32)
    builder = MeshBuilder()
    builder.set_connectivity_attribute(np.asarray(faces, dtype=np.int64))

    vi = np.asarray([t[0] for t in point_triples], dtype=np.int64)
    pos_id = builder.add_attribute(pos[vi], AttributeType.POSITION,
                                   AttributeDomain.POSITION)
    if colors and all(c is not None for c in colors):
        col = np.asarray(colors, dtype=np.float32)
        builder.add_attribute(col[vi], AttributeType.COLOR,
                              AttributeDomain.POSITION)
    has_n = normals and all(t[2] is not None for t in point_triples)
    if has_n:
        ni = np.asarray([t[2] for t in point_triples], dtype=np.int64)
        builder.add_attribute(np.asarray(normals, dtype=np.float32)[ni],
                              AttributeType.NORMAL, AttributeDomain.CORNER,
                              parents=[pos_id])
    has_t = texcoords and all(t[1] is not None for t in point_triples)
    if has_t:
        ti = np.asarray([t[1] for t in point_triples], dtype=np.int64)
        builder.add_attribute(np.asarray(texcoords, dtype=np.float32)[ti],
                              AttributeType.TEX_COORD, AttributeDomain.CORNER,
                              parents=[pos_id])
    return builder.build()


def save_obj(mesh: Mesh, path) -> None:
    """Minimal OBJ writer (positions + faces, plus normals/texcoords and
    ``v x y z r g b`` vertex colors when present) — used by the analyzer
    round-trip tooling."""
    pos = mesh.position_attribute()
    pos_vals = pos.values_per_point()
    normals = mesh.attributes_of_type(AttributeType.NORMAL)
    texs = mesh.attributes_of_type(AttributeType.TEX_COORD)
    col_atts = [a for a in mesh.attributes_of_type(AttributeType.COLOR)
                if a.num_components == 3
                and np.issubdtype(a.values.dtype, np.floating)]
    col_vals = col_atts[0].values_per_point() if col_atts else None
    with open(path, "w", encoding="utf-8") as f:
        if col_vals is not None:
            for v, c in zip(pos_vals, col_vals):
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in pos_vals:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if texs:
            for t in texs[0].values_per_point():
                f.write(f"vt {t[0]} {t[1]}\n")
        if normals:
            for n in normals[0].values_per_point():
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for face in mesh.faces:
            idx = [str(int(p) + 1) for p in face]
            if texs and normals:
                f.write("f " + " ".join(f"{i}/{i}/{i}" for i in idx) + "\n")
            elif texs:
                f.write("f " + " ".join(f"{i}/{i}" for i in idx) + "\n")
            elif normals:
                f.write("f " + " ".join(f"{i}//{i}" for i in idx) + "\n")
            else:
                f.write("f " + " ".join(idx) + "\n")

"""MeshBuilder: normalizes raw input into a canonical Mesh.

Pipeline (vectorized equivalents of draco-oxide/src/core/mesh/builder.rs):
  1. dependency check (builder.rs:94-111)
  2. position attribute sorted first (builder.rs:115-125)
  3. point dedup by hashing all attribute values per point (builder.rs:194-279)
  4. degenerate-face filter (builder.rs:77-79)
  5. unused-point removal with face remap (builder.rs:129-189)
"""

from __future__ import annotations

import numpy as np

from .. import trace
from .attribute import (Attribute, AttributeDomain, AttributeType,
                        first_occurrences)
from .mesh import Mesh


class MeshBuildError(Exception):
    pass


class MeshBuilder:
    def __init__(self) -> None:
        self.attributes: list[Attribute] = []
        self.faces = np.zeros((0, 3), dtype=np.int64)
        self._next_id = 0

    def set_connectivity_attribute(self, faces) -> None:
        self.faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)

    def add_attribute(self, data, att_type: AttributeType,
                      domain: AttributeDomain, parents=(),
                      name: str | None = None) -> int:
        att_id = self._next_id
        self._next_id += 1
        self.attributes.append(
            Attribute(data, att_type, domain, parents=parents, att_id=att_id,
                      name=name))
        return att_id

    def build(self) -> Mesh:
        self._dependency_check()
        attributes = self._sorted_attributes()
        faces = self.faces

        with trace.span("build.points") as s:
            attributes, faces = _deduplicate_points(attributes, faces, s)

        # degenerate-face filter (in point space)
        keep = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                & (faces[:, 2] != faces[:, 0]))
        faces = faces[keep]

        attributes, faces = _remove_unused_points(attributes, faces)
        return Mesh(faces=faces, attributes=attributes)

    def _dependency_check(self) -> None:
        for att in self.attributes:
            for dep in att.att_type.minimum_dependency():
                parent_types = {
                    a.att_type for a in self.attributes
                    if a.att_id in att.parents
                }
                if dep not in parent_types:
                    raise MeshBuildError(
                        f"{att.att_type.name} must depend on {dep.name}")

    def _sorted_attributes(self) -> list[Attribute]:
        atts = list(self.attributes)
        for i, a in enumerate(atts):
            if a.att_type == AttributeType.POSITION:
                atts[0], atts[i] = atts[i], atts[0]
                break
        return atts


def _deduplicate_points(attributes: list[Attribute], faces: np.ndarray,
                        span):
    """Merge points whose values agree across *all* attributes
    (builder.rs:194-279 hashes every attribute's bytes per point): the
    rows of each point's bytes through ``first_occurrences``. Notes
    ``rows``, ``unique`` and ``native`` on ``span`` (the open
    ``build.points``) where it ran."""
    if not attributes or len(faces) == 0:
        return attributes, faces
    num_points = int(faces.max()) + 1

    # each point's raw value bytes across all attributes, one row a point
    keys = [att.value_bytes_per_point(num_points) for att in attributes
            if att.num_points >= num_points]
    if not keys:
        return attributes, faces
    buf = np.concatenate(keys, axis=1)
    # unique points numbered in first-appearance order
    keep, point_mapping, hashed = first_occurrences(buf)
    span.note(rows=num_points, unique=len(keep), native=hashed)
    if len(keep) == num_points:
        return attributes, faces  # no duplicates

    for att in attributes:
        if att.num_points >= num_points:
            att.select_points(keep)
    faces = point_mapping[faces]
    return attributes, faces


def _remove_unused_points(attributes: list[Attribute], faces: np.ndarray):
    """Drop points not referenced by any face; remap faces
    (builder.rs:129-189)."""
    if len(faces) == 0 or not attributes:
        return attributes, faces
    max_idx = int(faces.max())
    used = np.zeros(max_idx + 1, dtype=bool)
    used[faces.ravel()] = True
    keep = np.nonzero(used)[0]
    if len(keep) == max_idx + 1 and all(
            a.num_points == max_idx + 1 for a in attributes):
        return attributes, faces
    for att in attributes:
        # also drops any points beyond max_idx (builder.rs:160-165)
        att.select_points(keep[keep < att.num_points])
    remap = np.cumsum(used) - 1
    return attributes, remap[faces]

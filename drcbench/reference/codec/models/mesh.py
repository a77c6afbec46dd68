"""Mesh: faces (F, 3) int array over point indices + attributes.

Reference behavior: draco-oxide/src/core/mesh/mod.rs:13-196 (Mesh,
diff_l2_norm quality metric).
"""

from __future__ import annotations

import numpy as np

from ..utils.geom import min_dist_points_to_faces
from .attribute import Attribute, AttributeType


class Mesh:
    def __init__(self, faces=None, attributes=None, name: str = "") -> None:
        self.faces = (np.zeros((0, 3), dtype=np.int64) if faces is None
                      else np.asarray(faces, dtype=np.int64).reshape(-1, 3))
        self.attributes: list[Attribute] = list(attributes or [])
        self.name = name
        self.material_library = None  # set by the glTF loader
        self.metadata = None  # optional models.metadata.GeometryMetadata

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    @property
    def num_points(self) -> int:
        return int(self.faces.max()) + 1 if len(self.faces) else 0

    def attributes_of_type(self, att_type: AttributeType) -> list[Attribute]:
        return [a for a in self.attributes if a.att_type == att_type]

    def position_attribute(self) -> Attribute:
        for a in self.attributes:
            if a.att_type == AttributeType.POSITION:
                return a
        raise ValueError("mesh has no position attribute")

    def diff_l2_norm(self, other: "Mesh") -> float:
        """Symmetric point-to-surface L2 quality metric
        (core/mesh/mod.rs:78-108): per position-attribute pair,
        sqrt(sum of squared min point->face distances both ways), summed,
        then sqrt(total)/num_points."""
        num_points = 0
        total = 0.0
        self_pos = self.attributes_of_type(AttributeType.POSITION)
        other_pos = other.attributes_of_type(AttributeType.POSITION)
        for a, b in zip(self_pos, other_pos):
            if a.num_components != 3 or b.num_components != 3:
                raise ValueError("position attribute must have 3 components")
            num_points += a.num_points + b.num_points
            pa = a.values.astype(np.float64)
            pb = b.values.astype(np.float64)
            d_ab = min_dist_points_to_faces(pa, other.faces, b)
            d_ba = min_dist_points_to_faces(pb, self.faces, a)
            total += np.sqrt(float(np.sum(d_ab ** 2) + np.sum(d_ba ** 2)))
        return float(np.sqrt(total) / num_points) if num_points else 0.0

    def __repr__(self) -> str:
        return (f"Mesh(name={self.name!r}, faces={self.num_faces}, "
                f"attributes={self.attributes})")

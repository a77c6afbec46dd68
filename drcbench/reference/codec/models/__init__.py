from .attribute import (
    Attribute,
    AttributeDomain,
    AttributeType,
    ComponentType,
    unique_rows_first_occurrence,
)
from .builder import MeshBuilder, MeshBuildError
from .corner_table import (
    NONE,
    AllInclusiveCornerTable,
    AttributeCornerTable,
    CornerTable,
    TableView,
    next_corner,
    next_corners,
    prev_corner,
    prev_corners,
    recompute_attribute_vertices,
)
from .mesh import Mesh
from .metadata import GeometryMetadata, MetadataEntry

__all__ = [
    "Attribute", "AttributeDomain", "AttributeType", "ComponentType",
    "unique_rows_first_occurrence",
    "MeshBuilder", "MeshBuildError",
    "NONE", "AllInclusiveCornerTable", "AttributeCornerTable", "CornerTable",
    "TableView", "recompute_attribute_vertices",
    "next_corner", "next_corners", "prev_corner", "prev_corners",
    "Mesh",
    "GeometryMetadata", "MetadataEntry",
]

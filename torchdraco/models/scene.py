"""Scene/asset model: node hierarchy, mesh groups, materials, textures,
structural metadata. Host-side metadata only — no device work.

Reference behavior: draco-oxide/src/core/scene/mod.rs (Scene, TrsMatrix,
MeshGroup/MeshInstance), core/material.rs, core/texture.rs,
core/structural_metadata.rs, core/mesh/{meh_features,metadata}.rs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TrsMatrix:
    """Translation-rotation-scale or explicit matrix transform
    (scene/mod.rs:272+)."""
    translation: np.ndarray | None = None  # (3,)
    rotation: np.ndarray | None = None     # (4,) quaternion xyzw
    scale: np.ndarray | None = None        # (3,)
    matrix: np.ndarray | None = None       # (4, 4)

    def compute_transformation_matrix(self) -> np.ndarray:
        if self.matrix is not None:
            return np.asarray(self.matrix, dtype=np.float64).reshape(4, 4)
        m = np.eye(4)
        if self.scale is not None:
            m[:3, :3] *= np.asarray(self.scale, dtype=np.float64)
        if self.rotation is not None:
            x, y, z, w = np.asarray(self.rotation, dtype=np.float64)
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            m[:3, :3] = r @ m[:3, :3]
        if self.translation is not None:
            m[:3, 3] = np.asarray(self.translation, dtype=np.float64)
        return m

    def is_identity(self) -> bool:
        return (self.matrix is None and self.translation is None
                and self.rotation is None and self.scale is None)


@dataclass
class SceneNode:
    name: str = ""
    children: list[int] = field(default_factory=list)
    parents: list[int] = field(default_factory=list)
    trs: TrsMatrix = field(default_factory=TrsMatrix)
    mesh_group_index: int | None = None
    skin_index: int | None = None
    light_index: int | None = None


@dataclass
class MeshInstance:
    """One (mesh, material) pairing inside a mesh group
    (scene/mod.rs:323-395)."""
    mesh_index: int
    material_index: int | None = None
    mesh_features: list = field(default_factory=list)
    # per-primitive EXT_structural_metadata refs (propertyAttributes /
    # propertyTextures index lists), raw-JSON passthrough
    structural_metadata: dict = field(default_factory=dict)
    # KHR_materials_variants per-primitive mappings
    # (reference core/scene MaterialsVariantsMapping, encode.rs:664);
    # entries are {"material": i, "variants": [..]} raw JSON
    materials_variants: list = field(default_factory=list)
    # morph targets: [{semantic: carried-accessor local id}] per target
    # (io/gltf.py carries the data; the reference rejects such inputs,
    # decode.rs:774-811 — carrying them exceeds it)
    morph_targets: list = field(default_factory=list)


@dataclass
class MeshGroup:
    name: str = ""
    instances: list[MeshInstance] = field(default_factory=list)
    # glTF mesh-level morph weights (carried with morph targets)
    weights: list = field(default_factory=list)


@dataclass
class TextureMap:
    texture_index: int
    tex_coord: int = 0
    transform: dict | None = None  # KHR_texture_transform passthrough


_MIME_BY_FORMAT = {"png": "image/png", "jpeg": "image/jpeg",
                   "webp": "image/webp", "basis": "image/basis",
                   "ktx2": "image/ktx2"}
_EXT_BY_FORMAT = {"png": ".png", "jpeg": ".jpg", "webp": ".webp",
                  "basis": ".basis", "ktx2": ".ktx2"}


@dataclass
class Image:
    name: str = ""
    mime_type: str = ""
    data: bytes = b""
    uri: str | None = None

    def sniff_format(self) -> str:
        """Magic-byte format sniffing (io/texture_io.rs:21-93)."""
        d = self.data
        if d[:8] == b"\x89PNG\r\n\x1a\n":
            return "png"
        if d[:2] == b"\xff\xd8":
            return "jpeg"
        if d[:4] == b"RIFF" and d[8:12] == b"WEBP":
            return "webp"
        if d[:2] == b"sB" or d[:4] == b"\x13\xab\xa1\x34":
            return "basis"
        if d[:12] == b"\xabKTX 20\xbb\r\n\x1a\n":
            return "ktx2"
        return "unknown"

    # TextureUtils equivalents (reference core/texture.rs TextureUtils:
    # target format / mime type / file stem helpers)
    def target_format(self) -> str:
        """Format the image should be written as: the actual byte format
        (we never transcode pixels, so sniffing is authoritative)."""
        fmt = self.sniff_format()
        if fmt == "unknown" and self.mime_type.startswith("image/"):
            return self.mime_type.split("/", 1)[1]
        return fmt

    def target_mime(self) -> str:
        return (self.mime_type
                or _MIME_BY_FORMAT.get(self.target_format(),
                                       "application/octet-stream"))

    def stem(self) -> str:
        """File stem for extraction (name, else uri basename, sans ext)."""
        import os
        base = self.name or (os.path.basename(self.uri) if self.uri else "")
        return os.path.splitext(base)[0]

    def suggested_filename(self, fallback_stem: str = "image") -> str:
        return ((self.stem() or fallback_stem)
                + _EXT_BY_FORMAT.get(self.target_format(), ".bin"))


@dataclass
class Texture:
    image_index: int
    sampler: dict | None = None
    name: str = ""
    # EXT_texture_webp: index of the WebP image; image_index then holds the
    # (optional) fallback source (reference tracks webp for restoration,
    # decode.rs:211 / encode.rs:2144-2350 — we carry bytes through natively)
    webp_image_index: int | None = None


@dataclass
class TextureLibrary:
    images: list[Image] = field(default_factory=list)
    textures: list[Texture] = field(default_factory=list)


@dataclass
class Material:
    """PBR metallic-roughness material with the KHR material extensions
    modeled as typed fields (reference core/material.rs:97-220: sheen,
    transmission, clearcoat, volume, ior, specular + unlit); extensions
    beyond those are carried through as raw JSON."""
    name: str = ""
    base_color_factor: tuple = (1.0, 1.0, 1.0, 1.0)
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    emissive_factor: tuple = (0.0, 0.0, 0.0)
    base_color_texture: TextureMap | None = None
    metallic_roughness_texture: TextureMap | None = None
    normal_texture: TextureMap | None = None
    normal_texture_scale: float = 1.0
    occlusion_texture: TextureMap | None = None
    emissive_texture: TextureMap | None = None
    alpha_mode: str = "OPAQUE"
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    unlit: bool = False
    # KHR_materials_sheen
    has_sheen: bool = False
    sheen_color_factor: tuple = (0.0, 0.0, 0.0)
    sheen_roughness_factor: float = 0.0
    sheen_color_texture: TextureMap | None = None
    sheen_roughness_texture: TextureMap | None = None
    # KHR_materials_transmission
    has_transmission: bool = False
    transmission_factor: float = 0.0
    transmission_texture: TextureMap | None = None
    # KHR_materials_clearcoat
    has_clearcoat: bool = False
    clearcoat_factor: float = 0.0
    clearcoat_roughness_factor: float = 0.0
    clearcoat_texture: TextureMap | None = None
    clearcoat_roughness_texture: TextureMap | None = None
    clearcoat_normal_texture: TextureMap | None = None
    # KHR_materials_volume
    has_volume: bool = False
    thickness_factor: float = 0.0
    thickness_texture: TextureMap | None = None
    attenuation_distance: float = float("inf")
    attenuation_color: tuple = (1.0, 1.0, 1.0)
    # KHR_materials_ior
    has_ior: bool = False
    ior: float = 1.5
    # KHR_materials_specular
    has_specular: bool = False
    specular_factor: float = 1.0
    specular_texture: TextureMap | None = None
    specular_color_factor: tuple = (1.0, 1.0, 1.0)
    specular_color_texture: TextureMap | None = None
    # unparsed extension passthrough
    extensions: dict = field(default_factory=dict)

    def check_any_pbr_extensions(self) -> bool:
        """material.rs check_any_pbr_extensions."""
        return (self.has_sheen or self.has_transmission
                or self.has_clearcoat or self.has_volume or self.has_ior
                or self.has_specular or self.unlit)


@dataclass
class Light:
    """KHR_lights_punctual light (reference core/scene/mod.rs:402-500)."""
    name: str = ""
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    light_type: str = "directional"  # directional | point | spot
    range: float | None = None       # point/spot only
    inner_cone_angle: float = 0.0    # spot only
    outer_cone_angle: float = 0.7853981633974483  # pi/4, spot only


@dataclass
class MaterialLibrary:
    materials: list[Material] = field(default_factory=list)
    texture_library: TextureLibrary = field(default_factory=TextureLibrary)


@dataclass
class PropertyTable:
    """EXT_structural_metadata property table
    (structural_metadata.rs:44-199) — carried as raw JSON + buffers."""
    name: str = ""
    count: int = 0
    json: dict = field(default_factory=dict)
    buffers: list[bytes] = field(default_factory=list)


@dataclass
class PropertyAttribute:
    """EXT_structural_metadata property attribute
    (structural_metadata.rs:44-199): maps class properties to vertex
    attribute semantics (e.g. "_INTENSITY"); the referenced semantics are
    real draco attributes in this framework (CUSTOM, name preserved)."""
    name: str = ""
    class_name: str = ""
    # property name -> {"attribute": semantic, optional min/max/offset/scale}
    properties: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, j: dict) -> "PropertyAttribute":
        return cls(name=j.get("name", ""), class_name=j.get("class", ""),
                   properties=dict(j.get("properties", {})))

    def to_json(self) -> dict:
        out: dict = {}
        if self.name:
            out["name"] = self.name
        if self.class_name:
            out["class"] = self.class_name
        if self.properties:
            out["properties"] = self.properties
        return out

    def attribute_semantics(self) -> list[str]:
        return [p["attribute"] for p in self.properties.values()
                if isinstance(p, dict) and "attribute" in p]


@dataclass
class StructuralMetadata:
    schema: dict = field(default_factory=dict)
    property_tables: list[PropertyTable] = field(default_factory=list)
    property_attributes: list[PropertyAttribute] = field(default_factory=list)


@dataclass
class MeshFeatures:
    """EXT_mesh_features record (core/mesh/meh_features.rs:4-12)."""
    feature_count: int = 0
    attribute_index: int | None = None
    texture_map: TextureMap | None = None
    property_table_index: int | None = None
    label: str = ""


class Scene:
    """Mesh library + groups/instances + node tree (scene/mod.rs)."""

    def __init__(self) -> None:
        self.meshes: list = []           # Mesh objects
        self.mesh_groups: list[MeshGroup] = []
        self.nodes: list[SceneNode] = []
        self.root_nodes: list[int] = []
        self.material_library = MaterialLibrary()
        self.structural_metadata = StructuralMetadata()
        self.lights: list[Light] = []    # KHR_lights_punctual
        # KHR_materials_variants document-level variant names
        # (reference add_materials_variants_names, encode.rs:1961)
        self.materials_variants_names: list[str] = []
        self.metadata: dict[str, str] = {}
        # animations/skins carry-through: the reference DROPS both
        # (decode.rs:1665-1672, add_animations_to_scene commented out); we
        # instead keep the JSON with accessor references rewritten to local
        # ids into carried_accessors, which the writer re-emits with
        # remapped indices (io/gltf.py _carry_animation_accessors)
        self.animations_json: list = []
        self.skins_json: list = []
        # [{"json": accessor-json (bufferView/byteOffset stripped),
        #   "data": tightly packed bytes, "sparse_data": {...}}]
        self.carried_accessors: list[dict] = []

    def num_meshes(self) -> int:
        return len(self.meshes)

    def add_mesh(self, mesh, material_index: int | None = None,
                 name: str = "") -> int:
        """Append a mesh wrapped in its own group + root node; returns the
        mesh index (convenience mirroring Scene::add_mesh usage in the
        reference scene model, scene/mod.rs:323-395)."""
        mesh_idx = len(self.meshes)
        self.meshes.append(mesh)
        group = MeshGroup(name=name or getattr(mesh, "name", ""),
                          instances=[MeshInstance(mesh_idx, material_index)])
        group_idx = len(self.mesh_groups)
        self.mesh_groups.append(group)
        node = SceneNode(name=name, mesh_group_index=group_idx)
        node_idx = len(self.nodes)
        self.nodes.append(node)
        self.root_nodes.append(node_idx)
        return mesh_idx

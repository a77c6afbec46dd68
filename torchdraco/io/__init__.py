from .gltf import (
    DracoTranscoder,
    GltfError,
    load_gltf,
    load_gltf_to_scene,
    save_scene_glb,
)
from .obj import load_obj, save_obj
from .ply import PlyError, load_ply, save_ply


def load_mesh(path: str):
    """Extension-dispatched mesh loader (.obj / .ply / .gltf / .glb) —
    the scene_io-style front door (reference io/gltf/scene_io.rs:33-133,
    which only implements glTF)."""
    import os
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    if ext in (".gltf", ".glb"):
        return load_gltf(path)
    raise ValueError(f"unsupported mesh format {ext!r}")


__all__ = [
    "DracoTranscoder", "GltfError", "load_gltf", "load_gltf_to_scene",
    "save_scene_glb", "load_obj", "save_obj",
    "PlyError", "load_ply", "save_ply", "load_mesh",
]

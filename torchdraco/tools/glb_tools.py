"""GLB inspection helpers: dump the JSON chunk, extract embedded Draco blobs.

Host-side equivalents of the reference's Python utilities
(util/extract_glb_json.py and util/extract_draco_binary.py): pull the
KHR_draco_mesh_compression bufferView payloads out of a GLB/glTF container
for external decoding or byte-diffing, and pretty-print the scene JSON.

Usage:
  python -m torchdraco.tools.glb_tools json   scene.glb [-o scene.json]
  python -m torchdraco.tools.glb_tools draco  scene.glb [-o outdir]
  python -m torchdraco.tools.glb_tools images scene.glb [-o outdir]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..io.gltf import _bufferview_bytes, _load_container


def extract_glb_json(path: str) -> dict:
    """Parsed JSON chunk of a .glb (or the whole .gltf)."""
    gltf, _ = _load_container(path)
    return gltf


def extract_draco_blobs(path: str) -> list[tuple[str, bytes]]:
    """All KHR_draco_mesh_compression payloads as (name, drc bytes)."""
    gltf, buffers = _load_container(path)
    out = []
    for mi, mesh in enumerate(gltf.get("meshes", [])):
        for pi, prim in enumerate(mesh.get("primitives", [])):
            ext = prim.get("extensions", {}).get("KHR_draco_mesh_compression")
            if not ext:
                continue
            blob = _bufferview_bytes(gltf, buffers, ext["bufferView"])
            out.append((f"mesh{mi}_prim{pi}.drc", bytes(blob)))
    return out


def extract_images(path: str) -> list[tuple[str, bytes]]:
    """All embedded images as (suggested filename, bytes) — format/mime
    resolved via the Image TextureUtils helpers (reference
    io/gltf/encode.rs image processing + texture_io sniffing)."""
    from ..io.gltf import load_gltf_to_scene

    scene = load_gltf_to_scene(path)
    out = []
    for i, img in enumerate(scene.material_library.texture_library.images):
        if not img.data:
            continue
        out.append((img.suggested_filename(fallback_stem=f"image{i}"),
                    img.data))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torchdraco-glb")
    sub = p.add_subparsers(dest="cmd", required=True)
    pj = sub.add_parser("json", help="dump the glTF JSON chunk")
    pj.add_argument("input")
    pj.add_argument("-o", "--output", default=None)
    pd = sub.add_parser("draco", help="extract embedded Draco blobs")
    pd.add_argument("input")
    pd.add_argument("-o", "--output", default=".",
                    help="directory for the .drc files")
    pi = sub.add_parser("images", help="extract embedded images")
    pi.add_argument("input")
    pi.add_argument("-o", "--output", default=".",
                    help="directory for the image files")
    args = p.parse_args(argv)

    if args.cmd == "images":
        images = extract_images(args.input)
        if not images:
            print("no embedded images found")
            return 1
        os.makedirs(args.output, exist_ok=True)
        for name, data in images:
            out_path = os.path.join(args.output, name)
            with open(out_path, "wb") as f:
                f.write(data)
            print(f"{out_path}: {len(data)} bytes")
        return 0

    if args.cmd == "json":
        doc = json.dumps(extract_glb_json(args.input), indent=2)
        if args.output:
            with open(args.output, "w") as f:
                f.write(doc)
        else:
            sys.stdout.write(doc + "\n")
        return 0

    blobs = extract_draco_blobs(args.input)
    if not blobs:
        print("no KHR_draco_mesh_compression primitives found")
        return 1
    os.makedirs(args.output, exist_ok=True)
    for name, blob in blobs:
        out_path = os.path.join(args.output, name)
        with open(out_path, "wb") as f:
            f.write(blob)
        print(f"{out_path}: {len(blob)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

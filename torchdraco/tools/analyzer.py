"""Analyzer: per-mesh compression report with stage metrics, round-trip
quality, and an HTML summary.

Mirrors the reference analyzer (analyzer/src/main.rs): encode with eval
recording, dump eval.json, write compressed.drc, decode (with our own
decoder instead of the external C++ draco_decoder the reference shells out
to), write output.obj, and render an HTML report.

Usage:
  python -m torchdraco.tools.analyzer -i mesh.obj -o report_dir
  python -m torchdraco.tools.analyzer -i scene.glb -o report_dir
"""

from __future__ import annotations

import argparse
import html
import json
import os
import time


def analyze_mesh(mesh, out_dir: str, name: str) -> dict:
    from ..decode import decode
    from ..encode import encode
    from ..eval import EvalRecorder

    os.makedirs(out_dir, exist_ok=True)
    rec = EvalRecorder()
    t0 = time.perf_counter()
    blob = encode(mesh, recorder=rec)
    encode_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "compressed.drc"), "wb") as f:
        f.write(blob)
    rec.dump(os.path.join(out_dir, "eval.json"))

    t0 = time.perf_counter()
    decoded = decode(blob)
    decode_s = time.perf_counter() - t0
    from ..io import save_obj
    save_obj(decoded, os.path.join(out_dir, "output.obj"))

    raw_size = sum(a.values_per_point().nbytes for a in mesh.attributes) \
        + mesh.faces.size * 4
    quality = mesh.diff_l2_norm(decoded)
    stats = {
        "name": name,
        "num_faces": int(mesh.num_faces),
        "num_points": int(mesh.attributes[0].num_points) if mesh.attributes else 0,
        "raw_size_bytes": int(raw_size),
        "compressed_size_bytes": len(blob),
        "compression_ratio": round(raw_size / len(blob), 3),
        "encode_seconds": round(encode_s, 4),
        "decode_seconds": round(decode_s, 4),
        "diff_l2_norm": quality,
        "eval": rec.to_json(),
    }
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    _write_html(stats, os.path.join(out_dir, "report.html"),
                viewer=_viewer_payload(decoded))
    return stats


def _viewer_payload(mesh, max_faces: int = 20000):
    """Decoded mesh as JSON-able arrays for the embedded viewer (positions
    normalized into [-1,1]^3; faces decimated beyond max_faces)."""
    import numpy as np
    pos_atts = [a for a in mesh.attributes if a.att_type == 0]
    if not pos_atts or mesh.num_faces == 0:
        return None
    pos = np.asarray(pos_atts[0].values_per_point(), dtype=np.float64)
    faces = np.asarray(mesh.faces)
    if len(faces) > max_faces:
        faces = faces[:: len(faces) // max_faces + 1]
    center = (pos.max(axis=0) + pos.min(axis=0)) / 2
    scale = max(float((pos.max(axis=0) - pos.min(axis=0)).max()) / 2, 1e-9)
    pos = (pos - center) / scale
    return {"v": np.round(pos, 4).tolist(), "f": faces.tolist()}


def _stage_rows(node, depth=0, rows=None):
    if rows is None:
        rows = []
    label = ("&nbsp;" * 4 * depth) + html.escape(node["name"])
    data = ", ".join(f"{k}={v}" for k, v in node["data"].items())
    rows.append(f"<tr><td>{label}</td><td>{html.escape(data)}</td></tr>")
    for c in node["children"]:
        _stage_rows(c, depth + 1, rows)
    return rows


_VIEWER_JS = """
const D = MESH_DATA; const cv = document.getElementById('vw');
const ctx = cv.getContext('2d'); let rx = -0.6, ry = 0.7, drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (!drag) return;
  ry += (e.clientX - drag[0]) * 0.01; rx += (e.clientY - drag[1]) * 0.01;
  drag = [e.clientX, e.clientY]; draw(); };
function draw() {
  const w = cv.width, h = cv.height, s = Math.min(w, h) * 0.38;
  ctx.clearRect(0, 0, w, h); ctx.strokeStyle = '#36c'; ctx.lineWidth = 0.5;
  const cx = Math.cos(rx), sx = Math.sin(rx),
        cy = Math.cos(ry), sy = Math.sin(ry);
  const P = D.v.map(p => {
    const x = p[0] * cy + p[2] * sy, z = -p[0] * sy + p[2] * cy;
    const y = p[1] * cx - z * sx, z2 = p[1] * sx + z * cx;
    const d = 3 / (3 + z2);
    return [w / 2 + x * s * d, h / 2 - y * s * d]; });
  ctx.beginPath();
  for (const f of D.f) for (let i = 0; i < 3; i++) {
    const a = P[f[i]], b = P[f[(i + 1) % 3]];
    ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); }
  ctx.stroke(); }
draw();
"""


def _write_html(stats: dict, path: str, viewer=None) -> None:
    rows = "\n".join(_stage_rows(stats["eval"]))
    viewer_html = ""
    if viewer is not None:
        payload = json.dumps(viewer, separators=(",", ":"))
        viewer_html = (
            "<h2>Decoded mesh (drag to rotate)</h2>"
            '<canvas id="vw" width="640" height="480" '
            'style="border:1px solid #999"></canvas>'
            f"<script>const MESH_DATA={payload};{_VIEWER_JS}</script>")
    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>torchdraco report: {html.escape(stats['name'])}</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 10px;text-align:left}}</style></head>
<body><h1>{html.escape(stats['name'])}</h1>
<table>
<tr><th>faces</th><td>{stats['num_faces']}</td></tr>
<tr><th>points</th><td>{stats['num_points']}</td></tr>
<tr><th>raw size</th><td>{stats['raw_size_bytes']} B</td></tr>
<tr><th>compressed</th><td>{stats['compressed_size_bytes']} B</td></tr>
<tr><th>ratio</th><td>{stats['compression_ratio']}x</td></tr>
<tr><th>encode</th><td>{stats['encode_seconds']} s</td></tr>
<tr><th>decode</th><td>{stats['decode_seconds']} s</td></tr>
<tr><th>diff_l2_norm</th><td>{stats['diff_l2_norm']:.3e}</td></tr>
</table>
{viewer_html}
<h2>Stages</h2><table><tr><th>stage</th><th>data</th></tr>{rows}</table>
</body></html>"""
    with open(path, "w", encoding="utf-8") as f:
        f.write(doc)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torchdraco-analyzer")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True, help="report directory")
    args = p.parse_args(argv)

    ext = os.path.splitext(args.input)[1].lower()
    name = os.path.basename(args.input)
    if ext in (".obj", ".ply"):
        from ..io import load_mesh
        meshes = [(name, load_mesh(args.input))]
    elif ext in (".gltf", ".glb"):
        from ..io import load_gltf_to_scene
        scene = load_gltf_to_scene(args.input)
        meshes = [(f"{name}#{i}", m) for i, m in enumerate(scene.meshes)]
    else:
        print(f"unsupported input {ext}")
        return 2
    for mesh_name, mesh in meshes:
        sub = os.path.join(args.output, mesh_name.replace("/", "_"))
        stats = analyze_mesh(mesh, sub, mesh_name)
        print(f"{mesh_name}: {stats['compressed_size_bytes']}B "
              f"({stats['compression_ratio']}x), "
              f"quality {stats['diff_l2_norm']:.2e} -> {sub}/report.html")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Batch analysis: run the analyzer over every mesh file in a directory.

Equivalent of the reference's util/analyze_gltf_files.py (batch-run the
analyzer binary over a directory), with a corpus summary table written as
JSON for cross-run comparison.

Usage:
  python -m torchdraco.tools.batch_analyze -i corpus_dir -o report_dir
"""

from __future__ import annotations

import argparse
import json
import os

from .analyzer import analyze_mesh

MESH_EXTS = (".obj", ".gltf", ".glb")


def analyze_dir(in_dir: str, out_dir: str) -> list[dict]:
    results = []
    for root, _, files in os.walk(in_dir):
        for fname in sorted(files):
            ext = os.path.splitext(fname)[1].lower()
            if ext not in MESH_EXTS:
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, in_dir)
            try:
                if ext == ".obj":
                    from ..io import load_obj
                    meshes = [(rel, load_obj(path))]
                else:
                    from ..io import load_gltf_to_scene
                    scene = load_gltf_to_scene(path)
                    meshes = [(f"{rel}#{i}", m)
                              for i, m in enumerate(scene.meshes)]
                for name, mesh in meshes:
                    sub = os.path.join(out_dir, name.replace(os.sep, "_")
                                       .replace("/", "_"))
                    stats = analyze_mesh(mesh, sub, name)
                    stats["file"] = rel
                    results.append(stats)
            except Exception as exc:  # per-file isolation: keep the batch alive
                results.append({"file": rel, "error": str(exc)})
    return results


# --- size/quality baseline ----------------------------------------------
# The reference publishes no size or quality numbers at all (SURVEY §6);
# this table is the citable baseline: .drc bytes + compression ratio +
# diff_l2_norm per fixture across the codec's config surface. The fixtures
# are the reference's test data, found under the directory that
# TORCHDRACO_REF_DATA names (none: the table is empty).

REF_DATA = os.environ.get("TORCHDRACO_REF_DATA", "")

SIZE_FIXTURES = ["tetrahedron.obj", "sphere.obj", "torus.obj",
                 "cube_quads.obj", "punctured_sphere.obj",
                 "Duck/Duck.glb"]


def _size_table_configs():
    """(label, Config) columns — the -cl presets plus every opt-in
    dialect surface (single-connectivity, derivative-uv, the D4
    orthogonal transform, prediction-degree traversal)."""
    from ..encode import Config
    from ..models.attribute import AttributeType
    from ..shared.prediction import PRED_DERIVATIVE

    return [
        ("cl0-seq", Config.from_level(0)),
        ("cl3-std", Config.from_level(3)),
        ("cl7-auto", Config.from_level(7)),
        ("cl9-valence", Config.from_level(9)),
        ("cl10-max", Config.from_level(10)),
        ("single-conn", Config(use_single_connectivity=True)),
        ("deriv-uv", Config(prediction={
            AttributeType.TEX_COORD: PRED_DERIVATIVE})),
        ("orthogonal", Config(transform={AttributeType.NORMAL: 4})),
        ("pred-degree", Config(attribute_traversal="prediction-degree")),
        ("predictive-eb", Config(traversal=1)),
    ]


def _load_size_fixtures(data_dir: str = REF_DATA):
    out = []
    if not data_dir:
        return out
    for name in SIZE_FIXTURES:
        path = os.path.join(data_dir, name)
        if not os.path.isfile(path):
            continue
        if name.endswith(".obj"):
            from ..io import load_obj
            out.append((name, load_obj(path)))
        else:
            from ..io import load_gltf_to_scene
            for i, m in enumerate(load_gltf_to_scene(path).meshes):
                out.append((f"{name}#{i}", m))
    return out


def size_quality_table(data_dir: str = REF_DATA,
                       with_quality: bool = True) -> list[dict]:
    """One row per (fixture, config): bytes, ratio vs raw attribute+index
    size, and (optionally) the symmetric point-to-surface diff_l2_norm of
    the decoded mesh (analyzer's quality metric, core/mesh/mod.rs:78-108).
    Configs that cannot apply to a fixture record the error string."""
    from ..decode import decode
    from ..encode import encode

    rows = []
    for name, mesh in _load_size_fixtures(data_dir):
        raw = sum(a.values_per_point().nbytes for a in mesh.attributes) \
            + mesh.faces.size * 4
        for label, cfg in _size_table_configs():
            row = {"fixture": name, "config": label, "raw_bytes": int(raw)}
            try:
                blob = encode(mesh, cfg=cfg)
                row["bytes"] = len(blob)
                row["ratio"] = round(raw / len(blob), 2)
                if with_quality:
                    row["diff_l2_norm"] = float(
                        f"{mesh.diff_l2_norm(decode(blob)):.3e}")
            except Exception as exc:
                row["error"] = f"{type(exc).__name__}: {exc}"[:120]
            rows.append(row)
    return rows


def render_size_table_markdown(rows: list[dict]) -> str:
    configs = []
    fixtures = []
    for r in rows:
        if r["config"] not in configs:
            configs.append(r["config"])
        if r["fixture"] not in fixtures:
            fixtures.append(r["fixture"])
    by = {(r["fixture"], r["config"]): r for r in rows}
    lines = ["| fixture | " + " | ".join(configs) + " |",
             "|---" * (len(configs) + 1) + "|"]
    for f in fixtures:
        cells = []
        for c in configs:
            r = by.get((f, c), {})
            if "bytes" in r:
                q = r.get("diff_l2_norm")
                qs = f" q={q:.1e}" if q is not None else ""
                cells.append(f"{r['bytes']}B {r['ratio']}x{qs}")
            else:
                cells.append("—")
        lines.append(f"| {f} | " + " | ".join(cells) + " |")
    totals = []
    for c in configs:
        t = sum(by[(f, c)].get("bytes", 0) for f in fixtures
                if (f, c) in by)
        totals.append(str(t))
    lines.append("| **total bytes** | " + " | ".join(totals) + " |")
    return "\n".join(lines)


SIZE_TABLE_BEGIN = "<!-- SIZE_TABLE_BEGIN (generated by "\
    "tools/batch_analyze.py --size-table) -->"
SIZE_TABLE_END = "<!-- SIZE_TABLE_END -->"


def update_baseline_md(path: str, rows: list[dict]) -> None:
    md = render_size_table_markdown(rows)
    block = f"{SIZE_TABLE_BEGIN}\n{md}\n{SIZE_TABLE_END}"
    with open(path) as f:
        text = f.read()
    if SIZE_TABLE_BEGIN in text and SIZE_TABLE_END in text:
        head = text[:text.index(SIZE_TABLE_BEGIN)]
        tail = text[text.index(SIZE_TABLE_END) + len(SIZE_TABLE_END):]
        text = head + block + tail
    elif SIZE_TABLE_BEGIN in text:
        # mangled block (END marker hand-deleted): replace from BEGIN to
        # the end of the file rather than dying mid-update
        text = text[:text.index(SIZE_TABLE_BEGIN)] + block + "\n"
    else:
        text = text.rstrip() + "\n\n## Size/quality baseline " \
            "(per-fixture, generated)\n\nBytes, compression ratio vs raw " \
            "attributes+indices, and q = decoded diff_l2_norm. The " \
            "reference publishes no numbers (SURVEY §6); totals pinned " \
            "by tests/test_size_baseline.py.\n\n" + block + "\n"
    with open(path, "w") as f:
        f.write(text)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torchdraco-batch-analyze")
    p.add_argument("-i", "--input", help="corpus directory")
    p.add_argument("-o", "--output", help="report directory")
    p.add_argument("--size-table", action="store_true",
                   help="emit the per-fixture size/quality baseline table "
                        "(markdown to stdout; with --update-baseline also "
                        "rewrites the generated block in BASELINE.md and "
                        "tests/size_baseline.json)")
    p.add_argument("--update-baseline", metavar="REPO_ROOT", default=None,
                   help="repo root whose BASELINE.md / tests get updated")
    args = p.parse_args(argv)

    if args.size_table:
        rows = size_quality_table()
        print(render_size_table_markdown(rows))
        if args.update_baseline:
            update_baseline_md(
                os.path.join(args.update_baseline, "BASELINE.md"), rows)
            pin = {f"{r['fixture']}:{r['config']}": r["bytes"]
                   for r in rows if "bytes" in r}
            pin_path = os.path.join(args.update_baseline, "tests",
                                    "size_baseline.json")
            with open(pin_path, "w") as f:
                json.dump(pin, f, indent=1, sort_keys=True)
            print(f"updated BASELINE.md + {pin_path}")
        return 0

    if not args.input or not args.output:
        p.error("-i/-o are required unless --size-table is given")

    results = analyze_dir(args.input, args.output)
    os.makedirs(args.output, exist_ok=True)
    summary_path = os.path.join(args.output, "summary.json")
    with open(summary_path, "w") as f:
        json.dump(results, f, indent=2)

    ok = [r for r in results if "error" not in r]
    bad = [r for r in results if "error" in r]
    for r in ok:
        print(f"{r['name']}: {r['compressed_size_bytes']}B "
              f"({r['compression_ratio']}x)")
    for r in bad:
        print(f"{r['file']}: ERROR {r['error']}")
    print(f"{len(ok)} analyzed, {len(bad)} failed -> {summary_path}")
    return 0 if not bad else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""A later cell, configuration and per-layer metric come as new files and
new entries in BENCHMARK.json only: no file the benchmark has is edited."""

import hashlib
import json

from conftest import run_cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "drcbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_config_and_metric_are_new_files(tiny_root, capsys):
    before = _digests(tiny_root)
    d = tiny_root / "drcbench"
    cfg = json.loads((d / "configs/dfaust-pnt.json").read_text())
    cfg.update(name="capture-q14", lattice=[9, 10],
               quantization={"position": 14, "normal": 10, "tex_coord": 12})
    (d / "configs/capture-q14.json").write_text(json.dumps(cfg))
    (d / "workloads/group5-encode.json").write_text(json.dumps(
        {"entry": "encode_group", "loop": "closed", "clients": 1,
         "frames_per_request": 5, "distinct_requests": 2,
         "warm_requests": 1}))
    (d / "metrics/enc.requests.py").write_text(
        '"""Requests in the window."""\n\n\ndef value(run):\n'
        '    return float(len(run.requests))\n')
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "capture-q14", "source": "a test",
                            "file": "drcbench/configs/capture-q14.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "q14.encode", "config": "capture-q14",
                              "traffic": "group5-encode", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "dfaust.encode" in m.get("workloads", ()):
            m["workloads"].append("q14.encode")
    spec["per_layer"].append({"name": "enc.requests", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "parallel.batch",
                              "moves": "encode_mb_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    res = run_cell(tiny_root, "q14.encode", capsys, trace=1)
    assert res["correct"] is True
    assert res["metrics"]["enc.requests"]["value"] == res["attempted"]
    # a metric without a workloads key goes to every cell that reports
    # the end-to-end metric it moves, the older cells too
    for cell in ("dfaust.encode", "sim1m.encode"):
        old = run_cell(tiny_root, cell, capsys, trace=1)
        assert old["metrics"]["enc.requests"]["value"] == old["attempted"]
    after = _digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())

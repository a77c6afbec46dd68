"""A later cell, configuration and per-layer metric come as new files and
new entries in BENCHMARK.json only: no file the benchmark has is edited."""

import hashlib
import json

from conftest import add_takes_cell, run_cell
from drcbench.core import harness


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


def test_a_cell_of_takes_of_two_sizes_is_new_files(tiny_root, capsys,
                                                     monkeypatch):
    """Requests of three takes of two frames, the takes of two lattice
    sizes and each of its own topology, through an entry over the router:
    correct, and ``encode_mb_s`` counts each frame at its own take's
    size."""
    before = _digests(tiny_root)
    add_takes_cell(tiny_root)
    runs, entries = [], []

    class Kept(harness.Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)

    def keep(entry):
        entries.append(entry)
        return entry

    res = run_cell(tiny_root, "takes.encode", capsys, entry_wrapper=keep)
    assert res["correct"] is True and res["failed"] == 0
    assert res["compared"]["blobs_wrong"]["value"] == 0
    (run,), (entry,) = runs, entries
    # each take its own topology: the warm request's three and the two
    # distinct requests' six, no two alike
    sigs = {tuple(s) for s in entry.signatures}
    assert len(sigs) == 3
    flat = [s for t in sigs for s in t]
    assert len(set(flat)) == len(flat) == 9
    assert [len(r["frames"]) for r in run.requests] == [6] * len(
        run.requests)
    sizes = {0: 7 * 9, 1: 10 * 8}
    want = sum(sizes[t % 2] * 32 for r in run.requests
               for t, _ in r["frames"])
    assert res["metrics"]["encode_mb_s"]["value"] == want / run.window_s / 1e6
    assert {t % 2 for r in run.requests for t, _ in r["frames"]} == {0, 1}
    after = _digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())

"""Each metric reader gives its number on a small recorded trace of a
window (``fixtures/window_trace.json``: two encode requests, with their
kernels, and a request of another entry) and the stage times of its
requests."""

import json

import pytest

from conftest import ROOT, add_takes_cell
from drcbench.core import roofline, trace
from drcbench.core.harness import Cell, Run

EVENTS = [e for e in json.loads(
    (ROOT / "drcbench/tests/fixtures/window_trace.json").read_text())
    ["traceEvents"] if e.get("ph") == "X"]
STREAM = {"symbols": 196_608, "table_entries": 4096,
          "payload_bytes": 150_000}


def _run(cell: str = "dfaust.encode", root=ROOT) -> Run:
    run = Run(Cell(root, cell), seed=1, seconds=2.0)
    spans = [s for s in trace.spans(EVENTS) if s[2].endswith("encode_group")]
    run.device_events = [e for e in trace.device_events(EVENTS)
                         if spans[0][0] <= e["ts"] <= spans[-1][1]]
    run.spans = spans
    run.setup_s, run.window_s = 17.5, 2.0
    per = int(run.traffic["frames_per_request"])
    t = {"chains_s": 0.6, "assembly_s": 0.2, "position_s": 0.1,
         "build_s": 0.3}
    run.requests = [{"index": i, "distinct": i % 2,
                     "frames": [(0, f) for f in range(i * per,
                                                      (i + 1) * per)],
                     "start": float(i), "end": i + 1.0, "timings": t}
                    for i in range(len(spans))]
    run.streams = [[[STREAM, STREAM, STREAM] for _ in range(per)]
                   for _ in range(2)]
    return run


def test_spans_and_device_events_of_the_fixture():
    assert [s[2] for s in trace.spans(EVENTS)] == [
        "request 0 encode_group", "request 1 encode_group",
        "request 0 decode_group"]
    assert len(trace.device_events(EVENTS)) == 16


@pytest.mark.parametrize("cell", ["dfaust.encode", "sim1m.encode"])
def test_end_to_end_readers(cell):
    run = _run(cell)
    c = run.cell
    assert c.readers["setup_s"].value(run) == 17.5
    per = run.traffic["frames_per_request"]
    want = 2 * per * run.frame_bytes / 2.0 / 1e6
    assert c.readers["encode_mb_s"].value(run) == pytest.approx(want)
    assert run.frame_bytes == run.vertices * 32


def test_stage_readers():
    run = _run()
    r = run.cell.readers
    assert r["enc.chains_ms"].value(run) == pytest.approx(600.0)
    assert r["enc.assembly_ms"].value(run) == pytest.approx(200.0)
    assert r["enc.position_ms"].value(run) == pytest.approx(100.0)
    assert r["enc.build_ms"].value(run) == pytest.approx(300.0)
    for q in run.requests:
        q["timings"] = {k: v for k, v in q["timings"].items()
                        if k != "build_s"}
    assert r["enc.build_ms"].value(run) is None


def test_idle_readers():
    run = _run()
    busy = 2 * (2000 + 40 + 20 + 600 + 250 + 180 + 1000)
    assert run.cell.readers["idle.encode"].value(run) == pytest.approx(
        100 * (1 - busy / 2_000_000))
    run.spans = []
    assert run.cell.readers["idle.encode"].value(run) is None


def test_roofline_readers():
    run = _run()
    per = run.traffic["frames_per_request"]
    least, by = roofline.bound(*roofline.rans_lanes_work([STREAM] * 2 * per))
    assert by == "bytes"
    assert run.cell.readers["k3_roofline"].value(run) == pytest.approx(
        100 * least / 1200e-6)
    least, _ = roofline.bound(*[2 * x for x in roofline.normal_encode_work(
        per, run.vertices, run.faces)])
    assert run.cell.readers["c1_roofline"].value(run) == pytest.approx(
        100 * least / 500e-6)


@pytest.mark.parametrize("cell,sizes,want", [
    ("dfaust.encode", (26457600, 220480, 6890, 13440),
     {"encode_mb_s": 13.2288, "c1_roofline": 1.686691343283582,
      "k3_roofline": 2.8442268656716423}),
    ("sim1m.encode", (67108864, 33554432, 1048576, 2093058),
     {"encode_mb_s": 33.554432, "c1_roofline": 13.128727880597015})])
def test_one_take_readings_are_the_ones_of_one_take_a_run(cell, sizes,
                                                          want):
    """The fixture's run reads, float for float, what the harness of one
    take a run read from it."""
    run = _run(cell)
    assert (run.completed_bytes(), run.frame_bytes, run.vertices,
            run.faces) == sizes
    assert {k: run.cell.readers[k].value(run) for k in want} == want


def test_readers_of_two_takes_sum_each_takes_own_work(tiny_root):
    """Two requests of three takes of two frames, the takes of two lattice
    sizes: the bytes and C1's work are each take's own, summed."""
    add_takes_cell(tiny_root, takes=((7, 9), (10, 8)))
    run = _run("takes.encode", tiny_root)
    run.requests = [dict(q, frames=[(t, f) for t in range(3 * i, 3 * i + 3)
                                    for f in range(2)])
                    for i, q in enumerate(run.requests)]
    sizes = [(63, 2 * 6 * 8), (80, 2 * 9 * 7)]  # (vertices, faces) a take
    assert [run.takes[t].vertices for t in range(4)] == [63, 80, 63, 80]
    assert len(run.requests) == 2  # takes 0, 1, 2, then 3, 4, 5
    assert run.completed_bytes() == 2 * 32 * 3 * (63 + 80)
    nbytes = ops = 0.0
    for t in (0, 1, 0, 1, 0, 1):
        b, o = roofline.normal_encode_work(2, *sizes[t])
        nbytes += b
        ops += o
    least, _ = roofline.bound(nbytes, ops)
    assert run.cell.readers["c1_roofline"].value(run) == pytest.approx(
        100 * least / 500e-6, rel=1e-12)
    assert run.cell.readers["encode_mb_s"].value(run) == pytest.approx(
        run.completed_bytes() / 2.0 / 1e6, rel=1e-12)


def test_readers_without_a_trace_or_kernel_give_nothing():
    run = _run()
    run.device_events = [e for e in run.device_events
                         if "rans_words" not in e["name"]]
    assert run.cell.readers["k3_roofline"].value(run) is None
    run.device_events = None
    for name in ("k3_roofline", "c1_roofline", "idle.encode"):
        assert run.cell.readers[name].value(run) is None


def test_breakdown_lists():
    run = _run()
    ops = trace.top_operations(run.device_events)
    assert ops[0] == ["Memcpy HtoD (Pageable -> Device)", 0.004]
    gaps = trace.idle_gaps(run.device_events, run.spans)
    assert len(gaps) <= trace.TOP
    assert gaps[0][0].startswith("request ")
    assert all(g[1] > 0 for g in gaps)

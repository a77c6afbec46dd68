"""The router's cell, ``capture.encode-takes``: its entry over
``encode_meshes_auto`` runs a takes configuration of three sizes through
the harness, correct against the frozen reference, with the router's
counters and spans in its line; and the cell's three readers
(``enc.route.probe_ms``, ``enc.route.host_ms``, ``route.device_share``) on
a synthetic window, which read nothing where the program has no router
spans or counters."""

import json
from typing import NamedTuple

import pytest

from conftest import ROOT, run_cell
from drcbench.core import harness, program_spans
from drcbench.core.harness import Cell, Run

CELL = "capture.encode-takes"
ROUTE = ("enc.route.probe_ms", "enc.route.host_ms", "route.device_share")
LATTICES = ((7, 9), (10, 8), (5, 6))


def _three_sizes(root) -> None:
    """The copy's configuration at three small lattices, its traffic at
    three takes of two frames a request."""
    d = root / "drcbench"
    p = d / "configs/capture-takes-pnt.json"
    cfg = json.loads(p.read_text())
    cfg["takes"] = [{"lattice": list(t)} for t in LATTICES]
    p.write_text(json.dumps(cfg))
    p = d / "workloads/takes16-encode.json"
    traffic = json.loads(p.read_text())
    traffic.update(takes_per_request=3, frames_per_request=6,
                   distinct_requests=2)
    p.write_text(json.dumps(traffic))


@pytest.mark.parametrize("trace", [0, 1])
def test_takes_of_three_sizes_through_the_router_are_correct(
        tiny_root, capsys, monkeypatch, trace):
    """Every group of two frames probed (one mesh a plane), so that the
    window holds probes, kept decisions and both planes' meshes."""
    from torchdraco.parallel.batch import BatchEncoder

    monkeypatch.setattr(BatchEncoder, "PROBE_SKIP_S", 0.0)
    _three_sizes(tiny_root)
    runs = []

    class Kept(Run):
        def __init__(self, *args):
            super().__init__(*args)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    res = run_cell(tiny_root, CELL, capsys, trace=trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["compared"]["blobs_wrong"]["value"] == 0
    (run,) = runs
    assert {run.takes[t].lattice for r in run.requests
            for t, _ in r["frames"]} == set(LATTICES)
    for r in run.requests:
        t = r["timings"]
        assert t["groups"] == 3 and t["build_s"] > 0
        assert t["meshes_device"] + t["meshes_host"] == 6
        assert t["groups_measured"] + t["groups_cached"] == 3
    # the first pass probes every take, each later request keeps them
    assert [r["timings"]["groups_measured"] for r in run.requests[:2]] \
        == [3, 3]
    assert all(r["timings"]["groups_cached"] == 3
               for r in run.requests[2:])
    got = res["metrics"]
    if not trace:
        assert set(got) == {"encode_mb_s", "setup_s"}
        return
    for name in ROUTE + ("enc.build.values_ms", "enc.build.points_ms",
                         "enc.signatures_ms", "enc.chains_ms",
                         "enc.build_ms"):
        assert name in got, name
    assert got["enc.route.probe_ms"]["value"] > 0
    share = sum(r["timings"]["meshes_device"] for r in run.requests) / (
        6 * len(run.requests))
    assert got["route.device_share"]["value"] == pytest.approx(100 * share)


class Span(NamedTuple):  # torchdraco.trace.Span's fields
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    root: int
    attrs: dict


BASE_NS = 1_790_000_000_000_000_000  # the program's Unix ns at the trace's 0
# one request, in us from its first root's start: (name, start, end,
# parent's index in this list)
REQUEST = [("build_meshes", 0, 3000, None), ("build_meshes", 10, 1400, 0),
           ("build_meshes", 1500, 2900, 0),
           ("encode_meshes_auto", 3005, 9985, None),
           ("signatures", 3010, 3500, 3),
           ("route.group", 3600, 6000, 3),
           ("route.probe.host", 3610, 4610, 5),
           ("route.probe.device", 4700, 5900, 5),
           ("encode_meshes_device", 4710, 5890, 7),
           ("route.group", 6100, 9900, 3), ("route.host", 6200, 9800, 9)]


def _window(names=None):
    """(program spans, request spans) of three requests 10 ms apart, each
    root 5 us after its request span opens; only the spans named in
    ``names`` where given."""
    program, requests = [], []
    for r in range(3):
        t0 = 1000.0 + 10_000.0 * r
        requests.append((t0, t0 + 9995.0, f"request {r} encode_router"))
        ids = []
        for name, a, b, parent in REQUEST:
            i = len(program) + 1
            pid = ids[parent] if parent is not None else None
            root = i if pid is None else program[pid - 1].root
            start = BASE_NS + round((t0 + 5) * 1e3)
            program.append(Span(name, start + a * 1000, start + b * 1000, i,
                                pid, root, {}))
            ids.append(i)
    if names is not None:
        program = [s for s in program if s.name in names]
    return program, requests


def _run(monkeypatch, program, requests, counts=True) -> Run:
    monkeypatch.setattr(program_spans, "recorded", lambda: program)
    run = Run(Cell(ROOT, CELL), seed=1, seconds=1.0)
    run.spans = requests
    frames = harness.request_frames(run.traffic, 0)
    timings = [{"meshes_device": 120, "meshes_host": 8},
               {"meshes_device": 128, "meshes_host": 0},
               {"meshes_device": 128, "meshes_host": 0}]
    run.requests = [{"index": i, "distinct": i % 2, "frames": frames,
                     "timings": t if counts else {}}
                    for i, t in enumerate(timings)]
    return run


def test_the_route_readers_on_a_synthetic_window(monkeypatch):
    run = _run(monkeypatch, *_window())
    r = run.cell.readers
    assert set(ROUTE) <= set(r)
    # a request: probes of 1000 + 1200 us, the host plane 3600 us
    assert r["enc.route.probe_ms"].value(run) == pytest.approx(2.2)
    assert r["enc.route.host_ms"].value(run) == pytest.approx(3.6)
    assert r["route.device_share"].value(run) == pytest.approx(
        100 * 376 / 384)
    # the builds pair with the requests through their outer root
    assert r["enc.signatures_ms"].value(run) == pytest.approx(0.49)


def test_the_route_readers_read_nothing_without_the_router(monkeypatch):
    """As on a program whose router opens no spans and counts nothing:
    the other readers still read its window."""
    program, requests = _window(names={"build_meshes", "signatures",
                                       "encode_meshes_device"})
    run = _run(monkeypatch, program, requests, counts=False)
    r = run.cell.readers
    for name in ROUTE:
        assert r[name].value(run) is None, name
    assert r["enc.signatures_ms"].value(run) == pytest.approx(0.49)
    run.spans = []
    assert r["enc.route.probe_ms"].value(run) is None

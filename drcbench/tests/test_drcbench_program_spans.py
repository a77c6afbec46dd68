"""The readers of the program's spans (``core/program_spans.py`` and the
five metrics that use it): the clock offset found from a known one, the
device-idle and device-busy time by innermost span against a reading
microsecond by microsecond, a root's own time counted as unexplained,
nothing read where the program has no spans; and one shrunk traced CPU
run of each cell, whose line carries all five."""

import statistics
from typing import NamedTuple

import pytest

from conftest import ROOT, run_cell
from drcbench.core import program_spans
from drcbench.core.harness import Cell, Run

NEW = ("enc.signatures_ms", "enc.build.values_ms", "enc.build.points_ms",
       "enc.chains.payloads_ms", "idle.unexplained")
BASE_NS = 1_790_000_000_000_000_000  # the program's Unix ns at the trace's 0
DELAYS = (4, 5, 9)  # us from each request span to its first root


class Span(NamedTuple):  # torchdraco.trace.Span's fields
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    root: int
    attrs: dict


# one request, in us from its first root's start: (name, start, end,
# parent's index in this list)
REQUEST = [("build_meshes", 0, 4000, None),
           ("build.values", 10, 1010, 0), ("build.values", 1100, 2100, 0),
           ("build.values", 2200, 3200, 0), ("build.points", 3300, 3800, 0),
           ("encode_meshes_device", 4005, 9985, None),
           ("signatures", 4015, 5015, 5), ("chains", 5100, 8100, 5),
           ("chains.payloads", 5200, 6200, 7), ("assembly", 8200, 9900, 5)]
DEVICE = [(5500, 5700), (7900, 8150), (9950, 9990)]  # us, as REQUEST's


def _window(delays=DELAYS):
    """(program spans, request spans, device events) of three requests
    10 ms apart, each root ``delays`` after its request span opens."""
    program, requests, dev = [], [], []
    for r, delay in enumerate(delays):
        t0 = 1000.0 + 10_000.0 * r
        requests.append((t0, t0 + delay + 9990.0, f"request {r} encode"))
        ids = []
        for name, a, b, parent in REQUEST:
            i = len(program) + 1
            pid = ids[parent] if parent is not None else None
            root = i if pid is None else program[pid - 1].root
            start = BASE_NS + round((t0 + delay) * 1e3)
            program.append(Span(name, start + a * 1000, start + b * 1000, i,
                                pid, root, {}))
            ids.append(i)
        dev += [{"cat": "kernel", "name": "k", "ts": t0 + delay + a,
                 "dur": b - a} for a, b in DEVICE]
    return program, requests, dev


def _run(monkeypatch, program) -> Run:
    monkeypatch.setattr(program_spans, "recorded", lambda: program)
    run = Run(Cell(ROOT, "dfaust.encode"), seed=1, seconds=1.0)
    _, run.spans, run.device_events = _window()
    run.requests = [{"index": i} for i in range(len(run.spans))]
    return run


def test_clock_offset_is_found():
    program, requests, _ = _window()
    offset, spread = program_spans.clock_offset(program, requests)
    q1, _, q3 = statistics.quantiles(DELAYS, n=4)
    assert offset == BASE_NS + 1000 * statistics.median(DELAYS)
    assert isinstance(offset, int)
    assert spread == pytest.approx(q3 - q1)
    # the latest roots pair with the requests; too few pair with nothing
    stale = [s._replace(start_ns=s.start_ns - 10**12, end_ns=s.end_ns
                        - 10**12, id=-s.id) for s in program]
    assert program_spans.clock_offset(stale + program, requests) \
        == (offset, spread)
    assert program_spans.clock_offset(program[:10], requests) is None
    w = program_spans.Window(stale + program, requests)
    assert len(w.spans) == len(program)


def _by_microsecond(w: program_spans.Window, dev) -> dict:
    """The table of ``by_innermost``, counted a microsecond at a time."""
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    depth = {}
    for _, _, s in w.spans:
        depth[s.id] = 0 if s.parent is None else depth[s.parent] + 1
    out: dict = {}
    t = w.lo
    while t < w.hi:
        inside = [(depth[s.id], s) for a, b, s in w.spans if a <= t < b]
        if inside:
            s = max(inside, key=lambda x: x[0])[1]
            label = s.name + (" (self)" if s.parent is None else "")
        else:
            label = program_spans.NO_SPAN
        on = any(a <= t < b for a, b in busy)
        out.setdefault(label, [0.0, 0.0])[on] += 1.0
        t += 1.0
    return out


def test_time_by_innermost_span():
    program, requests, dev = _window(delays=(5, 5, 5))
    w = program_spans.Window(program, requests)
    got = program_spans.by_innermost(dev, w)
    want = _by_microsecond(w, dev)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    # per request: 500 us of build_meshes' own time; 280 of
    # encode_meshes_device's, 50 + 35 of them busy
    assert got["build_meshes (self)"] == pytest.approx([1500.0, 0.0])
    assert got["encode_meshes_device (self)"] == pytest.approx(
        [3 * 195.0, 3 * 85.0])
    assert got["chains.payloads"] == pytest.approx([3 * 800.0, 3 * 200.0])
    idle = sum(v[0] for v in got.values())
    lost = (got["build_meshes (self)"][0]
            + got["encode_meshes_device (self)"][0]
            + got[program_spans.NO_SPAN][0])
    assert program_spans.unexplained_share(got) == pytest.approx(
        100 * lost / idle)


def test_span_readers(monkeypatch):
    program, _, _ = _window()
    run = _run(monkeypatch, program)
    r = run.cell.readers
    assert r["enc.signatures_ms"].value(run) == pytest.approx(1.0)
    assert r["enc.build.values_ms"].value(run) == pytest.approx(3.0)
    assert r["enc.build.points_ms"].value(run) == pytest.approx(0.5)
    assert r["enc.chains.payloads_ms"].value(run) == pytest.approx(1.0)
    w = program_spans.window(run)
    assert r["idle.unexplained"].value(run) == pytest.approx(
        program_spans.unexplained_share(
            program_spans.by_innermost(run.device_events, w)))
    # build.values elsewhere than under build_meshes is not mesh building
    moved = [s._replace(root=program[5].root, parent=program[5].id)
             if s.name == "build.values" else s for s in program]
    run = _run(monkeypatch, moved)
    assert r["enc.build.values_ms"].value(run) == 0.0


def test_span_readers_without_spans(monkeypatch):
    program, _, _ = _window()
    for got in (None, [], [s for s in program if s.name != "build_meshes"]):
        run = _run(monkeypatch, got)
        for name in NEW:
            assert run.cell.readers[name].value(run) is None, name
    run = _run(monkeypatch, program)
    run.device_events = None
    assert run.cell.readers["idle.unexplained"].value(run) is None
    run.spans = []
    assert run.cell.readers["enc.signatures_ms"].value(run) is None


@pytest.mark.parametrize("cell", ["dfaust.encode", "sim1m.encode"])
def test_traced_run_prints_the_span_metrics(tiny_root, capsys, cell):
    from torchdraco import trace

    trace.clear()
    line = run_cell(tiny_root, cell, capsys, trace=1)
    trace.clear()
    assert line["correct"]
    m = line["metrics"]
    for name in NEW:
        assert name in m, name
    for name in NEW[:4]:
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    assert 0 <= m["idle.unexplained"]["value"] < 100
    assert m["idle.unexplained"]["unit"] == "%"

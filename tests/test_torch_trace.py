"""The port's span recorder (``torchdraco.trace``) on the CPU: nothing is
kept without a profiler; under ``torch.profiler.profile`` the encode
routes and ``build_meshes`` give their documented spans, nested in their
parents and sharing their call's root; the dedup spans count the rows
they were given and the distinct rows they found; the ``assembly`` span counts
the chain attributes whose portabilization was carried and those it ran
again; the encoders' ``timings`` are the
totals of those spans, a nested root's adding to its caller's; and the
spans sit on the clock of the profiler's Chrome trace."""

import json
import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

import torchdraco
from torchdraco import native, trace
from torchdraco.parallel import batch as tbatch

GROUP = {"encode_meshes_device", "signatures", "topology", "position",
         "chains", "chains.payloads", "assembly"}
RESIDENT = {"encode_mesh_device", "signatures", "topology", "position",
            "chains", "chains.payloads", "assembly", "assembly.rans"}


def _arrays(frames: int = 3, n: int = 9):
    pos, faces = torchdraco.make_mesh_batch(frames, n, seed=4)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed=5)
    return pos, faces, nrm, uvs


@pytest.fixture
def encoder():
    trace.clear()
    yield tbatch.BatchEncoder(device="cpu", route_cache_path=None)
    trace.clear()


def _traced(fn):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, trace.spans(), prof


def _calls(spans) -> dict:
    """{root id: spans of that call}."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.root, []).append(s)
    return out


def _check_nesting(spans) -> None:
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent is None:
            assert s.root == s.id
            continue
        p = by_id[s.parent]
        assert p.root == s.root
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_nothing_is_kept_without_a_profiler(encoder):
    pos, faces, nrm, uvs = _arrays()
    assert not trace.recording()
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    encoder.encode_meshes_device(meshes)
    encoder.encode_mesh_device(meshes[0])
    assert trace.spans() == [] and trace.dropped() == 0
    assert encoder.timings["chains_s"] > 0


@pytest.mark.parametrize("route", ["group", "resident"])
def test_encode_routes_give_their_spans(encoder, route):
    pos, faces, nrm, uvs = _arrays()
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    if route == "group":
        blobs, spans, _ = _traced(
            lambda: encoder.encode_meshes_device(meshes))
        want, name, n = GROUP, "encode_meshes_device", len(meshes)
    else:
        blobs, spans, _ = _traced(lambda: [encoder.encode_mesh_device(m)
                                           for m in meshes])
        want, name, n = RESIDENT, "encode_mesh_device", 1
    assert blobs == tbatch.BatchEncoder(
        device="cpu", route_cache_path=None).encode_meshes_device(meshes)
    assert encoder.n_host_attributes == 0
    calls = _calls(spans)
    assert len(calls) == (1 if route == "group" else len(meshes))
    for call in calls.values():
        assert {s.name for s in call} == want
        root = [s for s in call if s.parent is None]
        assert [(s.name, s.attrs) for s in root] == [(name, {"meshes": n})]
        # one payload span a chain (NORMAL, TEX_COORD), inside ``chains``,
        # with the meshes it coded and skipped, the bits RAbS-coded and
        # whether the one native call wrote them
        chains = next(s for s in call if s.name == "chains")
        payloads = [s for s in call if s.name == "chains.payloads"]
        assert [s.parent for s in payloads] == [chains.id] * 2
        nrm, uv = (s.attrs for s in sorted(payloads,
                                           key=lambda s: s.start_ns))
        points = meshes[0].num_points
        assert nrm == {"meshes": n, "skipped": 0, "bits": n * points,
                       "native": True}
        assert set(uv) == set(nrm) and uv["native"] is True
        assert (uv["meshes"], uv["skipped"]) == (n, 0)
        assert 0 < uv["bits"] <= n * points
    _check_nesting(spans)


@pytest.mark.parametrize("library", [True, False])
def test_payload_spans_count_skipped_meshes(encoder, monkeypatch, library):
    """A mesh with a zero normal leaves the NORMAL chain's entries (the
    host codes it): the span counts it as skipped, and says whether the
    native call ran."""
    if not library:
        monkeypatch.setattr(native, "load_library", lambda: None)
    pos, faces, nrm, uvs = _arrays(4)
    nrm[2, 5] = 0.0
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    blobs, spans, _ = _traced(lambda: encoder.encode_meshes_device(meshes))
    assert blobs == [tbatch.encode_with_topology(
        m, tbatch.PreparedTopology(m)) for m in meshes]
    got = [s.attrs for s in sorted(spans, key=lambda s: s.start_ns)
           if s.name == "chains.payloads"]
    points = meshes[0].num_points
    assert got[0] == {"meshes": 3, "skipped": 1, "bits": 3 * points,
                      "native": library}
    assert (got[1]["meshes"], got[1]["skipped"], got[1]["native"]) \
        == (4, 0, library)
    assert len(got) == 2


@pytest.mark.parametrize("route", ["group", "resident"])
def test_assembly_counts_carried_and_ported(encoder, route):
    """The ``assembly`` span counts the NORMAL and TEX_COORD attributes
    whose chain entry carried their portabilization and those it
    portabilized itself: here the one normal that a zero value sent to
    the host encoder."""
    pos, faces, nrm, uvs = _arrays(4)
    nrm[2, 5] = 0.0
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    if route == "group":
        _, spans, _ = _traced(lambda: encoder.encode_meshes_device(meshes))
        want = [{"carried": 7, "ported": 1}]
    else:
        _, spans, _ = _traced(lambda: [encoder.encode_mesh_device(m)
                                       for m in meshes])
        want = [{"carried": 2, "ported": 0}] * 2 + [
            {"carried": 1, "ported": 1}, {"carried": 2, "ported": 0}]
    got = [s.attrs for s in sorted(spans, key=lambda s: s.start_ns)
           if s.name == "assembly"]
    assert got == want
    assert encoder.n_host_attributes == 1


def test_build_meshes_gives_values_and_points_spans():
    frames = 4
    pos, faces, nrm, uvs = _arrays(frames)
    _, spans, _ = _traced(lambda: torchdraco.build_meshes(pos, faces, nrm,
                                                          uvs))
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "build_meshes" and root.attrs == {"meshes": frames}
    names = sorted(s.name for s in spans if s.parent == root.id)
    assert names == ["build.points"] * frames + ["build.values"] * 3 * frames
    assert all(s.root == root.id for s in spans)
    _check_nesting(spans)


@pytest.mark.parametrize("hashed", [True, False])
def test_dedup_spans_count_rows_and_merges(monkeypatch, hashed):
    """``build.values`` and ``build.points`` carry the rows they were
    given, the distinct rows found and whether the native hash ran, on
    frames with seams (one attribute copied between vertices) and
    duplicated corners (every attribute copied)."""
    if not hashed:
        monkeypatch.setattr(native, "load_library", lambda: None)
    frames = 2
    pos, faces, nrm, uvs = _arrays(frames)
    pos[:, 20] = pos[:, 7]
    nrm[:, 10] = nrm[:, 2]
    uvs[:, 5] = uvs[:, 3]
    for a in (pos, nrm, uvs):
        a[:, 30] = a[:, 40]
    _, spans, _ = _traced(lambda: torchdraco.build_meshes(pos, faces, nrm,
                                                          uvs))
    spans = sorted(spans, key=lambda s: s.start_ns)
    values = [s.attrs for s in spans if s.name == "build.values"]
    points = [s.attrs for s in spans if s.name == "build.points"]
    n = pos.shape[1]
    assert int(faces.max()) + 1 == n

    def distinct(*arrays) -> int:
        return len({b"".join(a[i].tobytes() for a in arrays)
                    for i in range(n)})

    want_values, want_points = [], []
    for b in range(frames):
        want_values += [dict(rows=n, unique=distinct(a[b]), native=hashed)
                        for a in (pos, nrm, uvs)]
        want_points.append(dict(rows=n, unique=distinct(pos[b], nrm[b],
                                                        uvs[b]),
                                native=hashed))
    assert values == want_values and points == want_points
    assert [v["unique"] for v in values[:3]] == [n - 2, n - 2, n - 2]
    assert points[0]["unique"] == n - 1


def _seconds(spans, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-9


@pytest.mark.parametrize("route", ["group", "resident"])
def test_timings_are_the_span_totals(encoder, monkeypatch, route):
    """K1's plain version builds no tile tables: a stand-in asks for them
    as the tiled kernel does, so that ``position.tiles`` counts as
    topology work."""
    step = tbatch.encode_step_from_q_cuda

    def tiled_step(*args, tiles=None, **kw):
        tiles()
        return step(*args, **kw)

    monkeypatch.setattr(tbatch, "encode_step_from_q_cuda", tiled_step)
    pos, faces, nrm, uvs = _arrays()
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    if route == "group":
        _, spans, _ = _traced(lambda: encoder.encode_meshes_device(meshes))
    else:
        _, spans, _ = _traced(lambda: encoder.encode_mesh_device(meshes[0]))
    t = encoder.timings
    tiles = _seconds(spans, "position.tiles")
    assert tiles > 0
    topology = _seconds(spans, "topology") + tiles
    if route == "group":
        assert set(t) == {"signatures_s", "topology_s", "position_s",
                          "chains_s", "assembly_s", "h2d_mb"}
        assert t["signatures_s"] == pytest.approx(
            _seconds(spans, "signatures"), rel=1e-12, abs=1e-15)
    else:
        assert set(t) == {"topology_s", "position_s", "chains_s",
                          "assembly_s"}
        topology += _seconds(spans, "signatures")
    want = {"topology_s": topology,
            "position_s": _seconds(spans, "position") - tiles,
            "chains_s": _seconds(spans, "chains"),
            "assembly_s": _seconds(spans, "assembly")}
    for k, v in want.items():
        assert t[k] == pytest.approx(v, rel=1e-12, abs=1e-15), k
    # untraced, the same keys from the same sites
    encoder.timings = {}
    if route == "group":
        encoder.encode_meshes_device(meshes)
    else:
        encoder.encode_mesh_device(meshes[0])
    assert set(encoder.timings) == set(t)
    assert trace.spans() == spans


def test_spans_sit_on_the_chrome_trace_clock(encoder, tmp_path):
    pos, faces, nrm, uvs = _arrays()

    def run():
        meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
        return encoder.encode_meshes_device(meshes)

    _, spans, prof = _traced(run)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"
              and e.get("name", "").startswith(trace.PREFIX)]
    assert len(events) == len(spans)
    for name in {s.name for s in spans}:
        mine = sorted(s.start_ns / 1e3 for s in spans if s.name == name)
        theirs = sorted(e["ts"] + base_us for e in events
                        if e["name"] == trace.PREFIX + name)
        assert len(theirs) == len(mine)
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1000.0


def test_the_record_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    _, spans, _ = _traced(lambda: torchdraco.build_meshes(*_arrays(2)))
    assert len(spans) == 3 and trace.dropped() == 2 * 4 + 1 - 3
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


@pytest.mark.parametrize("traced", [False, True])
def test_a_nested_root_adds_its_totals_to_the_enclosing_root(monkeypatch,
                                                             traced):
    """A root opened under another (the router's device-plane calls) keeps
    its own totals and adds them to the enclosing root's when it closes;
    a clock that ticks 1 ns a read makes each empty ``timed`` span 1 ns."""
    ticks = iter(range(1 << 20))
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks), time_ns=time.time_ns))

    def call():
        with trace.root("outer") as outer:
            with trace.timed("a"):
                pass
            with trace.root("inner") as inner:
                with trace.timed("a"):
                    pass
                with trace.timed("b"):
                    pass
            with trace.span("c"):
                pass
        return outer.totals, inner.totals

    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            outer, inner = call()
        assert [s.name for s in trace.spans()] == ["a", "a", "b", "inner",
                                                   "c", "outer"]
        trace.clear()
    else:
        outer, inner = call()
    assert inner == {"a": 1, "b": 1}
    assert outer == {"a": 2, "b": 1}
    with trace.root("after") as after:
        pass
    assert after.totals == {}

"""The router (``BatchEncoder.encode_meshes_auto``) over a request of takes
on the CPU (``device="cpu"``): takes of three lattice sizes, each with its
own quad diagonals, so each its own topology. Its bytes equal those of
tpudraco's ``encode()``, mesh for mesh, with both planes in use; under a
torch profiler the call is one ``encode_meshes_auto`` root with a
``route.group`` span a topology and the probes nested in them; its
``timings`` count the groups and the meshes and sum the stages of every
device-plane call.

The planes are the real ones. Only the router's clock is a stand-in,
which the planes advance by a set cost a mesh, so that the decisions are
known beforehand."""

import numpy as np
import pytest

pytest.importorskip("jax")  # tpudraco.ops imports it
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco import trace  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.encode import encode  # noqa: E402

STAGES = ("signatures_s", "topology_s", "position_s", "chains_s",
          "assembly_s", "h2d_mb")
# (lattice side, frames, seed) of each take
TAKES = ((5, 6, 1), (7, 24, 2), (9, 2, 3), (5, 1, 4))
HOST_S = 0.010  # the stand-in clock's host plane, a mesh
DEVICE_S = {25: 0.050, 49: 0.001}  # its device plane a mesh, by vertices


def _take(n: int, frames: int, seed: int) -> list:
    """``frames`` meshes of an n x n lattice whose quads are split along
    diagonals drawn from ``seed``, with normals and UVs."""
    pos, faces = torchdraco.make_mesh_batch(frames, n, seed)
    quads = faces.reshape(-1, 2, 3)  # (a, a+1, a+n), (a+1, a+n+1, a+n)
    a, b, c, d = (quads[:, 0, 0], quads[:, 0, 1], quads[:, 0, 2],
                  quads[:, 1, 1])
    other = np.stack([np.stack([a, b, d], 1), np.stack([a, d, c], 1)], 1)
    flip = np.random.RandomState(seed).rand(len(quads)) < 0.5
    faces = np.where(flip[:, None, None], other, quads).reshape(-1, 3)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture
def routed(monkeypatch):
    """(encoder, meshes, the ``timings`` of each ``encode_meshes_device``
    call): the router forced to probe every group of MIN_DEVICE_GROUP (3)
    meshes or more, on a clock that the planes advance."""
    clock = _Clock()
    monkeypatch.setattr(tbatch, "_clock", clock)
    enc = tbatch.BatchEncoder(device="cpu", route_cache_path=None)
    enc.MIN_DEVICE_GROUP, enc.PROBE_SKIP_S = 3, 0.0
    inner = []

    def host(mesh, cfg=None):
        clock.now += HOST_S
        return tbatch.BatchEncoder.encode_mesh(enc, mesh, cfg)

    def device_plane(meshes, device=None):
        out = tbatch.BatchEncoder._device_plane(enc, meshes, device)
        clock.now += DEVICE_S[meshes[0].position_attribute().num_points] \
            * len(meshes)
        return out

    def group(meshes, **kw):
        out = tbatch.BatchEncoder.encode_meshes_device(enc, meshes, **kw)
        inner.append(dict(enc.timings))
        return out

    enc.encode_mesh, enc._device_plane = host, device_plane
    enc.encode_meshes_device = group
    meshes = [m for t in TAKES for m in _take(*t)]
    trace.clear()
    yield enc, meshes, inner
    trace.clear()


def test_takes_of_three_sizes_take_both_planes_byte_for_byte(routed):
    enc, meshes, _ = routed
    want = [encode(m) for m in meshes]
    assert enc.encode_meshes_auto(meshes) == want
    log = [(e["verts"], e["meshes"], e["plane"], e.get("reason"))
           for e in enc.routing_log]
    # the 5 x 5 take probed to the host, the 7 x 7 one to the device, the
    # 9 x 9 pair too small to probe, the lone mesh static
    assert log == [(25, 6, "host", None), (49, 24, "device", None),
                   (81, 2, "host", "small group"),
                   (25, 1, "host", "single mesh (static)")]
    t = enc.timings
    # the host probes 4 + 4, the device plane 2 (the 5 x 5 take's probe),
    # 16 (the 7 x 7 one's) and the 4 after it, the host 2 + 1 more
    assert {k: t[k] for k in tbatch._ROUTE_COUNTS} == {
        "groups": 4, "groups_measured": 2, "groups_cached": 0,
        "groups_static": 2, "meshes_device": 22, "meshes_host": 11}
    assert t["meshes_device"] + t["meshes_host"] == len(meshes)
    # again: the two measured decisions are kept, the bytes the same
    assert enc.encode_meshes_auto(meshes) == want
    assert [e["reason"] for e in enc.routing_log[4:]] == [
        "cached decision (memory)", "cached decision (memory)",
        "small group", "single mesh (static)"]
    t = enc.timings
    assert (t["groups_cached"], t["groups_static"], t["meshes_device"]) \
        == (2, 2, 24)
    assert t["route_probe_host_s"] == t["route_probe_device_s"] == 0.0


def _seconds(spans, name: str) -> float:
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-9


def test_the_router_root_holds_its_groups_probes_and_summed_stages(routed):
    enc, meshes, inner = routed
    with profile(activities=[ProfilerActivity.CPU]):
        enc.encode_meshes_auto(meshes)
    spans = trace.spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "encode_meshes_auto"
    assert root.attrs == {"meshes": len(meshes), "groups": len(TAKES)}
    assert all(s.root == root.id for s in spans)
    by_id = {s.id: s for s in spans}
    groups = [s for s in spans if s.name == "route.group"]
    assert [s.parent for s in groups] == [root.id] * len(TAKES)
    assert [(g.attrs["meshes"], g.attrs["verts"], g.attrs["plane"],
             g.attrs["source"]) for g in groups] == [
        (6, 25, "host", "measured"), (24, 49, "device", "measured"),
        (2, 81, "host", "small"), (1, 25, "host", "static")]
    # the probes inside the two measured groups; the host plane's other
    # encodes in route.host; each device-plane call a nested root
    for name, parents in (("route.probe.host", groups[:2]),
                          ("route.probe.device", groups[:2]),
                          ("route.host", groups[2:])):
        assert [by_id[s.parent] for s in spans if s.name == name] \
            == parents, name
    calls = [s for s in spans if s.name == "encode_meshes_device"]
    assert [by_id[s.parent].name for s in calls] == [
        "route.probe.device", "route.probe.device", "route.group"]
    assert {by_id[s.parent].name for s in spans
            if s.name in ("position", "chains", "assembly")} \
        == {"encode_meshes_device"}
    # the grouping's signatures beside those of each device-plane call
    assert [by_id[s.parent].name for s in spans if s.name == "signatures"] \
        == ["encode_meshes_auto"] + ["encode_meshes_device"] * 3
    t = enc.timings
    assert len(inner) == 3
    for k in STAGES:
        assert t[k] == pytest.approx(sum(i[k] for i in inner), rel=1e-12,
                                     abs=1e-15), k
    assert t["chains_s"] == pytest.approx(_seconds(spans, "chains"),
                                          rel=1e-9)
    for k in ("route.probe.host", "route.probe.device", "route.host"):
        got = t[k.replace(".", "_") + "_s"]
        assert got > 0 and got == pytest.approx(_seconds(spans, k),
                                                rel=1e-9), k
    assert t["meshes_device"] + t["meshes_host"] == len(meshes) \
        == sum(g.attrs["meshes"] for g in groups)


def test_untraced_the_router_keeps_its_timings_and_no_spans(routed):
    enc, meshes, inner = routed
    enc.encode_meshes_auto(meshes)
    assert trace.spans() == []
    t = enc.timings
    assert set(t) == set(STAGES) | set(tbatch._ROUTE_COUNTS) | {
        "route_probe_host_s", "route_probe_device_s", "route_host_s"}
    assert t["chains_s"] == pytest.approx(sum(i["chains_s"] for i in inner))
    # the device probes (the first two calls) hold those calls' stages
    assert t["route_probe_device_s"] >= sum(c[k] for c in inner[:2]
                                            for k in STAGES[:-1])

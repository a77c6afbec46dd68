"""torchdraco's corpus entry points on the CPU against tpudraco's:
encode_corpus on the three planes, the router (encode_meshes_auto) with its
decision cache and throughput estimates, encode_meshes_device's host and
coder, decode_corpus, transcode_corpus and both CLIs. The port runs
with ``device="cpu"`` (the kernels' plain twins), tpudraco on JAX's CPU
backend; the same files, written from numpy seeds, go through both, and
every output file is held to tpudraco's byte for byte."""

import json
import os
import subprocess
import sys
import time
import types

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.io import save_obj, save_ply, save_scene_glb  # noqa: E402
from torchdraco.models.scene import Scene  # noqa: E402
from torchdraco.parallel import BatchDecoder as TDecoder  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from torchdraco.parallel import transcode as ttrans  # noqa: E402
from torchdraco.tools import corpus as tcorpus  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.io import load_mesh  # noqa: E402
from tpudraco.parallel import BatchDecoder as JDecoder  # noqa: E402
from tpudraco.parallel import batch as jbatch  # noqa: E402
from tpudraco.parallel import transcode as jtrans  # noqa: E402
from torchdraco.encode import Config as PortConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(n, batch, seed, normals_uvs=True):
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed)
    if not normals_uvs:
        return torchdraco.build_meshes(pos, faces)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)


def _write_corpus(d) -> list[str]:
    """Two topologies interleaved (6 x 6 and 5 x 5 grids with normals and
    UVs, PLY), a GLB and an OBJ of a third, a broken file, and a second
    m00.ply in a subdirectory whose output name collides."""
    os.makedirs(os.path.join(d, "sub"))
    a, b = _meshes(6, 5, 1), _meshes(5, 5, 3)
    paths = []
    for i in range(10):
        p = os.path.join(d, f"m{i:02d}.ply")
        save_ply((a if i % 2 else b)[i // 2], p)
        paths.append(p)
    sc = Scene()
    sc.add_mesh(_meshes(4, 1, 7)[0])
    save_scene_glb(sc, os.path.join(d, "g.glb"), compress=False)
    save_obj(_meshes(4, 1, 9, normals_uvs=False)[0], os.path.join(d, "o.obj"))
    with open(os.path.join(d, "bad.ply"), "wb") as f:
        f.write(b"not a mesh")
    save_ply(a[0], os.path.join(d, "sub", "m00.ply"))
    return paths[:5] + [os.path.join(d, n) for n in (
        "g.glb", "bad.ply", "o.obj")] + paths[5:] + [
        os.path.join(d, "sub", "m00.ply")]


def _files(d, ext=".drc") -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(ext)}


def _strip(report: dict) -> dict:
    """A report without its timing fields (the wall time, and the port's
    stage times) and tpudraco's counts of device groups it encoded on the
    host, which the port never does (its device failures raise)."""
    return {k: v for k, v in report.items()
            if k not in ("seconds", "stages_s", "device_fallback_groups",
                         "device_fallback_meshes")}


_REF_RUNS: dict = {}


def _reference_encode(tmp_path_factory, inputs, plane, window, cfg_kind):
    key = (plane, window, cfg_kind, tuple(inputs))
    if key not in _REF_RUNS:
        out = str(tmp_path_factory.mktemp("ref"))
        cfg = _cfg("tpu", cfg_kind)
        rep = jbatch.BatchEncoder(use_device=plane, cfg=cfg,
                                  route_cache_path=None).encode_corpus(
            inputs, out, device_window=window)
        _REF_RUNS[key] = (_strip(rep), _files(out))
    return _REF_RUNS[key]


def _cfg(pkg, kind):
    if kind is None:
        return None
    mod = (PortConfig if pkg == "port" else Config)
    return mod(use_single_connectivity=True)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    return d, _write_corpus(d)


@pytest.mark.parametrize("plane,window,workers,cfg_kind", [
    (plane, window, workers, None) for plane in (True, False, "auto")
    for window in (3, 100) for workers in (1, 4)]
    + [(True, 100, 1, "beyond")])
def test_encode_corpus_matches_tpudraco(monkeypatch, tmp_path,
                                        tmp_path_factory, corpus_dir, plane,
                                        window, workers, cfg_kind):
    """Every .drc equals tpudraco's encode_corpus output and encode() of
    the loaded mesh; the reports are equal apart from the wall time; a
    second run resumes, skipping every file and calling no device plane.
    The router's groups here are below MIN_DEVICE_GROUP in both packages
    (set to tpudraco's 16), so its decisions are the static ones."""
    _, inputs = corpus_dir
    monkeypatch.setattr(tbatch.BatchEncoder, "MIN_DEVICE_GROUP", 16)
    monkeypatch.setattr(jbatch.BatchEncoder, "MIN_DEVICE_GROUP", 16)
    ref_rep, ref_files = _reference_encode(tmp_path_factory, inputs, plane,
                                           window, cfg_kind)
    out = str(tmp_path / "out")
    enc = tbatch.BatchEncoder(cfg=_cfg("port", cfg_kind), use_device=plane,
                              device="cpu", route_cache_path=None)
    rep = enc.encode_corpus(inputs, out, workers=workers,
                            device_window=window)
    assert _strip(rep) == ref_rep
    got = _files(out)
    assert got == ref_files and len(got) == 12
    assert rep["encoded"] == 12 and len(rep["failed"]) == 2
    assert rep.get("device_disabled_by_cfg", False) == (cfg_kind is not None)
    loaded = {os.path.splitext(os.path.basename(p))[0] + ".drc": p
              for p in reversed(inputs)}
    for name, blob in got.items():
        assert blob == encode(load_mesh(loaded[name]),
                              cfg=_cfg("tpu", cfg_kind)), name
    with open(os.path.join(out, "corpus_report.json")) as f:
        assert json.load(f) == rep

    def no_plane(*a, **k):
        raise AssertionError("a resumed run called a device plane")
    monkeypatch.setattr(enc, "encode_meshes_device", no_plane)
    monkeypatch.setattr(enc, "encode_meshes_auto", no_plane)
    again = enc.encode_corpus(inputs, out, workers=workers,
                              device_window=window)
    assert again["skipped"] == 12 and again["encoded"] == 0


def _failing_step(real, verts):
    def step(batch, *a, **k):
        if batch.shape[1] == verts:
            raise RuntimeError("injected device failure")
        return real(batch, *a, **k)
    return step


@pytest.mark.parametrize("entry", ("corpus", "corpus_auto", "router",
                                   "router_lone", "transcode"))
def test_device_failure_raises(monkeypatch, tmp_path, corpus_dir, entry):
    """A device step that fails (on the 6 x 6 grids; the lone mesh's
    route) raises out of every driver: encode_corpus on the device plane
    and the router, encode_meshes_auto on a probed group and on a lone
    huge mesh, transcode_corpus. Nothing is encoded on the host in its
    place."""
    _, inputs = corpus_dir
    monkeypatch.setattr(tbatch, "device_encode_group", _failing_step(
        tbatch.device_encode_group, 36))
    monkeypatch.setattr(tbatch.BatchEncoder, "PROBE_SKIP_S", 0.0)
    monkeypatch.setattr(tbatch.BatchEncoder, "CHUNKED_MIN_VERTS", 16)

    def huge_fails(self, mesh, device=None):
        raise RuntimeError("injected device failure")
    monkeypatch.setattr(tbatch.BatchEncoder, "_encode_huge", huge_fails)
    auto = tbatch.BatchEncoder(use_device="auto", device="cpu",
                               route_cache_path=None)
    call = {
        "corpus": lambda: tbatch.BatchEncoder(device="cpu").encode_corpus(
            inputs, str(tmp_path / "e")),
        "corpus_auto": lambda: auto.encode_corpus(inputs,
                                                  str(tmp_path / "a")),
        "router": lambda: auto.encode_meshes_auto(_meshes(6, 20, 11)),
        "router_lone": lambda: auto.encode_meshes_auto(
            _meshes(10, 1, 13, normals_uvs=False)),
        "transcode": lambda: ttrans.transcode_corpus(
            _glb_corpus(str(tmp_path)), str(tmp_path / "t"), device="cpu"),
    }[entry]
    with pytest.raises(RuntimeError, match="injected"):
        call()


def _nan_corpus(d) -> tuple[list[str], str]:
    """Seven 6 x 6 grids with normals and UVs (PLY), and an eighth of the
    same topology whose first vertex is NaN: it loads, and the host
    encoder refuses it."""
    meshes = _meshes(6, 8, 17)
    meshes[7].position_attribute().values[0, :] = float("nan")
    paths = []
    for i, m in enumerate(meshes):
        paths.append(os.path.join(d, f"n{i}.ply"))
        save_ply(m, paths[-1])
    return paths, paths[-1]


@pytest.mark.parametrize("plane", (True, "auto", False))
def test_nan_vertex_file_fails_alone(monkeypatch, tmp_path, plane):
    """A file that loads and then fails to encode (a NaN vertex) is
    reported in ``failed`` with the host encoder's error, as tpudraco
    reports it, and the seven files of its topology group are encoded,
    equal to tpudraco's. The router probes the group (PROBE_SKIP_S 0), so
    the group goes to the device plane there too. tpudraco's routing is
    not compared: its group counts the refused mesh."""
    inputs, bad = _nan_corpus(str(tmp_path))
    monkeypatch.setattr(tbatch.BatchEncoder, "PROBE_SKIP_S", 0.0)
    out, ref = str(tmp_path / "out"), str(tmp_path / "ref")
    enc = tbatch.BatchEncoder(use_device=plane, device="cpu",
                              route_cache_path=None)
    rep = enc.encode_corpus(inputs, out)
    want = jbatch.BatchEncoder(use_device=plane,
                               route_cache_path=None).encode_corpus(
        inputs, ref)
    assert ({k: v for k, v in _strip(rep).items() if k != "routing"}
            == {k: v for k, v in _strip(want).items() if k != "routing"})
    assert rep["encoded"] == 7 and [f["path"] for f in rep["failed"]] == [bad]
    assert "non-finite" in rep["failed"][0]["error"]
    assert _files(out) == _files(ref) and len(_files(out)) == 7
    if plane == "auto":
        (entry,) = rep["routing"]
        assert entry["meshes"] == 7 and "device_s_per_mesh" in entry


class _FakeClock:
    """A clock the planes' stand-ins advance: the host plane by ``host``
    seconds a mesh, the device plane by ``dev`` seconds a mesh."""

    def __init__(self, host, dev):
        self.now, self.host, self.dev = 0.0, host, dev

    def __call__(self):
        return self.now


def _stub_planes(enc, clock, pkg):
    def host(mesh, cfg=None):
        clock.now += clock.host
        return b"host"

    def device(meshes, *a, **k):
        clock.now += clock.dev * len(meshes)
        return [b"device"] * len(meshes)
    enc.encode_mesh = host
    if pkg == "port":
        enc._device_plane = device
    else:
        enc.encode_meshes_device = device


def _router(pkg, monkeypatch, clock, cache):
    if pkg == "port":
        monkeypatch.setattr(tbatch, "_clock", clock)
        enc = tbatch.BatchEncoder(use_device="auto", device="cpu",
                                  route_cache_path=cache)
    else:
        monkeypatch.setattr(jbatch, "time", types.SimpleNamespace(
            perf_counter=clock, time=time.time))
        enc = jbatch.BatchEncoder(use_device="auto", route_cache_path=cache)
    _stub_planes(enc, clock, pkg)
    return enc


def test_router_reuses_its_own_decision(monkeypatch, tmp_path):
    """Under a patched clock (host 10 ms a mesh, device 20 ms): a group
    of 512 is probed once and routed to the host; on a second pass the
    same encoder reuses that decision, and a fresh encoder on the same
    cache file reads it from disk. tpudraco stores the probe's width plus
    its host meshes (132) as the decision's basis, so neither of its
    encoders reuses the decision for the group of 512: it probes again.
    The routing entries have tpudraco's keys."""
    meshes = _meshes(3, 512, 5, normals_uvs=False)
    entries = {}
    for pkg in ("port", "tpu"):
        cache = str(tmp_path / f"{pkg}.json")
        clock = _FakeClock(0.01, 0.02)
        enc = _router(pkg, monkeypatch, clock, cache)
        first = enc.encode_meshes_auto(meshes)
        assert first.count(b"device") == 128  # the probe's, kept
        enc.encode_meshes_auto(meshes)
        fresh = _router(pkg, monkeypatch, clock, cache)
        fresh.encode_meshes_auto(meshes)
        entries[pkg] = (enc.routing_log, fresh.routing_log)
    (p1, p2), (f1,) = entries["port"][0], entries["port"][1]
    assert p1["plane"] == "host" and "device_s_per_mesh" in p1
    assert p2 == {**{k: p1[k] for k in ("group", "meshes", "verts")},
                  "plane": "host", "reason": "cached decision (memory)"}
    assert f1["reason"] == "cached decision (disk)"
    (j1, j2), (jf1,) = entries["tpu"][0], entries["tpu"][1]
    assert "reason" not in j2 and "reason" not in jf1  # probed again
    assert p1.keys() == j1.keys() and p2.keys() <= j1.keys() | {"reason"}
    with open(tmp_path / "port.json") as f:
        stored = json.load(f)["entries"]
    assert [e["n_basis"] for k, e in stored.items()
            if not k.startswith("__mbs__")] == [512]
    assert all(k.endswith("|cpu") for k in stored)


def test_router_estimates_keep_size_classes_apart(monkeypatch):
    """Host observations on small meshes (9 vertices, 100 MB/s) and the
    lone-mesh route's on its own size (100 vertices, 1 MB/s): the port
    has no host estimate for the lone mesh's size class and keeps the
    static rule, so the mesh reaches _encode_huge; tpudraco pools every
    host observation and sends the mesh to the host plane."""
    monkeypatch.setattr(tbatch.BatchEncoder, "CHUNKED_MIN_VERTS", 16)
    monkeypatch.setattr(jbatch.BatchEncoder, "CHUNKED_MIN_VERTS", 16)
    (lone,) = _meshes(10, 1, 21, normals_uvs=False)
    port = tbatch.BatchEncoder(use_device="auto", device="cpu",
                               route_cache_path=None)
    port._note_mbs("host", 8e6, 0.08, 9)
    port._note_mbs("huge_device", 2e6, 2.0, 100)
    assert port._mbs_estimate("host", 9) == pytest.approx(100.0)
    assert port._mbs_estimate("host", 100) is None
    assert port._mbs_estimate("huge_device", 127) == pytest.approx(1.0)
    calls = []
    real = port._encode_huge
    monkeypatch.setattr(port, "_encode_huge", lambda m, device=None: (
        calls.append(m), real(m, device=device))[1])
    assert port.encode_meshes_auto([lone]) == [encode(lone)]
    assert calls == [lone]
    assert port.routing_log[-1]["plane"] == "device"
    assert port.routing_log[-1]["reason"] == "single mesh (static)"
    ref = jbatch.BatchEncoder(use_device="auto", route_cache_path=None)
    ref._note_mbs("host", 8e6, 0.08)
    ref._note_mbs("huge_device", 2e6, 2.0)
    huge = []
    monkeypatch.setattr(ref, "_encode_huge_safe",
                        lambda m: huge.append(m) or b"")
    assert ref.encode_meshes_auto([lone]) == [encode(lone)]
    assert huge == [] and ref.routing_log[-1]["plane"] == "host"


def test_router_bytes_and_disk_decisions(tmp_path):
    """The router on the real planes (the CPU twins): a probed group, a
    small group and a lone mesh give encode()'s bytes; a fresh encoder on
    the same cache routes the probed group from disk, with the same
    bytes."""
    meshes = (_meshes(6, 20, 31) + _meshes(5, 3, 33)
              + _meshes(7, 1, 35, normals_uvs=False))
    want = [encode(m) for m in meshes]
    cache = str(tmp_path / "route.json")
    runs = []
    for _ in range(2):
        enc = tbatch.BatchEncoder(use_device="auto", device="cpu",
                                  route_cache_path=cache)
        enc.MIN_DEVICE_GROUP, enc.PROBE_SKIP_S = 16, 0.0
        assert enc.encode_meshes_auto(meshes) == want
        runs.append({e["meshes"]: e for e in enc.routing_log})
    first, second = runs
    assert "device_s_per_mesh" in first[20]
    assert first[3]["reason"] == "small group"
    assert first[1]["reason"] == "single mesh (static)"
    assert second[20]["reason"] == "cached decision (disk)"
    assert second[20]["plane"] == first[20]["plane"]


@pytest.mark.parametrize("bits", (11, 13, 17))
def test_encode_meshes_device_host_coder(bits):
    """entropy="host" gives the bytes of entropy="device" and of
    tpudraco's entropy="host", at the default depths and at -qp 13; the
    host coder also runs past 16 bits (int32 readback). tpudraco's
    "auto" is not ported, and raises."""
    meshes = _meshes(6, 3, 41) + _meshes(5, 2, 43)
    port = tbatch.BatchEncoder(device="cpu")
    got = port.encode_meshes_device(meshes, bits=bits, entropy="host")
    assert got == port.encode_meshes_device(meshes, bits=bits)
    ref = jbatch.BatchEncoder(strict_device=True).encode_meshes_device(
        meshes, bits=bits, entropy="host")
    assert got == ref
    with pytest.raises(ValueError, match="'device' or 'host'"):
        port.encode_meshes_device(meshes, bits=bits, entropy="auto")


def _drc_corpus(d) -> list[str]:
    blobs = [encode(m) for m in _meshes(6, 4, 51) + _meshes(5, 2, 53)]
    paths = []
    for i, b in enumerate(blobs):
        p = os.path.join(d, f"d{i}.drc")
        with open(p, "wb") as f:
            f.write(b)
        paths.append(p)
    bad = os.path.join(d, "bad.drc")
    with open(bad, "wb") as f:
        f.write(blobs[0][:40])
    return paths[:3] + [bad] + paths[3:]


@pytest.mark.parametrize("fmt", ("obj", "ply"))
@pytest.mark.parametrize("use_device", (True, False))
def test_decode_corpus_matches_tpudraco(monkeypatch, tmp_path, use_device,
                                        fmt):
    """decode_corpus writes tpudraco's files, reports the bad blob the
    same way, and a second run resumes: only the bad blob, which has no
    output, is read again."""
    inputs = _drc_corpus(str(tmp_path))
    out, ref = str(tmp_path / "out"), str(tmp_path / "ref")
    dec = TDecoder()
    rep = dec.decode_corpus(inputs, out, fmt=fmt, use_device=use_device,
                            device="cpu")
    want = JDecoder().decode_corpus(inputs, ref, fmt=fmt,
                                    use_device=use_device)
    assert _strip(rep) == _strip(want)
    assert rep["decoded"] == 6 and len(rep["failed"]) == 1
    assert _files(out, "." + fmt) == _files(ref, "." + fmt)
    seen = []
    real = dec.decode_blobs_shared_topology
    monkeypatch.setattr(dec, "decode_blobs_shared_topology",
                        lambda blobs, **k: seen.extend(blobs)
                        or real(blobs, **k))
    again = dec.decode_corpus(inputs, out, fmt=fmt, use_device=use_device,
                              device="cpu")
    assert again["skipped"] == 6 and again["decoded"] == 0
    assert again["failed"] == rep["failed"]
    assert seen == ([open(inputs[3], "rb").read()] if use_device else [])


def _glb_corpus(d, normals_uvs=True) -> list[str]:
    """Six GLBs of 2-3 primitives from two topologies (with normals and
    UVs by default); file 5 repeats file 0's primitives."""
    pools = [_meshes(6, 4, 61, normals_uvs), _meshes(5, 4, 63, normals_uvs)]
    paths = []
    for i in range(6):
        sc = Scene()
        k = 0 if i == 5 else i
        for j in range(2 + k % 2):
            sc.add_mesh(pools[(k + j) % 2][(k + j) % 4])
        p = os.path.join(d, f"s{i}.glb")
        save_scene_glb(sc, p, compress=False)
        paths.append(p)
    with open(os.path.join(d, "broken.glb"), "wb") as f:
        f.write(b"glTF\x02\x00\x00\x00broken")
    return paths + [paths[1], os.path.join(d, "broken.glb")]


@pytest.mark.parametrize("cfg_kind", ("default", "quantization", "level"))
def test_transcode_corpus_matches_tpudraco(tmp_path, cfg_kind):
    """transcode_corpus writes tpudraco's GLBs and the per-file
    DracoTranscoder's; a quantization-only cfg stays on the device plane
    with no hook miss, a -cl cfg takes the host encoder and still
    matches."""
    from torchdraco.io import DracoTranscoder
    from torchdraco.models import AttributeType as PT
    from tpudraco.models import AttributeType as JT
    inputs = _glb_corpus(str(tmp_path))
    cfgs = {"default": (None, None),
            "quantization": tuple(c(quant_bits={t.POSITION: 12,
                                                t.TEX_COORD: 11})
                                  for c, t in ((PortConfig, PT),
                                               (Config, JT))),
            "level": (PortConfig.from_level(9), Config.from_level(9))}
    pcfg, jcfg = cfgs[cfg_kind]
    out, ref = str(tmp_path / "out"), str(tmp_path / "ref")
    rep = ttrans.transcode_corpus(inputs, out, cfg=pcfg, device="cpu")
    want = jtrans.transcode_corpus(inputs, ref, cfg=jcfg)
    assert _strip(rep) == _strip(want)
    assert rep["transcoded"] == 6 and len(rep["failed"]) == 1
    got = _files(out, ".glb")
    assert got == _files(ref, ".glb") and len(got) == 6
    if cfg_kind == "level":
        assert "encoder_hook_misses" not in rep
    else:
        assert rep["encoder_hook_misses"] == 0
    one = str(tmp_path / "one.glb")
    DracoTranscoder(cfg=pcfg).transcode_file(inputs[0], one)
    assert open(one, "rb").read() == got["s0.glb"]
    host = ttrans.transcode_corpus(inputs, str(tmp_path / "host"), cfg=pcfg,
                                   use_device=False)
    assert _files(str(tmp_path / "host"), ".glb") == got
    assert "encoder_hook_misses" not in host
    # the device plane over a shard axis of three: the same files
    sharded = ttrans.transcode_corpus(inputs, str(tmp_path / "sharded"),
                                      cfg=pcfg, device="cpu",
                                      mesh_axis=["cpu"] * 3)
    assert _files(str(tmp_path / "sharded"), ".glb") == got
    assert sharded.get("encoder_hook_misses") == rep.get(
        "encoder_hook_misses")


def test_mesh_content_key_matches_tpudraco():
    """The transcode key hashes the same fields in both packages."""
    for m in _meshes(5, 2, 71) + _meshes(4, 1, 73, normals_uvs=False):
        assert ttrans.mesh_content_key(m) == jtrans.mesh_content_key(m)


_BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpudraco"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""

# the runs of both CLIs, in one process per package: the corpus CLI as
# ``python -m <pkg>.tools.corpus`` (run_module), and the single-file CLI
_RUN_CLIS = """
import json, runpy, sys
sys.path.insert(0, {root!r})
runs = {runs!r}
rcs = []
for module, argv in runs:
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        rcs.append(0)
    except SystemExit as e:
        rcs.append(e.code)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tpudraco"))
print(json.dumps({{"rcs": rcs, "foreign": foreign}}))
"""


def _cli_runs(pkg, d, dev_args, corpus_in, drcs, glbs, obj, glb):
    o = os.path.join(d, pkg)
    corpus = f"{pkg}.tools.corpus"
    cli = f"{pkg}.tools.cli"
    return [
        (corpus, ["encode", "-i", corpus_in, "-o", f"{o}/enc", "--workers",
                  "2", *dev_args]),
        (corpus, ["decode", "-i", *drcs, "-o", f"{o}/dec", "--fmt", "ply",
                  *dev_args]),
        (corpus, ["transcode", "-i", *glbs, "-o", f"{o}/tr", "-qp", "12",
                  *dev_args]),
        (cli, ["-i", obj, "-o", f"{o}/one.drc", "-q"]),
        (cli, ["-i", f"{o}/one.drc", "-o", f"{o}/one.ply", "-q"]),
        (cli, ["-i", glb, "-o", f"{o}/one.glb", "-q"]),
    ]


def test_clis_match_tpudraco(tmp_path):
    """``python -m torchdraco.tools.corpus`` encode, decode and transcode
    with ``--device cpu``, and the single-file ``torchdraco.tools.cli``,
    in a process that refuses jax and tpudraco, write the files that
    tpudraco's CLIs write (``--device``, JAX on the CPU); both corpus
    CLIs exit 1 on the failed inputs. The inputs are small and carry
    positions only, so that JAX compiles little."""
    d = str(tmp_path)
    src = os.path.join(d, "meshes")
    os.makedirs(src)
    meshes = _meshes(5, 3, 91, normals_uvs=False)
    for i, m in enumerate(meshes):
        save_ply(m, os.path.join(src, f"c{i}.ply"))
    with open(os.path.join(src, "bad.ply"), "wb") as f:
        f.write(b"not a mesh")
    obj = os.path.join(src, "one.obj")
    save_obj(meshes[0], obj)
    drcs = []
    for i, m in enumerate(meshes):
        drcs.append(os.path.join(d, f"c{i}.drc"))
        with open(drcs[-1], "wb") as f:
            f.write(encode(m))
    drcs.append(os.path.join(d, "bad.drc"))
    with open(drcs[-1], "wb") as f:
        f.write(b"DRACO")
    glb_dir = os.path.join(d, "glbs")
    os.makedirs(glb_dir)
    glbs = _glb_corpus(glb_dir, normals_uvs=False)[:2]
    results = {}
    for pkg, dev_args, prefix in (("torchdraco", ["--device", "cpu"],
                                   _BLOCK_JAX),
                                  ("tpudraco", ["--device"], "")):
        runs = _cli_runs(pkg, d, dev_args, src, drcs, glbs, obj, glbs[0])
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   TORCHDRACO_ROUTE_CACHE="")
        proc = subprocess.run(
            [sys.executable, "-c", prefix + _RUN_CLIS.format(
                root=ROOT, runs=runs)],
            capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        results[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert results["torchdraco"]["foreign"] == []
    assert results["torchdraco"]["rcs"] == results["tpudraco"]["rcs"] \
        == [1, 1, 0, 0, 0, 0]
    for sub, ext, n in (("enc", ".drc", 4), ("dec", ".ply", 3),
                        ("tr", ".glb", 2)):
        got = _files(os.path.join(d, "torchdraco", sub), ext)
        assert len(got) == n
        assert got == _files(os.path.join(d, "tpudraco", sub), ext)
    for name in ("one.drc", "one.ply", "one.glb"):
        a = open(os.path.join(d, "torchdraco", name), "rb").read()
        assert a == open(os.path.join(d, "tpudraco", name), "rb").read()


@pytest.mark.parametrize("command", ("encode", "decode", "transcode"))
def test_cli_needs_the_card_or_an_answer(monkeypatch, capsys, tmp_path,
                                         corpus_dir, command):
    """Without a card and without --device cpu or --host-only the corpus
    CLI exits non-zero with an error that names both; --host-only runs
    the host plane, and its files equal the device plane's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, _ = corpus_dir
    if command == "decode":
        src = os.path.dirname(_drc_corpus(str(tmp_path))[0])
    elif command == "transcode":
        os.makedirs(tmp_path / "g")
        src = os.path.dirname(_glb_corpus(str(tmp_path / "g"))[0])
    out = str(tmp_path / "out")
    assert tcorpus.main([command, "-i", src, "-o", out]) == 2
    err = capsys.readouterr().err
    assert "--device cpu" in err and "--host-only" in err
    assert "CUDA is not available" in err
    assert not os.path.exists(out)
    ext = {"encode": ".drc", "decode": ".obj", "transcode": ".glb"}[command]
    tcorpus.main([command, "-i", src, "-o", out, "--host-only"])
    tcorpus.main([command, "-i", src, "-o", out + "_cpu", "--device", "cpu"])
    host = _files(out, ext)
    assert host and host == _files(out + "_cpu", ext)


@pytest.mark.parametrize("name", ("encode_corpus", "encode_meshes_auto",
                                  "decode_corpus", "transcode_corpus"))
def test_corpus_entry_points_default_to_the_card(monkeypatch, tmp_path,
                                                 corpus_dir, name):
    """The corpus entry points ask for the card by default and raise
    without one; the host plane (use_device=False) needs none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, inputs = corpus_dir
    drcs = _drc_corpus(str(tmp_path))
    call = {
        "encode_corpus": lambda **kw: tbatch.BatchEncoder(**kw)
        .encode_corpus(inputs, str(tmp_path / "e")),
        "encode_meshes_auto": lambda **kw: tbatch.BatchEncoder(
            route_cache_path=None, **kw).encode_meshes_auto(
            _meshes(4, 2, 81)),
        "decode_corpus": lambda **kw: TDecoder().decode_corpus(
            drcs, str(tmp_path / "d"), **kw),
        "transcode_corpus": lambda **kw: ttrans.transcode_corpus(
            _glb_corpus(str(tmp_path)), str(tmp_path / "t"), **kw),
    }[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    if name != "encode_meshes_auto":
        assert call(use_device=False)

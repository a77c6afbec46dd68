"""torchdraco's batch encoder (positions, normals, UVs), end to end on the
CPU: its .drc bytes against tpudraco.encode.encode and against tpudraco's
own device batch encoder, in process, and in processes that show the port
loads nothing of JAX or of the tpudraco package."""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.device import resolve  # noqa: E402
from torchdraco.encode import Config as PortConfig  # noqa: E402
from torchdraco.models import AttributeType as PortAttributeType  # noqa: E402
from torchdraco.ops import normals as tnormals  # noqa: E402
from torchdraco.ops import rans_lanes as trl  # noqa: E402
from torchdraco.parallel import BatchDecoder  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.models import AttributeType  # noqa: E402
from tpudraco.parallel import BatchEncoder as JaxBatchEncoder  # noqa: E402
from tpudraco.parallel import batch as jbatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread, so that a run of
    the whole suite in several worker processes is not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# a finder that refuses jax and tpudraco, as on a machine with neither
_BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpudraco"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""

# the slice on the CPU: a batch encode, a device-entropy group decode and
# the host codec's own encode() and decode(); then what got loaded
_RUN_SLICE = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
import torchdraco
from torchdraco.decode import decode
from torchdraco.encode import encode
from torchdraco.parallel import BatchDecoder, BatchEncoder
pos, faces = torchdraco.make_mesh_batch(4, 8, 7)
meshes = torchdraco.build_meshes(pos, faces)
blobs = BatchEncoder().encode_meshes_device(meshes, bits=11, device="cpu")
assert blobs == [encode(m) for m in meshes]
bd = BatchDecoder()
out = bd.decode_blobs_shared_topology(blobs, entropy="device", device="cpu")
assert bd.n_host_blobs == 0
for b, m in zip(blobs, out):
    ref = decode(b)
    assert np.array_equal(m.faces, ref.faces)
    assert np.array_equal(m.attributes[0].values, ref.attributes[0].values)
# the default attribute set: positions, normals and UVs through the
# device chains, and back through the phased decode
nrm, uvs = torchdraco.make_normal_uv_batch(pos, 8, 5)
meshes3 = torchdraco.build_meshes(pos, faces, nrm, uvs)
enc3 = BatchEncoder()
blobs3 = enc3.encode_meshes_device(meshes3, device="cpu")
assert blobs3 == [encode(m) for m in meshes3]
assert enc3.n_host_attributes == 0
for entropy in ("host", "device"):
    out3 = bd.decode_blobs_shared_topology(blobs3, entropy=entropy,
                                           normals="device", device="cpu")
    assert "normals_s" in bd.timings and bd.n_host_blobs == 0
    for b, m in zip(blobs3, out3):
        ref = decode(b)
        assert all(np.array_equal(x.values, y.values)
                   for x, y in zip(m.attributes, ref.attributes))
assert "torchdraco.ops.normals" in sys.modules
assert "torchdraco.ops.texcoords" in sys.modules
# the corpus entry points, the io copies and the CLIs load too
import torchdraco.io, torchdraco.parallel.transcode
import torchdraco.tools.cli, torchdraco.tools.corpus
# and the several-device plane: the multi-process corpus, and the sharded
# paths on an axis of two CPU shards
import torchdraco.parallel.multihost
torchdraco.dryrun_multichip(2, device="cpu")
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tpudraco"))
print(json.dumps({{"foreign": foreign,
                  "blobs": [b.hex() for b in blobs],
                  "blobs3": [b.hex() for b in blobs3]}}))
"""


def _run_slice(prefix=""):
    proc = subprocess.run(
        [sys.executable, "-c", prefix + _RUN_SLICE.format(root=ROOT)],
        capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _slice_meshes():
    """4 grids of 8 x 8 and one of 6 x 6: two topology groups."""
    pos8, faces8 = torchdraco.make_mesh_batch(4, 8, seed=2)
    pos6, faces6 = torchdraco.make_mesh_batch(1, 6, seed=3)
    m8 = torchdraco.build_meshes(pos8, faces8)
    m6 = torchdraco.build_meshes(pos6, faces6)
    return [m8[0], m8[1], m6[0], m8[2], m8[3]]


@pytest.mark.parametrize("bits", (11, 13))
def test_slice_bytes_match_encode_and_jax_batch(bits):
    meshes = _slice_meshes()
    cfg = None if bits == 11 else Config(quant_bits={AttributeType.POSITION:
                                                     bits})
    port_cfg = None if bits == 11 else PortConfig(
        quant_bits={PortAttributeType.POSITION: bits})
    enc = tbatch.BatchEncoder()
    got = enc.encode_meshes_device(meshes, bits=bits, entropy="device",
                                   device="cpu")
    assert len(enc._topo_cache) == 2
    want_jax = JaxBatchEncoder(strict_device=True).encode_meshes_device(
        meshes, bits=bits, entropy="device")
    for m, g, j in zip(meshes, got, want_jax):
        assert g == encode(m, cfg=cfg)
        assert g == j
    # the same depth set through the encoder's Config
    assert tbatch.BatchEncoder(cfg=port_cfg).encode_meshes_device(
        meshes, device="cpu") == got


def _slice_reference_blobs():
    pos, faces = torchdraco.make_mesh_batch(4, 8, 7)
    return [encode(m) for m in torchdraco.build_meshes(pos, faces)]


def _slice_reference_blobs3():
    pos, faces = torchdraco.make_mesh_batch(4, 8, 7)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, 8, 5)
    return [encode(m) for m in torchdraco.build_meshes(pos, faces, nrm, uvs)]


def test_slice_runs_without_jax():
    """The port's slice in a process whose import system refuses jax and
    tpudraco: it runs on the port's own host codec, and the bytes are
    tpudraco's host encoder's."""
    got = _run_slice(_BLOCK_JAX)
    assert got["foreign"] == []
    assert [bytes.fromhex(h) for h in got["blobs"]] \
        == _slice_reference_blobs()
    assert [bytes.fromhex(h) for h in got["blobs3"]] \
        == _slice_reference_blobs3()


def test_port_loads_nothing_of_jax_or_tpudraco():
    """Where jax and tpudraco ARE installed, an encode and a decode
    through the port still load no module of either (so no JAX backend can
    start, which on a GPU machine would take most of the card's memory)."""
    got = _run_slice()
    assert got["foreign"] == []
    assert [bytes.fromhex(h) for h in got["blobs"]] \
        == _slice_reference_blobs()
    assert [bytes.fromhex(h) for h in got["blobs3"]] \
        == _slice_reference_blobs3()


def test_port_sources_import_neither_jax_nor_tpudraco():
    """No import line of the port or of chip_smoke.py names jax or
    tpudraco (docstrings may name a counterpart by path), and the bridge
    module is gone."""
    files = glob.glob(os.path.join(ROOT, "torchdraco", "**", "*.py"),
                      recursive=True)
    files += [os.path.join(ROOT, n) for n in ("chip_smoke.py", "chip_ab.py")]
    assert len(files) > 40
    pat = re.compile(
        r"^\s*(import|from)\s+\.*(jax|jaxlib|tpudraco)\b|"
        r"^\s*import\s+.*\b(jax|jaxlib|tpudraco)\b|"
        r"import_module\(\s*['\"](jax|tpudraco)", re.M)
    hits = []
    for path in files:
        with open(path) as f:
            text = f.read()
        hits += [(os.path.relpath(path, ROOT), m.group(0).strip())
                 for m in pat.finditer(text)]
    assert hits == []
    assert not os.path.exists(os.path.join(ROOT, "torchdraco", "_host.py"))


def test_mesh_batch_and_entry_match_graft_entry():
    import __graft_entry__ as ge

    for args in ((3, 5, 0), (2, 9, 4)):
        a, fa = torchdraco.make_mesh_batch(*args)
        b, fb = ge._make_mesh_batch(*args)
        assert np.array_equal(a, b) and np.array_equal(fa, fb)
    fn, args = torchdraco.entry(device="cpu")
    syms, counts = fn(*args)
    jfn, jargs = ge.entry()
    jsyms, jcounts = jfn(*jargs)
    assert np.array_equal(syms.numpy(), np.asarray(jsyms).astype(np.int64))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))


def test_host_helpers_match_tpudraco():
    pos, faces = torchdraco.make_mesh_batch(3, 7, seed=9)
    m0 = torchdraco.build_meshes(pos[:1], faces)[0]
    assert tbatch.topology_signature(m0) == jbatch.topology_signature(m0)
    t_topo, j_topo = tbatch.PreparedTopology(m0), jbatch.PreparedTopology(m0)
    assert t_topo.conn_bytes == j_topo.conn_bytes
    assert t_topo.sequences == j_topo.sequences
    gt = tbatch.topology_gathers_np(t_topo, m0.position_attribute())
    gj = jbatch.topology_gathers_np(j_topo, m0.position_attribute())
    assert gt.keys() == gj.keys()
    assert all(np.array_equal(gt[k], gj[k]) for k in gt)
    for bits in (8, 11, 20):
        for a, b in zip(tbatch.quantize_positions_host(pos, bits),
                        jbatch.quantize_positions_host(pos, bits)):
            assert np.array_equal(a, b)
    # each package takes its own Config (equal fields, its own classes)
    for kw in (None, {"quant_bits": {"POSITION": 14}},
               {"quant_bits": {"NORMAL": 3}}, {"symbol_coding": "length"}):
        cfgs = []
        for cls, types in ((PortConfig, PortAttributeType),
                           (Config, AttributeType)):
            if kw is None:
                cfgs.append(None)
            elif "quant_bits" in kw:
                cfgs.append(cls(quant_bits={
                    types[k]: v for k, v in kw["quant_bits"].items()}))
            else:
                cfgs.append(cls(**kw))
        assert (tbatch._device_quant_bits(cfgs[0])
                == jbatch._device_quant_bits(cfgs[1]))
    import dataclasses
    assert (dataclasses.asdict(tbatch._merged_quant_cfg(None, 13, 8, 10))
            == dataclasses.asdict(jbatch._merged_quant_cfg(None, 13, 8, 10)))


def test_gathers_to_torch_layout():
    pos, faces = torchdraco.make_mesh_batch(1, 6)
    m0 = torchdraco.build_meshes(pos, faces)[0]
    g_np = tbatch.topology_gathers_np(tbatch.PreparedTopology(m0),
                                      m0.position_attribute())
    g = tbatch.gathers_to_torch(g_np, "cpu")
    for k, v in g.items():
        want = torch.bool if k in ("can_para", "has_fallback") else \
            torch.int32
        assert v.dtype == want and np.array_equal(v.numpy(), g_np[k])
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    assert all(np.array_equal(np.asarray(jg[k]), g[k].numpy()) for k in g)


def test_attributes_beyond_position_raise():
    """A mesh with an attribute beyond POSITION no longer raises
    NotImplementedError: it encodes, to encode()'s bytes. What still
    raises: an entropy mode that does not exist, depths out of range."""
    from tpudraco.models import AttributeDomain, MeshBuilder

    pos, faces = torchdraco.make_mesh_batch(1, 5)
    mb = MeshBuilder()
    mb.set_connectivity_attribute(faces)
    pid = mb.add_attribute(pos[0], AttributeType.POSITION,
                           AttributeDomain.POSITION)
    nrm = np.tile(np.float32([0, 0, 1]), (pos.shape[1], 1))
    mb.add_attribute(nrm, AttributeType.NORMAL, AttributeDomain.CORNER,
                     parents=[pid])
    mesh = mb.build()
    enc = tbatch.BatchEncoder()
    assert enc.encode_meshes_device([mesh], device="cpu") == [encode(mesh)]
    assert enc.n_host_attributes == 0
    with pytest.raises(ValueError):
        tbatch.BatchEncoder().encode_meshes_device([], entropy="sideways")
    with pytest.raises(ValueError, match="7..16"):
        tbatch.BatchEncoder().encode_meshes_device([mesh], normal_bits=5,
                                                   device="cpu")


def _grid_meshes3(n, batch, seed):
    """``batch`` grids of n x n with positions, normals and UVs per
    corner: the default attribute set, one topology group."""
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)


def _random_meshes3(n, batch, seed):
    """A grid with a fifth of its faces taken out (boundaries, holes) and
    the rest shuffled, random positions, normals of any length, random
    UVs."""
    rng = np.random.RandomState(seed)
    _, faces = torchdraco.make_mesh_batch(1, n, 0)
    faces = faces[rng.rand(len(faces)) < 0.8]
    faces = faces[rng.permutation(len(faces))]
    pos = (rng.randn(batch, n * n, 3) * 50).astype(np.float32)
    nrm = rng.randn(batch, n * n, 3).astype(np.float32)
    uvs = rng.rand(batch, n * n, 2).astype(np.float32)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)


def _no_host_fallback(monkeypatch):
    def no_fallback(self, mesh, cfg=None):
        raise AssertionError("fell back to host encode")
    monkeypatch.setattr(JaxBatchEncoder, "encode_mesh", no_fallback)


@pytest.mark.parametrize("kind", ("grid", "random"))
@pytest.mark.parametrize("depths", ((11, 8, 10), (12, 10, 12), (10, 16, 16)))
def test_slice_with_normals_and_uvs_bytes_match(monkeypatch, kind, depths):
    """The counterpart of tests/test_parallel.py's
    test_device_batch_encode_normals_bit_exact and of its depth overrides:
    pos+normal+UV meshes give encode()'s bytes and those of tpudraco's
    encode_meshes_device, through the chains (entries really produced,
    nothing sent to the host)."""
    qp, qn, qt = depths
    make = _grid_meshes3 if kind == "grid" else _random_meshes3
    meshes = make(7, 3, qp) + make(6, 2, qn)  # two topology groups
    kw = {} if depths == (11, 8, 10) else {
        "quant_bits": {"POSITION": qp, "NORMAL": qn, "TEX_COORD": qt}}
    cfg = Config(quant_bits={AttributeType[k]: v for k, v in
                             kw["quant_bits"].items()}) if kw else None
    enc = tbatch.BatchEncoder()
    got = enc.encode_meshes_device(meshes, bits=qp, normal_bits=qn,
                                   uv_bits=qt, device="cpu")
    assert enc.n_host_attributes == 0
    assert set(enc.timings) == {"signatures_s", "topology_s", "position_s",
                                "chains_s", "assembly_s"}
    _no_host_fallback(monkeypatch)
    want_jax = JaxBatchEncoder(strict_device=True).encode_meshes_device(
        meshes, bits=qp, normal_bits=qn, uv_bits=qt, entropy="device")
    for m, g, j in zip(meshes, got, want_jax):
        assert g == encode(m, cfg=cfg)
        assert g == j
    # the same depths through the encoder's Config
    port_cfg = PortConfig(quant_bits={
        PortAttributeType[k]: v for k, v in kw["quant_bits"].items()}) \
        if kw else None
    assert tbatch.BatchEncoder(cfg=port_cfg).encode_meshes_device(
        meshes, device="cpu") == got
    # and the device entries were really produced, as tpudraco's are
    topo = enc._topo_cache[tbatch.topology_signature(meshes[0])]
    entries = tbatch._device_extra_attribute_entries(
        meshes, [0, 1, 2], topo, bits=qp, normal_bits=qn, uv_bits=qt,
        device="cpu")
    j_topo = jbatch.PreparedTopology(meshes[0])
    j_entries = jbatch._device_extra_attribute_entries(
        meshes, [0, 1, 2], j_topo, bits=qp, chunk=4, normal_bits=qn,
        uv_bits=qt)
    assert sorted(entries) == [0, 1, 2]
    for k in range(3):
        assert sorted(entries[k]) == [1, 2]  # the normal and the UV entry
        for ai in (1, 2):
            assert entries[k][ai] == j_entries[k][ai]
    # an out-of-range normal depth routes the normals to the host
    entries6 = tbatch._device_extra_attribute_entries(
        meshes, [0, 1, 2], topo, bits=qp, normal_bits=6, device="cpu")
    assert all(1 not in entries6.get(k, {}) and 2 in entries6[k]
               for k in range(3))


def test_nonfinite_uvs_raise_canonical_error():
    """The counterpart of test_device_batch_nonfinite_uvs_route_to_host_error:
    NaN UVs drop the UV chain for their chunk, so the host path meets them
    and raises encode()'s own error; the port has no per-mesh None."""
    meshes = _grid_meshes3(7, 3, 0)
    bad = _grid_meshes3(7, 1, 9)[0]
    bad.attributes[2].values[3, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite") as want:
        encode(bad)
    with pytest.raises(ValueError, match="non-finite") as got:
        tbatch.BatchEncoder().encode_meshes_device(meshes + [bad],
                                                   device="cpu")
    assert str(got.value) == str(want.value)
    # the finite meshes of such a group, alone, are untouched
    enc = tbatch.BatchEncoder()
    assert enc.encode_meshes_device(meshes, device="cpu") \
        == [encode(m) for m in meshes]


def test_normal_guards_route_and_are_counted(monkeypatch):
    """The counterpart of test_device_batch_normal_guards, with the
    routing counted: (a) a zero normal sends that mesh's NORMAL attribute,
    and nothing else, to the host encoder; (b) an integer-normal sibling
    (same signature) keeps the whole attribute off the chain; (c) position
    depths past the ring's int32 headroom do too. The bytes never depend
    on which side coded an attribute."""
    meshes = _grid_meshes3(6, 3, 1)
    meshes[1].attributes[1].values[3] = 0.0
    enc = tbatch.BatchEncoder()
    got = enc.encode_meshes_device(meshes, device="cpu")
    assert enc.n_host_attributes == 1
    topo = enc._topo_cache[tbatch.topology_signature(meshes[0])]
    entries = tbatch._device_extra_attribute_entries(
        meshes, [0, 1, 2], topo, bits=11, device="cpu")
    assert [sorted(entries[k]) for k in range(3)] == [[1, 2], [2], [1, 2]]
    _no_host_fallback(monkeypatch)
    want_jax = JaxBatchEncoder(strict_device=True).encode_meshes_device(
        meshes, entropy="device")
    for m, g, j in zip(meshes, got, want_jax):
        assert g == encode(m) and g == j
    # a second call keeps counting
    enc.encode_meshes_device(meshes, device="cpu")
    assert enc.n_host_attributes == 2

    int_mesh = _grid_meshes3(5, 1, 7)[0]
    vals = int_mesh.attributes[1].values
    int_mesh.attributes[1].values = np.clip(vals * 100, -127, 127).astype(
        np.int32)
    enc = tbatch.BatchEncoder()
    assert enc.encode_meshes_device([int_mesh], device="cpu") \
        == [encode(int_mesh)]
    assert enc.n_host_attributes == 1

    # tests/test_phased_decode.py's deep-depth case: -qp 18 on spread
    # positions, where ring sums pass 2^31
    deep = _grid_meshes3(9, 4, 11)
    for m in deep:
        m.attributes[0].values = (m.attributes[0].values
                                  * np.float32(1e4)).astype(np.float32)
    cfg = Config(quant_bits={AttributeType.POSITION: 18})
    enc = tbatch.BatchEncoder()
    got = enc.encode_meshes_device(deep, bits=18, device="cpu")
    assert got == [encode(m, cfg=cfg) for m in deep]
    assert got == JaxBatchEncoder(strict_device=True, cfg=cfg) \
        .encode_meshes_device(deep, entropy="device")
    # every normal by the headroom rule; UV rows by the chain's own guard
    assert enc.n_host_attributes >= len(deep)


def test_risky_uv_rows_take_the_host_for_that_mesh_only(monkeypatch):
    """A mesh the UV chain flags risky keeps its position and normal
    entries and has its UVs coded by the host; the bytes are encode()'s."""
    meshes = _grid_meshes3(7, 4, 3)
    real = tbatch.uv_encode_chain_sharded

    def flag_one(*a, **kw):
        out = list(real(*a, **kw))
        out[5] = out[5].copy()
        out[5][2] = True
        out[0] = out[0].copy()
        out[0][2] = 0  # the risky mesh's symbols are not to be used
        return tuple(out)
    monkeypatch.setattr(tbatch, "uv_encode_chain_sharded", flag_one)
    enc = tbatch.BatchEncoder()
    got = enc.encode_meshes_device(meshes, device="cpu")
    assert got == [encode(m) for m in meshes]
    assert enc.n_host_attributes == 1


@pytest.mark.parametrize("chain", ("normal_encode_chain", "uv_encode_chain"))
def test_chain_error_propagates(monkeypatch, chain):
    """An exception inside a device chain raises out of the encoder: no
    group is re-encoded on the host."""
    def boom(*a, **kw):
        raise RuntimeError(f"{chain} broke")
    monkeypatch.setattr(tbatch, f"{chain}_sharded", boom)
    with pytest.raises(RuntimeError, match=f"{chain} broke"):
        tbatch.BatchEncoder().encode_meshes_device(_grid_meshes3(6, 2, 0),
                                                   device="cpu")


def test_chunks_share_the_uploaded_positions(monkeypatch):
    """Each chunk's chains read the tensor the fused step uploaded (no
    second quantize or upload), and chunking does not change a byte."""
    meshes = _grid_meshes3(6, 5, 2)
    want = tbatch.BatchEncoder().encode_meshes_device(meshes, device="cpu")
    seen = []
    real = tbatch._device_extra_attribute_entries

    def spy(meshes_, idxs, topo, q_pos=None, **kw):
        seen.append((list(idxs), q_pos))
        return real(meshes_, idxs, topo, q_pos=q_pos, **kw)
    monkeypatch.setattr(tbatch, "_device_extra_attribute_entries", spy)
    monkeypatch.setattr(tbatch.BatchEncoder, "DEVICE_CHUNK", 2)
    quantized = []
    real_q = tbatch._host_quantize
    monkeypatch.setattr(tbatch, "_host_quantize", lambda b, bits: (
        quantized.append(b.shape) or real_q(b, bits)))
    assert tbatch.BatchEncoder().encode_meshes_device(
        meshes, device="cpu") == want
    assert [idxs for idxs, _ in seen] == [[0, 1], [2, 3], [4]]
    # one shard: the axis is the one device
    assert all(len(q) == 1 and isinstance(q[0], torch.Tensor)
               and q[0].dtype == torch.uint16 and q[0].shape[0] == len(idxs)
               for idxs, q in seen)
    # per chunk: the positions once, the UVs once
    assert [s[-1] for s in quantized] == [3, 2] * 3


def test_prepared_topology_chain_tables():
    meshes = _grid_meshes3(6, 1, 4)
    t_topo = tbatch.PreparedTopology(meshes[0])
    j_topo = jbatch.PreparedTopology(meshes[0])
    rt, rj = t_topo.rings_for(1), j_topo.rings_for(1)
    assert rt.keys() == rj.keys()
    assert all(np.array_equal(rt[k], rj[k]) for k in rt)
    assert t_topo.rings_for(1) is rt  # cached
    n_pts = meshes[0].position_attribute().num_points
    from tpudraco.ops.texcoords import collect_uv_gathers
    gj = collect_uv_gathers(j_topo.view_for(2), j_topo.sequences[2], n_pts)
    gt = t_topo.uv_gathers_for(2, n_pts)
    assert gt.keys() == gj.keys()
    assert all(np.array_equal(gt[k], gj[k]) for k in gt)
    dev_r = t_topo.dev_rings_for(1, torch.device("cpu"))
    assert dev_r is t_topo.dev_rings_for(1, torch.device("cpu"))
    assert dev_r["next_pt"].dtype == torch.int64
    assert np.array_equal(dev_r["next_pt"].numpy(), rt["next_pt"])


def test_resolve_never_drops_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve("cpu") == torch.device("cpu")
    for asked in (None, "cuda"):  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve(asked)
    with pytest.raises(ValueError):
        resolve("meta")


def _entry_point_calls():
    pos, faces = torchdraco.make_mesh_batch(2, 5, seed=11)
    meshes = torchdraco.build_meshes(pos, faces)
    topo = tbatch.PreparedTopology(meshes[0])
    att = meshes[0].position_attribute()
    g_np = tbatch.topology_gathers_np(topo, att)
    blobs = [encode(m) for m in meshes]
    meshes3 = _grid_meshes3(5, 2, 11)
    blobs3 = [encode(m) for m in meshes3]
    streams = [np.arange(20) % 5, np.arange(9) % 3]
    return {
        "entry": lambda **kw: torchdraco.entry(**kw),
        "encode_meshes_device": lambda **kw: tbatch.BatchEncoder()
        .encode_meshes_device(meshes, **kw),
        "device_encode_group": lambda **kw: tbatch.device_encode_group(
            pos, topo, att, **kw),
        "gathers_to_torch": lambda **kw: tbatch.gathers_to_torch(
            g_np, kw.get("device")),
        "decode_blobs_shared_topology": lambda **kw: BatchDecoder()
        .decode_blobs_shared_topology(blobs, entropy="device", **kw),
        "encode_streams_device": lambda **kw: trl.encode_streams_device(
            streams, np.bincount(np.concatenate(streams)), **kw),
        "encode_direct_coded_streams_device": lambda **kw:
        trl.encode_direct_coded_streams_device(streams, **kw),
        "encode_meshes_device_normals_uvs": lambda **kw:
        tbatch.BatchEncoder().encode_meshes_device(meshes3, **kw),
        "decode_blobs_phased": lambda **kw: BatchDecoder()
        .decode_blobs_shared_topology(blobs3, normals="device", **kw),
        "rings_to_torch": lambda **kw: tnormals.rings_to_torch(
            tbatch.PreparedTopology(meshes3[0]).rings_for(1),
            kw.get("device")),
    }


@pytest.mark.parametrize("name", (
    "entry", "encode_meshes_device", "device_encode_group",
    "gathers_to_torch", "decode_blobs_shared_topology",
    "encode_streams_device", "encode_direct_coded_streams_device",
    "encode_meshes_device_normals_uvs", "decode_blobs_phased",
    "rings_to_torch"))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Without ``device`` an entry point asks for the card and, where there
    is none, raises the error that names CUDA; ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_point_calls()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert call(device="cpu") is not None

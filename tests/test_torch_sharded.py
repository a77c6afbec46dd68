"""torchdraco's several-device plane on the CPU: every sharded function on
an axis of n CPU shards (``["cpu"] * n``) against its unsharded port
counterpart, against tpudraco's sharded function on a 1-D mesh of the
virtual CPU devices that tests/conftest.py provides (``("data",)`` or
``("stream",)``), and against ``encode()``. The axis lengths include ones
that divide neither the batch nor the traversal; every comparison is
equality."""

import ast
import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.device import (  # noqa: E402
    axis_for, resolve_axis, shard_bounds,
)
from torchdraco.entropy.rans import normalize_freq_counts  # noqa: E402
from torchdraco.ops import device as tdev  # noqa: E402
from torchdraco.ops import normals as tn  # noqa: E402
from torchdraco.ops import rans_lanes as trl  # noqa: E402
from torchdraco.ops import texcoords as tt  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.encode import encode  # noqa: E402
from tpudraco.ops import rans_lanes as jrl  # noqa: E402
from tpudraco.ops import texcoords as jt  # noqa: E402
from tpudraco.parallel import BatchEncoder as JaxBatchEncoder  # noqa: E402
from tpudraco.parallel import batch as jbatch  # noqa: E402

RING_KEYS = ("tip_pt", "next_pt", "prev_pt", "mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axis(n):
    return ["cpu"] * n


def _jmesh(n, name="data"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _textured(batch, n, seed):
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)


# ---------------------------------------------------------------- the axis

def test_shard_bounds_cut_as_tensor_split():
    for n in (0, 1, 5, 12, 13):
        for k in (1, 2, 3, 8):
            sizes = [b - a for a, b in shard_bounds(n, k)]
            assert sizes == [len(p) for p in torch.tensor_split(
                torch.arange(n), k)]


@pytest.mark.parametrize("case", ("empty", "string", "cuda", "mismatch"))
def test_axis_refusals(monkeypatch, case):
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: case == "mismatch")
    if case == "empty":
        with pytest.raises(ValueError, match="at least one device"):
            resolve_axis([])
    elif case == "string":
        with pytest.raises(TypeError):
            resolve_axis("cpu")
    elif case == "cuda":  # resolve's own error, for any entry
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_axis(["cpu", "cuda:0"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbatch.BatchEncoder(mesh_axis=["cuda"]).encode_meshes_device(
                _textured(2, 4, 0))
    else:  # a device beside an axis must be the axis's first
        assert axis_for("cpu:0", ["cpu", "cpu"]) == [torch.device("cpu")] * 2
        with pytest.raises(ValueError, match="not the first device"):
            axis_for("cuda:0", ["cpu"])
        with pytest.raises(ValueError, match="not the first device"):
            tbatch.BatchEncoder(device="cuda:0", mesh_axis=_axis(2))._dev(
                None)
        enc = tbatch.BatchEncoder(device="cpu", mesh_axis=_axis(2))
        assert enc._dev(None) == torch.device("cpu")


def test_launch_on_makes_the_tensor_card_current(monkeypatch):
    """``_launch_on`` holds the tensor's card as the current device for
    the launch and yields that card's current stream."""
    events = []

    class Guard:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            events.append(("enter", self.dev))

        def __exit__(self, *exc):
            events.append(("exit", self.dev))

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: (
        events.append(("stream", dev)) or SimpleNamespace(cuda_stream=7)))
    card1 = torch.device("cuda", 1)
    with tdev._launch_on(SimpleNamespace(device=card1)) as stream:
        assert stream == 7
        assert events == [("enter", card1), ("stream", card1)]
    assert events[-1] == ("exit", card1)


def test_every_kernel_launch_is_guarded():
    """Each call of a C entry point (``rc = ...`` beside ``_build.load()``)
    lies inside ``with _launch_on(t) as stream`` and passes that stream
    last, and the launch check runs inside it: a tensor on a card other
    than the current one launches on its own card."""
    ops = os.path.dirname(tdev.__file__)
    guarded = []
    for name in ("device.py", "rans_lanes.py", "normals.py",
                 "texcoords.py"):
        tree = ast.parse(open(os.path.join(ops, name)).read())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef) or "_build.load()" not in \
                    ast.unparse(fn):
                continue
            withs = [w for w in ast.walk(fn) if isinstance(w, ast.With)
                     and ast.unparse(w.items[0].context_expr)
                     .startswith("_launch_on(")]
            assert len(withs) == 1, fn.name
            stream = withs[0].items[0].optional_vars.id
            inside = [n for n in ast.walk(withs[0])]
            rcs = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                   and ast.unparse(n.targets[0]) == "rc"]
            assert rcs and all(n in inside for n in rcs), fn.name
            assert all(ast.unparse(n.value.args[-1]) == stream
                       for n in rcs), fn.name
            assert any(isinstance(n, ast.Call)
                       and ast.unparse(n.func) == "_build.check"
                       for n in inside), fn.name
            guarded.append(fn.name)
    assert sorted(guarded) == ["histogram", "normal_decode_cuda",
                               "normal_encode_cuda", "predict_residual",
                               "rans_decode_lanes", "rans_scan_dense",
                               "rans_words_scan", "uv_encode_cuda"]


# ------------------------------------------------- the data-parallel step

@pytest.mark.parametrize("n", (1, 2, 3, 8))
def test_device_encode_group_shards_the_batch(n):
    """Five meshes over n shards (uneven, and empty shards at n = 8):
    the joined shards equal the unsharded step and tpudraco's
    _jit_step_sharded_q, which needs the batch padded to a multiple of
    n."""
    pos, faces = torchdraco.make_mesh_batch(5, 8, seed=3)
    m0 = torchdraco.build_meshes(pos[:1], faces)[0]
    topo = tbatch.PreparedTopology(m0)
    att = m0.position_attribute()
    whole = tbatch.device_encode_group(pos, topo, att, device="cpu")
    got = tbatch.device_encode_group(pos, topo, att, mesh_axis=_axis(n))
    assert [len(s) for s in got["symbols"]] == [
        b - a for a, b in shard_bounds(5, n)]
    for k in ("symbols", "counts", "q_dev"):
        assert len(got[k]) == n and len(whole[k]) == 1
        if k == "q_dev":  # the 12-bit pack at -qp 11, cut on its rows
            assert tdev.upload_layout_of(whole[k][0]) == "pack12"
            assert torch.equal(torch.cat([tdev.widen(q) for q in got[k]]),
                               tdev.widen(whole[k][0]))
            continue
        assert torch.equal(torch.cat(got[k]), whole[k][0])
    for k in ("vmin", "vmax", "mins", "delta_max", "q"):
        assert np.array_equal(got[k], whole[k])
    pad = -(-5 // n) * n
    jpos = np.concatenate([pos, np.repeat(pos[:1], pad - 5, axis=0)])
    want = jbatch.device_encode_group(
        jpos, jbatch.PreparedTopology(m0), att, bits=11,
        mesh_axis=_jmesh(n), return_device=True)
    assert np.array_equal(torch.cat(got["symbols"]).numpy(),
                          np.asarray(want["symbols"])[:5].astype(np.int64))
    assert np.array_equal(torch.cat(got["counts"]).numpy(),
                          np.asarray(want["counts"])[:5])


@pytest.fixture(scope="module")
def textured24():
    """24 meshes of 16 x 16 with normals and UVs, their encode() bytes,
    and tpudraco's sharded batch encoder's over a 4-device data mesh with
    either coder."""
    meshes = _textured(24, 16, 7)
    want = [encode(m) for m in meshes]
    jax_blobs = {e: JaxBatchEncoder(strict_device=True,
                                    mesh_axis=_jmesh(4)).encode_meshes_device(
        meshes, entropy=e) for e in ("device", "host")}
    return meshes, want, jax_blobs


@pytest.mark.parametrize("n", (3, 8))
@pytest.mark.parametrize("entropy", ("device", "host"))
def test_encode_meshes_device_over_an_axis(monkeypatch, textured24, n,
                                           entropy):
    """Chunks of 10 meshes (10, 10, 4) over 3 or 8 shards: the fused step,
    the coder and both chains per shard give encode()'s bytes and those of
    tpudraco's sharded encoder; K1 and K2 run once a non-empty shard."""
    meshes, want, jax_blobs = textured24
    monkeypatch.setattr(tbatch.BatchEncoder, "DEVICE_CHUNK", 10)
    enc = tbatch.BatchEncoder(mesh_axis=_axis(n))
    got = enc.encode_meshes_device(meshes, entropy=entropy)
    assert enc.n_host_attributes == 0
    assert got == want
    assert got == jax_blobs[entropy]
    # the shard axis carries through the corpus planes' entry point
    assert enc._device_plane(meshes[:5]) == want[:5]


# ------------------------------------------------------- the rANS coders

def _lanes(tables, seed=11):
    """L = 8 ragged lanes of up to 60 symbols (one empty, one full), on a
    shared table or per-lane tables, at precision 12."""
    rng = np.random.RandomState(seed)
    L, T = 8, 60
    syms = rng.randint(0, 23, (L, T)).astype(np.int32)
    lengths = rng.randint(1, T + 1, L).astype(np.int32)
    lengths[0], lengths[1] = 0, T
    if tables == "shared":
        dist = normalize_freq_counts(np.bincount(syms.ravel()), 12)
        cums = np.concatenate([[0], np.cumsum(dist)[:-1]])
        return syms, dist.astype(np.uint32), cums.astype(np.uint32), lengths
    freqs = np.zeros((L, 32), np.uint32)
    cums = np.zeros((L, 32), np.uint32)
    for i in range(L):
        d = normalize_freq_counts(np.bincount(syms[i], minlength=2), 12)
        freqs[i, :len(d)] = d
        cums[i, 1:len(d)] = np.cumsum(d)[:-1]
    return syms, freqs, cums, lengths


@pytest.mark.parametrize("dense", (False, True))
@pytest.mark.parametrize("tables", ("shared", "per_lane"))
def test_rans_encode_lanes_shards_the_lanes(tables, dense):
    syms, freqs, cums, lengths = _lanes(tables)
    whole = trl.rans_encode_lanes(torch.from_numpy(syms), freqs, cums,
                                  lengths, dense=dense)
    want = jrl.rans_encode_lanes(syms, freqs, cums, lengths,
                                 mesh_axis=_jmesh(4))
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(whole, want))
    for n in (2, 3, 8):
        got = trl.rans_encode_lanes(syms, freqs, cums, lengths, dense=dense,
                                    mesh_axis=_axis(n))
        assert all(np.array_equal(a, b) for a, b in zip(got, whole))
    bad = freqs.copy()
    bad[..., syms[1, 0]] = 0  # a coded symbol of frequency 0, one shard
    with pytest.raises(ValueError, match="frequency 0"):
        trl.rans_encode_lanes(syms, bad, cums, lengths, dense=dense,
                              mesh_axis=_axis(3))


@pytest.mark.parametrize("n", (2, 3))
def test_group_entropy_shards_the_lanes(monkeypatch, n):
    """The group coder over an axis: the same payloads, a histogram
    deficit in one shard still raises, and pathological lanes take the
    host's tables in every shard and are counted over the shards."""
    pos, faces = torchdraco.make_mesh_batch(5, 8, seed=4)
    m0 = torchdraco.build_meshes(pos[:1], faces)[0]
    topo = tbatch.PreparedTopology(m0)
    dev_c = tbatch.device_encode_group(pos, topo, m0.position_attribute(),
                                       mesh_axis=_axis(n))
    whole = tbatch.device_encode_group(pos, topo, m0.position_attribute(),
                                       device="cpu")
    want = trl.encode_group_entropy_device(whole["symbols"][0],
                                           whole["counts"][0])
    assert trl.encode_group_entropy_device(
        dev_c["symbols"], dev_c["counts"], mesh_axis=_axis(n)) == want
    # whole tensors are cut over the axis the same way
    assert trl.encode_group_entropy_device(
        whole["symbols"][0], whole["counts"][0], mesh_axis=_axis(n)) == want
    short = [c.clone() for c in dev_c["counts"]]
    short[-1][-1, 0] -= 1
    with pytest.raises(ValueError, match="dropped symbols"):
        trl.encode_group_entropy_device(dev_c["symbols"], short,
                                        mesh_axis=_axis(n))
    real = trl.normalize_tables

    def flag_first(c, n_sym):
        dist, cums, prec, tiny = real(c, n_sym)
        tiny[0, 3] = 1
        dist[0] = 0  # the host tables must replace these
        cums[0] = 0
        return dist, cums, prec, tiny
    monkeypatch.setattr(trl, "normalize_tables", flag_first)
    before = trl.encode_group_entropy_device.n_patho_lanes
    assert trl.encode_group_entropy_device(
        dev_c["symbols"], dev_c["counts"], mesh_axis=_axis(n)) == want
    assert trl.encode_group_entropy_device.n_patho_lanes == before + n


# ------------------------------------------------------------- the chains

def _group(batch, n, seed, qp=11):
    meshes = _textured(batch, n, seed)
    m0 = meshes[0]
    topo = tbatch.PreparedTopology(m0)
    stack = [np.stack([m.attributes[i].values for m in meshes])
             for i in range(3)]
    q_pos = tbatch.quantize_positions_host(stack[0], qp)[0]
    return m0, topo, q_pos, stack


@pytest.mark.parametrize("n", (2, 3))
def test_normal_chain_sharded(n):
    m0, topo, q_pos, stack = _group(5, 9, 21)
    rings = tn.rings_to_torch(topo.rings_for(1), "cpu")
    uo = [torch.from_numpy(a.astype(np.int64)) for a in (
        m0.position_attribute().unique_indices(),
        m0.attributes[1].unique_indices())]
    args = (torch.from_numpy(q_pos), torch.from_numpy(stack[1]),
            *(rings[k] for k in RING_KEYS), *uo)
    whole = tn.normal_encode_chain(*args, bits=8)
    got = tn.normal_encode_chain_sharded(*args, bits=8, mesh_axis=_axis(n))
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    r = topo.rings_for(1)
    with jax.enable_x64(True):
        js, jf = jbatch._jit_normal_chain_sharded(
            jnp.asarray(q_pos), jnp.asarray(stack[1]),
            *(jnp.asarray(np.asarray(r[k])) for k in RING_KEYS),
            *(jnp.asarray(u.numpy().astype(np.int32)) for u in uo),
            bits=8, mesh_axis=_jmesh(5))
        js, jf = np.asarray(js), np.asarray(jf)
    assert np.array_equal(got[0].numpy(), js)
    assert np.array_equal(got[1].numpy(), jf)


@pytest.mark.parametrize("n", (2, 3))
def test_uv_chain_sharded(n):
    m0, topo, q_pos, stack = _group(5, 9, 31)
    q_uv = tbatch.quantize_positions_host(stack[2], 10)[0]
    g = topo.uv_gathers_for(2, m0.position_attribute().num_points)
    args = (q_pos, q_uv, g, m0.position_attribute().unique_indices(),
            m0.attributes[2].unique_indices())
    whole = tt.uv_encode_chain(*args, device="cpu")
    got = tt.uv_encode_chain_sharded(*args, mesh_axis=_axis(n))
    want = jt.uv_encode_chain_sharded(*args, _jmesh(5))
    for a, b, c in zip(got, whole, want):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert got[4].any()  # the geometric predictor really ran


# ------------------------------------------------ the stream-sharded mesh

@pytest.mark.parametrize("sp", (1, 2, 3, 8))
def test_stream_sharded_mesh(sp):
    """An 11 x 11 grid (T = 121, which 2, 3 and 8 do not divide): the
    segments' symbols and summed histograms equal the unsharded step, and
    the blob equals encode() and tpudraco's route on a ("stream",)
    mesh."""
    pos, faces = torchdraco.make_mesh_batch(1, 11, seed=sp)
    mesh = torchdraco.build_meshes(pos, faces)[0]
    enc = tbatch.BatchEncoder()
    blob = enc.encode_mesh_device_stream_sharded(mesh, _axis(sp))
    assert blob == encode(mesh)
    assert blob == JaxBatchEncoder().encode_mesh_device_stream_sharded(
        mesh, _jmesh(sp, "stream"))
    assert set(enc.timings) == {"topology_s", "position_s", "assembly_s"}
    _, topo = enc._topo_for(mesh)
    dev_c = tbatch.device_encode_group(pos, topo, mesh.position_attribute(),
                                       device="cpu")
    gathers = topo.dev_gathers["cpu"]
    parts, counts = tdev.encode_step_stream_sharded(
        dev_c["q"], gathers, dev_c["vmin"], dev_c["vmax"], bits=11,
        mesh_axis=_axis(sp))
    assert [p.shape[1] for p in parts] == [
        b - a for a, b in shard_bounds(121, sp)]
    assert torch.equal(torch.cat(parts, dim=1), dev_c["symbols"][0])
    assert torch.equal(counts, dev_c["counts"][0])
    assert int(counts.sum()) == 121 * 3


def test_dryrun_multichip_on_the_cpu(capsys):
    torchdraco.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK: 4 shards" in capsys.readouterr().out

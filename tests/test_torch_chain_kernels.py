"""The NORMAL and TEX_COORD chain kernels' wrappers (C1 ``normal_encode_cuda``,
C2 ``normal_decode_cuda``, C3 ``uv_encode_cuda``) and the chains around
them.

On the CPU: each public chain runs its plain version, which equals
tpudraco's jitted chain (tolerance 0) with zero normals, on a mesh whose
UVs are risky and over uneven shard axes (the fan rings, -qn 15-16 and
C3's square root loops are in ``tests/test_torch_normals.py`` and
``tests/test_torch_texcoords.py``); each wrapper refuses a CPU tensor and
wrong types and shapes; the resident route's memory estimate covers what
the wrappers allocate. On the card (marker ``cuda``, skipped without
one): each kernel equals its plain version run there, on every output.
The JAX side is imported where it is used: the machine with the card has
no JAX."""

import inspect

import numpy as np
import pytest
import torch

import torchdraco
from torchdraco.ops import normals as tn
from torchdraco.ops import texcoords as tt
from torchdraco.parallel import batch as tbatch

RING_KEYS = ("tip_pt", "next_pt", "prev_pt", "mask")
UV_OUTPUTS = ("symbols", "vmin", "vmax", "orient_vals", "orient_flags",
              "risky")
FAN = 44


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_chains():
    """tpudraco's chain modules, with jax (skips where JAX is missing)."""
    jax = pytest.importorskip("jax")
    from tpudraco.ops import normals as jn
    from tpudraco.ops import texcoords as jt
    return jax, jn, jt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _group(n, batch, seed, qp, qt=10, spread=1.0, fan=0):
    """``batch`` grids of n x n with normals and UVs sharing a topology
    (one vertex of valence ``fan``, the widest ring), the first mesh's
    third normal zero: quantized positions and UVs, the normals, the
    rings, the UV gathers and the point -> unique-value maps, numpy."""
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed, fan=fan)
    pos = (pos * np.float32(spread)).astype(np.float32)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    nrm[0, 2] = 0.0
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    topo = tbatch.PreparedTopology(meshes[0])
    m0 = meshes[0]
    stack = np.stack
    return {
        "q": tbatch.quantize_positions_host(
            stack([m.attributes[0].values for m in meshes]), qp)[0],
        "q_uv": tbatch.quantize_positions_host(
            stack([m.attributes[2].values for m in meshes]), qt)[0],
        "normals": stack([m.attributes[1].values for m in meshes]),
        "rings": topo.rings_for(1),
        "uvg": topo.uv_gathers_for(2, m0.position_attribute().num_points),
        "uo_pos": m0.position_attribute().unique_indices().astype(np.int64),
        "uo_nrm": m0.attributes[1].unique_indices().astype(np.int64),
        "uo_uv": m0.attributes[2].unique_indices().astype(np.int64),
        "mesh": m0}


def _encode_args(g, where="cpu"):
    tr = tn.rings_to_torch(g["rings"], where)
    return (_t(g["q"]).to(where), _t(g["normals"]).to(where),
            *(tr[k] for k in RING_KEYS), _t(g["uo_pos"]).to(where),
            _t(g["uo_nrm"]).to(where))


def _decode_rings(g, where="cpu"):
    tr = tn.rings_to_torch(g["rings"], where, rows=g["uo_pos"])
    return [tr[k] for k in RING_KEYS]


def _uv_args(g):
    return (g["q"], g["q_uv"], g["uvg"], g["uo_pos"], g["uo_uv"])


def _jax_rings(jnp, rings, rows=None):
    out = [jnp.asarray(np.asarray(rings[k]) if rows is None
                       else np.asarray(rows, np.int32)[rings[k]])
           for k in RING_KEYS[:3]]
    return out + [jnp.asarray(rings["mask"])]


def _same_uv(got, want):
    for name, a, b in zip(UV_OUTPUTS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def _no_kernel(monkeypatch):
    """Make every kernel wrapper fail the test if it is called."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper ran on the CPU")
    for mod, name in ((tn, "normal_encode_cuda"), (tn, "normal_decode_cuda"),
                      (tt, "uv_encode_cuda")):
        monkeypatch.setattr(mod, name, refuse)


# ------------------------------------------- the plain versions, against JAX

def test_risky_uv_mesh_matches_jax(jax_chains, monkeypatch):
    """Positions and UVs that leave the int64 headroom in one mesh (the
    wide guard) and past 2^62 products in another: the plain version on
    the CPU equals tpudraco's chain, risky flags included."""
    _, _, jt = jax_chains
    g = _group(10, 4, 3, 11)
    rng = np.random.default_rng(9)
    g["q"] = g["q"].astype(np.int64)
    g["q"][1] = rng.integers(0, (1 << 31) - 1, size=g["q"][1].shape)
    g["q"][2] = rng.integers(0, 1 << 19, size=g["q"][2].shape)
    g["q_uv"] = g["q_uv"].astype(np.int64)
    g["q_uv"][2] = rng.integers(0, 1 << 30, size=g["q_uv"][2].shape)
    _no_kernel(monkeypatch)
    got = tt.uv_encode_chain(*_uv_args(g), device="cpu")
    _same_uv(got, jt.uv_encode_chain(*_uv_args(g)))
    assert got[5][1] and not got[5][0]


@pytest.mark.parametrize("n", (3, 4))
def test_sharded_chains_over_uneven_axes_match_jax(jax_chains, monkeypatch,
                                                    n):
    """Five meshes over 3 or 4 CPU shards (uneven pieces) equal tpudraco's
    unsharded chains."""
    _, jn, jt = jax_chains
    import jax.numpy as jnp
    g = _group(9, 5, 11, 11)
    _no_kernel(monkeypatch)
    sym, flips = tn.normal_encode_chain_sharded(
        *_encode_args(g), bits=8, mesh_axis=["cpu"] * n)
    jsym, jflips = jn.normal_encode_chain(
        jnp.asarray(g["q"]), jnp.asarray(g["normals"]),
        *_jax_rings(jnp, g["rings"]), jnp.asarray(g["uo_pos"], np.int32),
        jnp.asarray(g["uo_nrm"], np.int32), bits=8)
    assert np.array_equal(sym.numpy(), np.asarray(jsym))
    assert np.array_equal(flips.numpy(), np.asarray(jflips))
    _same_uv(tt.uv_encode_chain_sharded(*_uv_args(g), mesh_axis=["cpu"] * n),
             jt.uv_encode_chain(*_uv_args(g)))


def test_public_chains_run_their_plain_versions_on_the_cpu(monkeypatch):
    g = _group(8, 3, 5, 11)
    _no_kernel(monkeypatch)
    args = _encode_args(g)
    sym, flips = tn.normal_encode_chain(*args, bits=8)
    want = tn.normal_encode_chain_ref(*args, bits=8)
    assert torch.equal(sym, want[0]) and torch.equal(flips, want[1])
    dec = (_t(g["q"]), sym, flips, *_decode_rings(g))
    assert torch.equal(tn.normal_decode_chain(*dec, bits=8),
                       tn.normal_decode_chain_ref(*dec, bits=8))
    _same_uv(tt.uv_encode_chain(*_uv_args(g), device="cpu"),
             tt.uv_encode_chain_ref(*_uv_args(g), device="cpu"))


# ------------------------------------------------------ the wrappers' checks

def _wrapper_calls(g, **over):
    """(name, call) of each wrapper on CPU tensors, any argument replaced
    by ``over``."""
    args = dict(zip(("q", "normals", "tip", "nxt", "prv", "mask", "uo_pos",
                     "uo_nrm"), _encode_args(g)))
    args["q"] = args["q"].to(torch.int32)
    drings = _decode_rings(g)
    B, T = args["q"].shape[0], args["tip"].numel()
    args.update(sym=torch.zeros((B, T, 2), dtype=torch.int32),
                flips=torch.zeros((B, T), dtype=torch.bool),
                q_uv=_t(g["q_uv"].astype(np.int32)),
                uvg=tt.uv_gathers_to_torch(g["uvg"], "cpu"),
                uo_uv=_t(g["uo_uv"]), bits=8)
    args.update(over)
    a = args
    return {
        "normal_encode_cuda": lambda: tn.normal_encode_cuda(
            a["q"], a["normals"], a["tip"], a["nxt"], a["prv"], a["mask"],
            a["uo_pos"], a["uo_nrm"], bits=a["bits"]),
        "normal_decode_cuda": lambda: tn.normal_decode_cuda(
            a["q"], a["sym"], a["flips"], *drings, bits=a["bits"]),
        "uv_encode_cuda": lambda: tt.uv_encode_cuda(
            a["q"], a["q_uv"], a["uvg"], a["uo_pos"], a["uo_uv"])}


@pytest.mark.parametrize("name", ("normal_encode_cuda", "normal_decode_cuda",
                                  "uv_encode_cuda"))
def test_wrappers_refuse_cpu_tensors(name):
    g = _group(6, 2, 1, 11)
    before = getattr(tn if "normal" in name else tt, name).n_launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        _wrapper_calls(g)[name]()
    assert getattr(tn if "normal" in name else tt, name).n_launches == before


@pytest.mark.parametrize("name,over,match", (
    ("normal_encode_cuda", {"q": "int64"}, "q_pos"),
    ("normal_encode_cuda", {"normals": "float64"}, "normals"),
    ("normal_encode_cuda", {"nxt": "int32"}, "next"),
    ("normal_encode_cuda", {"mask": "uint8"}, "mask"),
    ("normal_encode_cuda", {"uo_nrm": "int32"}, "uo_point_nrm"),
    ("normal_encode_cuda", {"bits": 17}, "bits"),
    ("normal_encode_cuda", {"q": "drop_axis"}, "q_pos"),
    ("normal_encode_cuda", {"normals": "one_mesh"}, "normals"),
    ("normal_encode_cuda", {"tip": "short"}, "tip"),
    ("normal_decode_cuda", {"sym": "int64"}, "symbols"),
    ("normal_decode_cuda", {"flips": "uint8"}, "flips"),
    ("normal_decode_cuda", {"sym": "one_mesh"}, "symbols"),
    ("normal_decode_cuda", {"q": "int64"}, "q_pos"),
    ("uv_encode_cuda", {"q_uv": "int64"}, "q_uv"),
    ("uv_encode_cuda", {"q_uv": "one_mesh"}, "q_uv"),
    ("uv_encode_cuda", {"q": "uint16"}, "q_pos"),
    ("uv_encode_cuda", {"uo_uv": "int32"}, "uo_uv"),
    ("uv_encode_cuda", {"uvg": "cpt_int32"}, "cpt"),
    ("uv_encode_cuda", {"uvg": "vis_n_short"}, "vis_n"),
))
def test_wrappers_refuse_wrong_types_and_shapes(name, over, match):
    g = _group(6, 2, 1, 11)
    args = dict(zip(("q", "normals", "tip", "nxt", "prv", "mask", "uo_pos",
                     "uo_nrm"), _encode_args(g)))
    key, how = next(iter(over.items()))
    if key == "bits":
        bad = how
    elif key == "uvg":
        uvg = tt.uv_gathers_to_torch(g["uvg"], "cpu")
        if how == "cpt_int32":
            uvg["cpt"] = uvg["cpt"].to(torch.int32)
        else:
            uvg["vis_n"] = uvg["vis_n"][:-1].contiguous()
        bad = uvg
    else:
        ref = {"sym": torch.zeros((2, len(g["rings"]["tip_pt"]), 2),
                                  dtype=torch.int32),
               "flips": torch.zeros((2, len(g["rings"]["tip_pt"])),
                                    dtype=torch.bool),
               "q_uv": _t(g["q_uv"].astype(np.int32)),
               "uo_uv": _t(g["uo_uv"])}.get(key)
        t = ref if ref is not None else args[key]
        if key == "q" and how != "drop_axis":
            t = t.to(torch.int32)
        if how in ("int64", "int32", "float64", "uint8", "uint16"):
            bad = t.to(getattr(torch, how))
        elif how == "drop_axis":
            bad = t[..., :2].to(torch.int32).contiguous()
        elif how == "one_mesh":
            bad = t[:1].contiguous()
        else:  # short
            bad = t[:-1].contiguous()
    with pytest.raises(ValueError, match=match):
        _wrapper_calls(g, **{key: bad})[name]()


# ------------------------------------------- the resident route's estimate

def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def test_kernel_path_estimate_covers_the_wrappers_allocations():
    """``_resident_peak_bytes`` charges each NORMAL attribute and each
    TEX_COORD attribute at least what the kernel path holds for it at B =
    1: the tables as ``rings_to_torch`` / ``uv_gathers_to_torch`` make
    them, the wrapper's outputs (as it allocates them: ``encode_outputs``,
    ``uv_outputs``, and nothing else), their copy by the shard join, the
    int32 inputs and the int64 maps."""
    for fn, alloc in ((tn.normal_encode_cuda, "encode_outputs("),
                      (tn.normal_decode_cuda, "decode_outputs("),
                      (tt.uv_encode_cuda, "uv_outputs(")):
        src = inspect.getsource(fn)
        assert alloc in src, fn.__name__
        assert not any(f"torch.{k}" in src for k in (
            "empty", "zeros", "ones", "full", "cat", "stack")), fn.__name__
    for fan in (0, FAN):
        g = _group(FAN + 1, 1, 2, 11, fan=fan)
        mesh = g["mesh"]
        T, R = g["rings"]["next_pt"].shape
        V = mesh.position_attribute().num_points
        tr = tn.rings_to_torch(g["rings"], "cpu")
        assert _nbytes(tr["next_pt"], tr["prev_pt"], tr["mask"]) \
            == T * R * tn.RING_TABLE_BYTES_PER_SLOT
        outs = tn.encode_outputs(1, T, "meta")
        held = (_nbytes(tr["tip_pt"]) + 2 * _nbytes(*outs)  # and the join
                + V * 3 * 4 + _nbytes(_t(g["normals"]))
                + _nbytes(_t(g["uo_pos"]), _t(g["uo_nrm"])))
        assert held <= T * tbatch.BatchEncoder.RESIDENT_NORMAL_BYTES_PER_STEP
        tg = tt.uv_gathers_to_torch(g["uvg"], "cpu")
        assert _nbytes(*tg.values()) == T * tt.UV_TABLE_BYTES_PER_STEP
        uv_held = (_nbytes(*tg.values(), *tt.uv_outputs(1, T, "meta"))
                   + V * 2 * 2 + V * 2 * 4 + V * 3 * 4
                   + _nbytes(_t(g["uo_uv"]), _t(g["uo_pos"])))
        assert uv_held <= V * tbatch.BatchEncoder.RESIDENT_UV_BYTES_PER_VERTEX
        be = tbatch.BatchEncoder()
        _, topo = be._topo_for(mesh)
        assert be._resident_peak_bytes(mesh) == V * (
            be.RESIDENT_BYTES_PER_VERTEX + be.RESIDENT_UV_BYTES_PER_VERTEX) \
            + len(topo.sequences[1]) * (
                R * tn.RING_TABLE_BYTES_PER_SLOT
                + be.RESIDENT_NORMAL_BYTES_PER_STEP)


# ---------------------------------------------------------------- the card

def _counted(fn, call):
    n0 = fn.n_launches
    out = call()
    torch.cuda.synchronize()
    assert fn.n_launches == n0 + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("qp,qn,spread,fan", ((11, 8, 1.0, 0),
                                               (11, 16, 1.0, FAN),
                                               (18, 16, 1e4, 0),
                                               (18, 15, 1e4, 9)))
def test_normal_kernels_equal_their_plain_versions(cuda, qp, qn, spread,
                                                   fan):
    g = _group(max(24, fan + 1), 8, qn, qp, spread=spread, fan=fan)
    args = _encode_args(g, cuda)
    got = _counted(tn.normal_encode_cuda,
                   lambda: tn.normal_encode_chain(*args, bits=qn))
    want = tn.normal_encode_chain_ref(*args, bits=qn)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))
    rng = np.random.default_rng(qn)
    B, T = want[1].shape
    for sym, flips in ((want[0], want[1]),
                       (_t(rng.integers(0, (1 << qn) - 1, (B, T, 2)).astype(
                           np.int32)).to(cuda),
                        _t(rng.random((B, T)) < 0.5).to(cuda))):
        dec = (args[0], sym, flips, *_decode_rings(g, cuda))
        got = _counted(tn.normal_decode_cuda,
                       lambda: tn.normal_decode_chain(*dec, bits=qn))
        assert torch.equal(got, tn.normal_decode_chain_ref(*dec, bits=qn))


@pytest.mark.cuda
@pytest.mark.parametrize("qp,qt,spread,risky", ((11, 10, 1.0, False),
                                                (18, 16, 1e4, False),
                                                (11, 10, 1.0, True)))
def test_uv_kernel_equals_its_plain_version(cuda, qp, qt, spread, risky):
    g = _group(24, 8, qt, qp, qt=qt, spread=spread)
    if risky:
        rng = np.random.default_rng(2)
        g["q"] = g["q"].astype(np.int32)
        g["q"][1] = rng.integers(0, (1 << 31) - 1, size=g["q"][1].shape)
        g["q"][3] = rng.integers(0, 1 << 19, size=g["q"][3].shape)
        g["q_uv"] = g["q_uv"].astype(np.int32)
        g["q_uv"][3] = rng.integers(0, 1 << 30, size=g["q_uv"][3].shape)
    got = _counted(tt.uv_encode_cuda, lambda: tt.uv_encode_chain(
        *_uv_args(g), device=cuda))
    _same_uv(got, tt.uv_encode_chain_ref(*_uv_args(g), device=cuda))
    if risky:
        assert got[5][1] and got[5][3] and not got[5][0]

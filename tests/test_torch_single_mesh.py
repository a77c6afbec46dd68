"""torchdraco's single-mesh routes on the CPU: the float side of
ops/device.py against tpudraco's JAX functions (integers equal, floats bit
for bit), ``encode_mesh_device``, ``encode_mesh_device_chunked`` and
``_encode_huge`` against ``tpudraco.encode.encode`` and tpudraco's own
routes, the host plane ``encode_mesh`` under connectivity configs, the
device-table LRU, two decode repairs, and the slice in a process that
loads nothing of JAX or tpudraco.

The meshes are copies of tests/test_parallel.py's ``_grid_mesh`` and
``_grid_mesh_with_normals`` and tests/test_fuzz.py's ``_random_mesh``,
built with the port's MeshBuilder."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco import native  # noqa: E402
from torchdraco.encode import Config as PortConfig  # noqa: E402
from torchdraco.models import AttributeDomain, MeshBuilder  # noqa: E402
from torchdraco.models import AttributeType as PortAttributeType  # noqa: E402
from torchdraco.ops import device as tdev  # noqa: E402
from torchdraco.parallel import BatchDecoder  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.decode import decode  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.models import AttributeType  # noqa: E402
from tpudraco.ops import device as jdev  # noqa: E402
from tpudraco.parallel import BatchEncoder as JaxBatchEncoder  # noqa: E402
from tpudraco.parallel import batch as jbatch  # noqa: E402
from tpudraco.shared.clers import EB_PREDICTIVE, EB_VALENCE  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread, so that a run of
    the whole suite in several worker processes is not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid_faces(n):
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    return np.asarray(faces, dtype=np.int64)


def _grid_mesh(n, seed):
    """tests/test_parallel.py:21."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32)], axis=1)
    b = MeshBuilder()
    b.set_connectivity_attribute(_grid_faces(n))
    b.add_attribute(pos, PortAttributeType.POSITION, AttributeDomain.POSITION)
    return b.build()


def _grid_mesh_with_normals(n, seed):
    """tests/test_parallel.py:697: positions, unit normals and UVs."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32)], axis=1)
    nrm = rng.randn(n * n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = (pos[:, :2] / n).astype(np.float32)
    b = MeshBuilder()
    b.set_connectivity_attribute(_grid_faces(n))
    pid = b.add_attribute(pos, PortAttributeType.POSITION,
                          AttributeDomain.POSITION)
    b.add_attribute(nrm, PortAttributeType.NORMAL, AttributeDomain.CORNER,
                    parents=[pid])
    b.add_attribute(uv, PortAttributeType.TEX_COORD, AttributeDomain.CORNER,
                    parents=[pid])
    return b.build()


def _random_mesh(seed, n=7):
    """tests/test_fuzz.py:15: a grid with random holes (orphaned vertices
    that MeshBuilder removes)."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.random(n * n).astype(np.float32) * 3], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = (i * n + j, i * n + j + 1,
                          (i + 1) * n + j, (i + 1) * n + j + 1)
            if rng.random() < 0.9:
                faces += [[a, b, c]]
            if rng.random() < 0.9:
                faces += [[b, d, c]]
    mb = MeshBuilder()
    mb.set_connectivity_attribute(np.asarray(faces, dtype=np.int64))
    mb.add_attribute(pos, PortAttributeType.POSITION,
                     AttributeDomain.POSITION)
    return mb.build()


def _cfgs(bits):
    """(tpudraco Config, port Config) at position depth ``bits``."""
    if bits == 11:
        return None, None
    return (Config(quant_bits={AttributeType.POSITION: bits}),
            PortConfig(quant_bits={PortAttributeType.POSITION: bits}))


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want, dtype=np.float32)
    got = got.numpy()
    return got.dtype == np.float32 and got.shape == want.shape and \
        np.array_equal(got.view(np.int32), want.view(np.int32))


def _half_boundaries(bits, rng, n=4000):
    """(n + 1, 3) values on .5 boundaries of a ``bits`` quantize: the
    range is 0 .. 2^bits - 1, so value k + .5 lands on k + .5 but for the
    rounding of the divide and the product."""
    top = (1 << bits) - 1
    k = rng.integers(0, top, size=(n, 3))
    v = (k + 0.5).astype(np.float32)
    return np.concatenate([v, np.full((1, 3), top, np.float32)])


# ---------------------------------------------------------------- float side

@pytest.mark.parametrize("bits", (8, 11, 14, 16, 20))
def test_quantize_kernel_matches_jax_and_host(bits):
    rng = np.random.default_rng(bits)
    spread = (rng.standard_normal((2, 500, 3)) * 40).astype(np.float32)
    halves = _half_boundaries(min(bits, 12), rng, 499)[None]
    zeros = np.zeros((1, 500, 3), np.float32)  # delta_max == 0
    for vals in (spread, halves, zeros):
        q, mins, dm = tdev.quantize_kernel(torch.from_numpy(vals), bits)
        jq, jmins, jdm = jdev.quantize_kernel(jnp.asarray(vals), bits)
        assert q.dtype == torch.int32
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert _same_bits(mins, jmins) and _same_bits(dm, jdm)
        hq, hmins, hdm = tbatch.quantize_positions_host(vals, bits)
        assert np.array_equal(q.numpy(), hq)
        assert _same_bits(mins, hmins) and _same_bits(dm, hdm)
    assert (tdev.quantize_kernel(torch.from_numpy(zeros), bits)[2] == 0).all()


@pytest.mark.parametrize("bits", (11, 13, 16))
def test_chunk_passes_match_jax(bits):
    """Passes 1 and 2 over padded chunks, and the row quantize, equal the
    JAX functions and the resident quantize of the same values."""
    rng = np.random.default_rng(bits + 1)
    pos = np.concatenate([(rng.standard_normal((300, 3)) * 9)
                          .astype(np.float32), _half_boundaries(11, rng, 99)])
    chunk = 128
    mins = np.full(3, np.inf, np.float32)
    maxs = np.full(3, -np.inf, np.float32)
    rows_all = []
    for c0 in range(0, len(pos), chunk):
        rows = pos[c0:c0 + chunk]
        if len(rows) < chunk:
            rows = np.concatenate([rows, np.broadcast_to(
                pos[:1], (chunk - len(rows), 3))])
        rows_all.append(rows)
        mn, mx = tdev.minmax_chunk_kernel(torch.from_numpy(rows))
        jmn, jmx = jdev.minmax_chunk_kernel(jnp.asarray(rows))
        assert _same_bits(mn, jmn) and _same_bits(mx, jmx)
        mins, maxs = np.minimum(mins, mn.numpy()), np.maximum(maxs, mx.numpy())
    mins = np.minimum(mins, np.float32(0)).astype(np.float32)
    maxs = np.maximum(maxs, np.float32(0)).astype(np.float32)
    for dm in (np.float32(np.max(maxs - mins)), np.float32(0)):
        t_args = (torch.from_numpy(mins), torch.tensor(dm), bits)
        j_args = (jnp.asarray(mins), jnp.asarray(dm), bits)
        lo, hi = np.iinfo(np.int32).max, np.iinfo(np.int32).min
        for rows in rows_all:
            q = tdev.quantize_rows_kernel(torch.from_numpy(rows), *t_args)
            assert np.array_equal(q.numpy(), np.asarray(
                jdev.quantize_rows_kernel(jnp.asarray(rows), *j_args)))
            a, b = tdev.quantized_range_chunk_kernel(
                torch.from_numpy(rows), *t_args)
            ja, jb = jdev.quantized_range_chunk_kernel(jnp.asarray(rows),
                                                       *j_args)
            assert (int(a), int(b)) == (int(ja), int(jb))
            lo, hi = min(lo, int(a)), max(hi, int(b))
        if dm:
            q_res = tdev.quantize_kernel(torch.from_numpy(pos), bits)[0]
            assert (lo, hi) == (int(q_res.min()), int(q_res.max()))


def _traversal_rows(mesh, chunk, s0):
    topo = tbatch.PreparedTopology(mesh)
    att = mesh.position_attribute()
    g = tbatch.topology_gathers_np(topo, att)
    pos = np.asarray(att.values, np.float32)
    s1 = min(s0 + chunk, len(g["order"]))
    nv = s1 - s0

    def rows(k):
        r = np.zeros((chunk, 3), np.float32)  # padding rows stay zero
        r[:nv] = pos[g[k][s0:s1]]
        return r

    def mask(k):
        r = np.zeros(chunk, bool)
        r[:nv] = np.asarray(g[k], bool)[s0:s1]
        return r
    active = np.zeros(chunk, bool)
    active[:nv] = True
    return ([rows(k) for k in ("order", "next", "prev", "opp", "fallback")]
            + [mask("can_para"), mask("has_fallback"), active], pos, nv)


@pytest.mark.parametrize("bits", (11, 13, 16))
@pytest.mark.parametrize("s0,chunk", ((0, 64), (320, 100)))
def test_encode_step_chunk_matches_jax(bits, s0, chunk):
    """A traversal segment through the fused chunk step, padded at the
    tail (the second case), equals JAX's: symbols and counts."""
    mesh = _grid_mesh(20, 3)
    args, pos, nv = _traversal_rows(mesh, chunk, s0)
    q, mins, dm = jdev.quantize_kernel(jnp.asarray(pos), bits)
    vmin, vmax = int(np.asarray(q).min()), int(np.asarray(q).max())
    hist_bins = tdev.default_hist_bins(bits)
    sym, counts = tdev.encode_step_chunk(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(
            np.array(mins)), torch.from_numpy(np.array(dm)), vmin, vmax,
        bits=bits, hist_bins=hist_bins)
    jsym, jcounts = jdev.encode_step_chunk(
        *(jnp.asarray(a) for a in args), mins, dm, vmin, vmax, bits=bits,
        hist_bins=hist_bins)
    assert sym.dtype == torch.int32 and counts.dtype == torch.int32
    assert np.array_equal(sym.numpy().astype(np.int64),
                          np.asarray(jsym).astype(np.int64))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts.sum()) == nv * 3 < chunk * 3 or nv == chunk


@pytest.mark.parametrize("bits", (11, 14))
def test_encode_step_matches_jax(bits):
    positions, faces = torchdraco.make_mesh_batch(3, 9, seed=bits)
    mesh0 = torchdraco.build_meshes(positions[:1], faces)[0]
    g_np = tbatch.topology_gathers_np(tbatch.PreparedTopology(mesh0),
                                      mesh0.position_attribute())
    positions[2] = 0.0  # a degenerate mesh: delta_max == 0
    got = tdev.encode_step(torch.from_numpy(positions),
                           tbatch.gathers_to_torch(g_np, "cpu"), bits=bits)
    want = jdev.encode_step(jnp.asarray(positions),
                            {k: jnp.asarray(v) for k, v in g_np.items()},
                            bits=bits)
    assert got.keys() == want.keys()
    for k in ("symbols", "counts", "vmin", "vmax"):
        assert np.array_equal(got[k].numpy().astype(np.int64),
                              np.asarray(want[k]).astype(np.int64)), k
    assert _same_bits(got["mins"], want["mins"])
    assert _same_bits(got["delta_max"], want["delta_max"])


@pytest.mark.parametrize("bits", (8, 11, 16))
def test_dequantize_matches_jax(bits):
    rng = np.random.default_rng(bits)
    vals = (rng.standard_normal((2, 300, 3)) * 7).astype(np.float32)
    q, mins, dm = jdev.quantize_kernel(jnp.asarray(vals), bits)
    got = tdev.dequantize_kernel(torch.from_numpy(np.array(q)),
                                 torch.from_numpy(np.array(mins)),
                                 torch.from_numpy(np.array(dm)), bits)
    want = jdev.dequantize_kernel(q, mins, dm, bits)
    assert _same_bits(got, want)
    # the host's float32 formula: the product rounded before the sum
    scale = (np.asarray(dm) / np.float32((1 << bits) - 1)).astype(np.float32)
    host = (np.asarray(q).astype(np.float32) * scale[:, None, None]).astype(
        np.float32) + np.asarray(mins)[:, None, :]
    assert _same_bits(got, host)


def test_unzigzag_matches_jax():
    rng = np.random.default_rng(5)
    u = np.concatenate([rng.integers(0, 1 << 32, 5000, dtype=np.uint64),
                        [0, 1, 2, 3, (1 << 32) - 1, (1 << 32) - 2,
                         (1 << 31), (1 << 31) - 1]]).astype(np.uint32)
    want = np.asarray(jdev.unzigzag_kernel(jnp.asarray(u)))
    got = tdev.unzigzag_kernel(torch.from_numpy(u.astype(np.int64)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    v = rng.integers(-(1 << 30), 1 << 30, 5000).astype(np.int32)
    assert np.array_equal(tdev.unzigzag_kernel(
        tdev.zigzag_kernel(torch.from_numpy(v))).numpy(), v)


@pytest.mark.parametrize("shape", ((3, 7, 3), (2, 8, 3), (1, 1, 1)))
def test_unpack12_matches_jax_and_pack12(shape):
    q = np.random.default_rng(sum(shape)).integers(
        0, 1 << 12, size=shape).astype(np.uint16)
    lo, hb = native.pack12(q)
    got = tdev.unpack12_kernel(torch.from_numpy(lo), torch.from_numpy(hb))
    want = jdev.unpack12_kernel(jnp.asarray(lo), jnp.asarray(hb))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), q.astype(np.int32))


def test_histogram_split_is_chosen_from_the_shape():
    """K2 keeps one block a row at the batch path's shape and spreads the
    single-mesh rows over the card (here one of 132 SMs and one of 16);
    on the CPU it is the plain count."""
    split = tdev.histogram_splits
    assert split(512, 12288, 4096, 132) == 1
    assert split(1, 3 * (1 << 20), 4096, 132) > 100
    assert 1 < split(1, 3 * (1 << 15), 4096, 132) < 20
    assert split(3, 1_000_003, 4096, 132) > 20
    assert split(1, 3 * (1 << 20), 1 << 17, 132) == 264
    assert split(1, 3 * (1 << 20), 1 << 17, 16) == 32
    assert split(32, 3 * (1 << 20), 4096, 16) == 1
    assert split(1, 100, 4096, 132) == 1
    for sms in (16, 132):
        fill = tdev.HIST_BLOCKS_PER_SM * sms
        for B, N, bins in ((1, 3 * (1 << 20), 4096), (3, 1_000_003, 4096),
                           (1, 98_304, 1 << 17)):
            s = split(B, N, bins, sms)
            assert B * s <= 2 * fill
            assert s == 1 or N // s >= tdev.HIST_MIN_SLICE
    sym = torch.from_numpy(np.random.default_rng(1).integers(
        -3, 4100, size=(1, 50_000), dtype=np.int32))
    assert torch.equal(tdev.histogram(sym, 4096),
                       tdev.bincount_kernel(sym, 4096))


# ---------------------------------------------------------- device routes

def _fan_mesh(n, fan, seed):
    """A grid with positions, normals and UVs and one fan vertex of
    valence ``fan`` (make_mesh_batch's fan)."""
    pos, faces = torchdraco.make_mesh_batch(1, n, seed=seed, fan=fan)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed=seed + 1)
    return torchdraco.build_meshes(pos, faces, nrm, uvs)[0]


def _meshes():
    return {"grid": _grid_mesh(20, 3), "normals_uvs":
            _grid_mesh_with_normals(16, 5), "holes": _random_mesh(4, 12),
            "fan": _fan_mesh(16, 15, 7)}


@pytest.mark.parametrize("bits", (11, 13))
@pytest.mark.parametrize("kind", ("grid", "normals_uvs", "holes", "fan"))
def test_resident_route_matches_encode_and_jax(kind, bits):
    """tests/test_parallel.py:636 and :660: the resident route gives
    encode()'s bytes and tpudraco's encode_mesh_device's, and its NORMAL
    and TEX_COORD entries come from the chains."""
    mesh = _meshes()[kind]
    cfg, port_cfg = _cfgs(bits)
    be = tbatch.BatchEncoder()
    got = be.encode_mesh_device(mesh, bits=bits, device="cpu")
    assert got == encode(mesh, cfg=cfg)
    assert got == JaxBatchEncoder(strict_device=True).encode_mesh_device(
        mesh, bits=bits)
    # at -qp 13 the ring sums may pass int32: the NORMAL attribute goes to
    # the host encoder by the reference's headroom rule, and is counted
    with_normals = kind in ("normals_uvs", "fan")
    on_host = [1] if with_normals and bits == 13 else []
    assert be.n_host_attributes == len(on_host)
    assert set(be.timings) == {"topology_s", "position_s", "chains_s",
                               "assembly_s"}
    assert tbatch.BatchEncoder(cfg=port_cfg).encode_mesh_device(
        mesh, device="cpu") == got
    if with_normals:
        _, topo = be._topo_for(mesh)
        extra = tbatch._device_extra_attribute_entries(
            [mesh], [0], topo, bits=bits, device="cpu")
        assert sorted(extra.get(0, {})) == [a for a in (1, 2)
                                            if a not in on_host]


def test_resident_route_counts_guarded_attributes():
    """A zero normal sends the NORMAL attribute to the host encoder: the
    bytes stay encode()'s and the attribute is counted."""
    mesh = _grid_mesh_with_normals(12, 2)
    mesh.attributes[1].values[4] = 0.0
    be = tbatch.BatchEncoder()
    assert be.encode_mesh_device(mesh, device="cpu") == encode(mesh)
    assert be.n_host_attributes == 1


@pytest.mark.parametrize("chunk", (64, 257, 1 << 15))
@pytest.mark.parametrize("kind", ("grid", "normals_uvs", "holes", "fan"))
def test_chunked_route_matches_encode(kind, chunk):
    """tests/test_parallel.py:618: every chunk size gives encode()'s
    bytes, a chunk far below the traversal and odd tails included."""
    mesh = _meshes()[kind]
    be = tbatch.BatchEncoder()
    got = be.encode_mesh_device_chunked(mesh, chunk=chunk, device="cpu")
    assert got == encode(mesh)
    assert {"pass1_s", "pass2_s", "pass3_s", "assembly_s"} <= set(be.timings)
    if kind == "grid" and chunk == 64:
        assert got == JaxBatchEncoder(strict_device=True) \
            .encode_mesh_device_chunked(mesh, chunk=chunk)


def test_chunked_route_at_13_bits():
    mesh = _grid_mesh(20, 3)
    cfg, port_cfg = _cfgs(13)
    got = tbatch.BatchEncoder().encode_mesh_device_chunked(
        mesh, bits=13, chunk=100, device="cpu")
    assert got == encode(mesh, cfg=cfg)
    assert tbatch.BatchEncoder(cfg=port_cfg).encode_mesh_device_chunked(
        mesh, chunk=100, device="cpu") == got


def test_chunked_route_raises(monkeypatch):
    """A lost symbol raises (not an assert, which -O strips), as do
    non-finite positions, a bad chunk and a cfg past depths."""
    mesh = _grid_mesh(9, 1)
    real = tbatch.encode_step_chunk

    def lossy(*a, **kw):
        sym, counts = real(*a, **kw)
        counts = counts.clone()
        counts[0] -= 1
        return sym, counts
    monkeypatch.setattr(tbatch, "encode_step_chunk", lossy)
    with pytest.raises(RuntimeError, match="lost symbols"):
        tbatch.BatchEncoder().encode_mesh_device_chunked(mesh, device="cpu")
    monkeypatch.setattr(tbatch, "encode_step_chunk", real)
    bad = _grid_mesh(9, 1)
    bad.attributes[0].values[5, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tbatch.BatchEncoder().encode_mesh_device_chunked(bad, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        tbatch.BatchEncoder().encode_mesh_device_chunked(mesh, chunk=0,
                                                         device="cpu")
    for route in ("encode_mesh_device", "encode_mesh_device_chunked"):
        with pytest.raises(ValueError, match="config space"):
            getattr(tbatch.BatchEncoder(cfg=PortConfig(traversal=2)),
                    route)(mesh, device="cpu")


def _spy_routes(monkeypatch):
    taken = []
    for name in ("encode_mesh_device", "encode_mesh_device_chunked"):
        real = getattr(tbatch.BatchEncoder, name)

        def spy(self, m, *a, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(self, m, *a, **kw)
        monkeypatch.setattr(tbatch.BatchEncoder, name, spy)
    return taken


def test_encode_huge_dispatches_by_size(monkeypatch):
    """Both sides of RESIDENT_MAX_BYTES give encode()'s bytes, through the
    route the estimated peak names."""
    mesh = _grid_mesh_with_normals(14, 6)
    taken = _spy_routes(monkeypatch)
    be = tbatch.BatchEncoder()
    peak = be._resident_peak_bytes(mesh)
    assert be._encode_huge(mesh, device="cpu") == encode(mesh)
    monkeypatch.setattr(tbatch.BatchEncoder, "RESIDENT_MAX_BYTES", peak - 1)
    assert be._encode_huge(mesh, device="cpu") == encode(mesh)
    monkeypatch.setattr(tbatch.BatchEncoder, "RESIDENT_MAX_BYTES", peak)
    assert be._encode_huge(mesh, device="cpu") == encode(mesh)
    assert taken == ["encode_mesh_device", "encode_mesh_device_chunked",
                     "encode_mesh_device"]
    assert tbatch.BatchEncoder.CHUNKED_MIN_VERTS == \
        JaxBatchEncoder.CHUNKED_MIN_VERTS


@pytest.mark.parametrize("fan", (0, 13))
def test_make_mesh_batch_fan(fan):
    """make_mesh_batch's fan: one vertex more, ``fan`` triangles more, and
    a vertex of valence ``fan``; without it the grid is as before."""
    pos, faces = torchdraco.make_mesh_batch(2, 14, seed=3, fan=fan)
    grid_pos, grid_faces = torchdraco.make_mesh_batch(2, 14, seed=3)
    V = 14 * 14 + (1 if fan else 0)
    assert pos.shape == (2, V, 3) and len(faces) == len(grid_faces) + fan
    assert np.array_equal(pos[:, :196], grid_pos)
    assert np.array_equal(faces[:len(grid_faces)], grid_faces)
    assert np.bincount(faces.ravel()).max() == max(6, fan)
    with pytest.raises(ValueError, match="fan"):
        torchdraco.make_mesh_batch(1, 14, fan=14)


def test_encode_huge_weighs_the_ring_width(monkeypatch):
    """The estimate charges each TEX_COORD attribute per vertex and each
    NORMAL attribute the device chain takes T x R ring slots of its
    tables and T steps, R the rings' own width: a fan vertex of valence 13 sends a mesh to the chunked
    route under a budget that keeps the plain grid of nearly the same
    size resident, and a depth at which the chain leaves the normals to
    the host charges no ring."""
    meshes = {fan: _fan_mesh(14, fan, 4) for fan in (0, 13)}
    be = tbatch.BatchEncoder()
    peaks = {}
    for fan, m in meshes.items():
        _, topo = be._topo_for(m)
        ni = next(i for i, a in enumerate(m.attributes)
                  if a.att_type == PortAttributeType.NORMAL)
        R = int(topo.rings_for(ni)["next_pt"].shape[1])
        assert R == max(6, fan)
        peaks[fan] = be._resident_peak_bytes(m)
        V = m.position_attribute().num_points
        assert peaks[fan] == (
            V * (be.RESIDENT_BYTES_PER_VERTEX
                 + be.RESIDENT_UV_BYTES_PER_VERTEX)
            + len(topo.sequences[ni]) * (
                R * tbatch.RING_TABLE_BYTES_PER_SLOT
                + be.RESIDENT_NORMAL_BYTES_PER_STEP))
    assert peaks[13] > peaks[0]
    taken = _spy_routes(monkeypatch)
    monkeypatch.setattr(tbatch.BatchEncoder, "RESIDENT_MAX_BYTES", peaks[0])
    for fan in (0, 13):
        assert be._encode_huge(meshes[fan], device="cpu") == \
            encode(meshes[fan])
    assert taken == ["encode_mesh_device", "encode_mesh_device_chunked"]
    # at -qp 14 a ring of 13 can leave int32: the normals go to the host
    # encoder, and the estimate holds no ring
    assert tbatch._normal_chain_fits(13, 11)
    assert not tbatch._normal_chain_fits(13, 14)
    deep = tbatch.BatchEncoder(cfg=_cfgs(14)[1])
    assert deep._resident_peak_bytes(meshes[13]) == \
        meshes[13].position_attribute().num_points * (
            deep.RESIDENT_BYTES_PER_VERTEX + deep.RESIDENT_UV_BYTES_PER_VERTEX)


@pytest.mark.parametrize("route", ("encode_mesh_device",
                                   "encode_mesh_device_chunked",
                                   "_encode_huge"))
def test_single_mesh_routes_default_to_the_card(monkeypatch, route):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = _grid_mesh(6, 0)
    call = getattr(tbatch.BatchEncoder(), route)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(mesh)
    assert call(mesh, device="cpu") == encode(mesh)


# ------------------------------------------------------------- host plane

@pytest.mark.parametrize("which", ("valence", "predictive", "single"))
def test_encode_mesh_honors_connectivity_config(which):
    """tests/test_predictive_eb.py:89: encode_mesh under a valence,
    predictive or single-connectivity cfg equals encode(m, cfg), through a
    cache keyed on those knobs; the default cfg keeps the plain key."""
    kw = {"valence": {"traversal": EB_VALENCE},
          "predictive": {"traversal": EB_PREDICTIVE},
          "single": {"use_single_connectivity": True}}[which]
    cfg, port_cfg = Config(**kw), PortConfig(**kw)
    meshes = [_grid_mesh_with_normals(9, 1), _random_mesh(7, 10)]
    be = tbatch.BatchEncoder(cfg=port_cfg)
    jbe = JaxBatchEncoder(cfg=cfg)
    for m in meshes:
        assert be.encode_mesh(m) == encode(m, cfg=cfg) == jbe.encode_mesh(m)
        key = (tbatch.topology_signature(m), port_cfg.traversal,
               port_cfg.use_single_connectivity)
        assert key in be._topo_cache
    # the same encoder, asked for the default config per call, uses a
    # STANDARD topology of its own: the plain key
    plain = tbatch.BatchEncoder()
    for m in meshes:
        assert be.encode_mesh(m, cfg=PortConfig()) == encode(m) \
            == plain.encode_mesh(m)
        assert tbatch.topology_signature(m) in plain._topo_cache


def test_prepared_topology_takes_the_connectivity_knobs():
    mesh = _grid_mesh_with_normals(8, 2)
    for kw in ({"traversal": EB_VALENCE}, {"traversal": EB_PREDICTIVE},
               {"single_connectivity": True}):
        t, j = tbatch.PreparedTopology(mesh, **kw), \
            jbatch.PreparedTopology(mesh, **kw)
        assert t.conn_bytes == j.conn_bytes, kw
        assert t.sequences == j.sequences
    assert tbatch.PreparedTopology(mesh, traversal=EB_VALENCE).conn_bytes \
        != tbatch.PreparedTopology(mesh).conn_bytes


def test_encode_meshes_isolates_a_failing_mesh():
    good = [_grid_mesh(6, 1), _random_mesh(3, 8)]
    bad = _grid_mesh(6, 2)
    bad.attributes[0].values[3, 0] = np.inf
    got = tbatch.BatchEncoder().encode_meshes([good[0], bad, good[1]])
    assert got == [encode(good[0]), None, encode(good[1])]
    assert got == JaxBatchEncoder().encode_meshes([good[0], bad, good[1]])


# ---------------------------------------------------------------- repairs

def test_device_table_lru_evicts_past_its_budget(monkeypatch):
    """Past DEV_CACHE_BUDGET the least recently used topologies lose their
    device tables (they keep their host state); the bytes do not move."""
    groups = [_grid_mesh_with_normals(n, n) for n in (7, 8, 9)]
    want = [encode(m) for m in groups]
    be = tbatch.BatchEncoder()
    monkeypatch.setattr(be, "DEV_CACHE_BUDGET", 1)
    assert be.encode_mesh_device(groups[0], device="cpu") == want[0]
    assert be.encode_meshes_device(groups[1:], device="cpu") == want[1:]
    topos = [be._topo_cache[tbatch.topology_signature(m)] for m in groups]
    assert [t.device_bytes() > 0 for t in topos] == [False, False, True]
    assert list(be._dev_cache) == [tbatch.topology_signature(groups[2])]
    assert len(be._topo_cache) == 3
    # a touched topology is the most recent again, and rebuilds its tables
    assert be.encode_mesh_device(groups[0], device="cpu") == want[0]
    assert [t.device_bytes() > 0 for t in topos] == [True, False, False]
    monkeypatch.setattr(be, "DEV_CACHE_BUDGET", 1 << 40)
    assert be.encode_meshes_device(groups, device="cpu") == want
    assert all(t.device_bytes() > 0 for t in topos)
    assert be.DEV_CACHE_BUDGET == 1 << 40 and \
        tbatch.BatchEncoder.DEV_CACHE_BUDGET == 8 << 30


@pytest.mark.parametrize("entropy", ("host", "device"))
def test_non_bytes_entry_yields_none(entropy):
    """The reference compares the connectivity prefix inside its per-blob
    isolation: an entry that is not bytes yields None, and the group
    decodes."""
    meshes = [_grid_mesh(7, s) for s in range(3)]
    blobs = [encode(m) for m in meshes]
    mixed = [blobs[0], None, blobs[1], 12345, b"junk", blobs[2]]
    got = BatchDecoder().decode_blobs_shared_topology(
        mixed, entropy=entropy, device="cpu")
    assert [g is None for g in got] == [False, True, False, True, True,
                                        False]
    for g, b in zip([got[0], got[2], got[5]], blobs):
        assert np.array_equal(g.attributes[0].values,
                              decode(b).attributes[0].values)


def test_auto_normal_phase_needs_the_card_or_an_answer(monkeypatch):
    """normals="auto" takes the card for the batched normal phase, with
    entropy="host" too; without a card the call raises, naming both ways
    to stay on the CPU, and switches to the host by itself never."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bd = BatchDecoder()
    n = bd.PHASED_NORMALS_MIN_BLOBS
    pos, faces = torchdraco.make_mesh_batch(n, 6, 3)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, 6, 4)
    blobs = [encode(m) for m in torchdraco.build_meshes(pos, faces, nrm,
                                                        uvs)]
    with pytest.raises(RuntimeError, match="normals='host'") as err:
        bd.decode_blobs_shared_topology(blobs)
    assert "device='cpu'" in str(err.value)
    assert bd.n_host_blobs == 0
    want = [decode(b) for b in blobs]
    for kw in ({"normals": "host"}, {"device": "cpu"}):
        got = BatchDecoder().decode_blobs_shared_topology(blobs, **kw)
        assert all(np.array_equal(g.attributes[1].values_per_point(),
                                  w.attributes[1].values_per_point())
                   for g, w in zip(got, want))
    # below the threshold "auto" keeps the host chains: no card needed
    few = BatchDecoder().decode_blobs_shared_topology(blobs[:2])
    assert few[0] is not None
    assert "normals='host'" in BatchDecoder.decode_blobs_shared_topology \
        .__doc__.replace('"', "'")


# ------------------------------------------------------------- isolation

_BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpudraco"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""

_RUN_SINGLE = """
import json, sys
sys.path.insert(0, {root!r})
import torchdraco
from torchdraco.encode import encode
from torchdraco.parallel import BatchEncoder
pos, faces = torchdraco.make_mesh_batch(1, 14, 8)
nrm, uvs = torchdraco.make_normal_uv_batch(pos, 14, 9)
m3 = torchdraco.build_meshes(pos, faces, nrm, uvs)[0]
m1 = torchdraco.build_meshes(pos, faces)[0]
be = BatchEncoder()
out = {{"resident": be.encode_mesh_device(m3, device="cpu").hex(),
       "chunked": be.encode_mesh_device_chunked(m1, chunk=50,
                                                device="cpu").hex(),
       "huge": be._encode_huge(m3, device="cpu").hex(),
       "host": [b.hex() for b in be.encode_meshes([m1, m3])],
       "n_host_attributes": be.n_host_attributes}}
assert bytes.fromhex(out["resident"]) == encode(m3)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tpudraco"))
out["foreign"] = foreign
print(json.dumps(out))
"""


@pytest.mark.parametrize("block", (True, False))
def test_single_mesh_slice_loads_nothing_of_jax(block):
    """The routes in a process (with and without a finder that refuses
    jax and tpudraco) load no module of either, and give tpudraco's host
    encoder's bytes."""
    code = (_BLOCK_JAX if block else "") + _RUN_SINGLE.format(root=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["foreign"] == [] and got["n_host_attributes"] == 0
    pos, faces = torchdraco.make_mesh_batch(1, 14, 8)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, 14, 9)
    m3 = torchdraco.build_meshes(pos, faces, nrm, uvs)[0]
    m1 = torchdraco.build_meshes(pos, faces)[0]
    assert bytes.fromhex(got["resident"]) == encode(m3)
    assert bytes.fromhex(got["huge"]) == encode(m3)
    assert bytes.fromhex(got["chunked"]) == encode(m1)
    assert [bytes.fromhex(h) for h in got["host"]] == [encode(m1),
                                                       encode(m3)]

"""K1's tiled form and K2's wide form on the CPU: the tile tables that the
tiled kernel reads (``torchdraco.ops.device.predict_tiles``) rebuild every
gather of a traversal, their plain reading (``_tiled_reading``) equals
K1's plain version and tpudraco's gather step in every upload layout, K2's
plain version equals tpudraco's ``bincount_kernel`` at the wide forms' bin
counts, the wrappers pick each form from the shape, the batch path keeps
the tables beside the gathers, and ``encode_meshes_device`` on meshes past
K1's shared-memory budget at -qp 11, 15 and 16 gives tpudraco's bytes."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco import native, trace  # noqa: E402
from torchdraco.device import shard_bounds  # noqa: E402
from torchdraco.encode import Config as PortConfig  # noqa: E402
from torchdraco.models import AttributeDomain as PortDomain  # noqa: E402
from torchdraco.models import AttributeType as PortType  # noqa: E402
from torchdraco.models import MeshBuilder as PortMeshBuilder  # noqa: E402
from torchdraco.ops import device as tdev  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.encode import Config, encode  # noqa: E402
from tpudraco.models import AttributeType  # noqa: E402
from tpudraco.ops import device as jdev  # noqa: E402
from tpudraco.parallel import BatchEncoder as JaxBatchEncoder  # noqa: E402

_INDEX = ("order", "next", "prev", "opp", "fallback")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topology_gathers(mesh) -> dict:
    topo = tbatch.PreparedTopology(mesh)
    return tbatch.topology_gathers_np(topo, mesh.position_attribute())


def _grid(n: int, fan: int = 0):
    pos, faces = torchdraco.make_mesh_batch(2, n, 5, fan=fan)
    return pos, _topology_gathers(torchdraco.build_meshes(pos[:1], faces)[0])


def _random_mesh(rng, n: int):
    """tests/test_fuzz.py's ``_random_mesh`` through the port's builder: a
    grid with random holes, whose orphaned vertices the builder drops."""
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
    b = PortMeshBuilder()
    b.set_connectivity_attribute(np.asarray(faces, dtype=np.int64))
    b.add_attribute(pos, PortType.POSITION, PortDomain.POSITION)
    return b.build()


def _random_gathers(rng, V: int, T: int) -> dict:
    g = {k: rng.integers(0, V, size=T).astype(np.int32) for k in _INDEX}
    g["can_para"] = rng.random(T) < 0.7
    g["has_fallback"] = rng.random(T) < 0.6
    return g


def _assert_tables_rebuild(g_np: dict, tile: int) -> tdev.PredictTiles:
    """Every index a step reads comes back through its tile's list:
    ``verts[off[t // tile] + local[k, t]] == gathers[k][t]``, and exactly
    the unread ones are -1; each tile's list is sorted and distinct."""
    tiles = tdev.predict_tiles(tbatch.gathers_to_torch(g_np, "cpu"), tile)
    T = len(g_np["order"])
    verts = tiles.verts.numpy().astype(np.int64)
    off = tiles.off.numpy().astype(np.int64)
    local = tiles.local.numpy().astype(np.int64)
    assert tiles.local.dtype == torch.int16 and local.shape == (5, T)
    assert len(off) == -(-T // tile) + 1 and off[0] == 0
    assert off[-1] == len(verts)
    sizes = np.diff(off)
    assert tiles.max_verts == (int(sizes.max()) if T else 0)
    for k in range(len(sizes)):
        run = verts[off[k]:off[k + 1]]
        assert np.all(np.diff(run) > 0)
    para = g_np["can_para"].astype(bool)
    read = np.stack([np.ones(T, bool), para, para, para,
                     g_np["has_fallback"].astype(bool) & ~para])
    base = off[np.arange(T) // tile]
    for k, name in enumerate(_INDEX):
        assert np.all((local[k] >= 0) == read[k]), name
        r = read[k]
        assert np.all(local[k][r] < sizes[np.arange(T) // tile][r])
        assert np.array_equal(verts[base[r] + local[k][r]],
                              g_np[name][r].astype(np.int64)), name
    return tiles


@pytest.mark.parametrize("tile", (32, 1024, 2048, 4096))
@pytest.mark.parametrize("n,fan", ((64, 0), (160, 0), (64, 40)))
def test_tile_tables_rebuild_grid_gathers(n, fan, tile):
    _assert_tables_rebuild(_grid(n, fan)[1], tile)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_tile_tables_rebuild_random_mesh_gathers(seed):
    rng = np.random.default_rng(seed)
    _assert_tables_rebuild(_topology_gathers(_random_mesh(rng, 23)), 64)


@pytest.mark.parametrize("V,T,tile", ((50000, 9000, 2048), (37, 1000, 256),
                                      (900, 33, 32), (5, 0, 2048)))
def test_tile_tables_rebuild_random_gathers(V, T, tile):
    tiles = _assert_tables_rebuild(
        _random_gathers(np.random.default_rng(V + T), V, T), tile)
    assert tiles.max_verts <= 5 * tile


@pytest.mark.parametrize("shards", (3, 7))
def test_tile_tables_of_stream_segments_that_cut_a_tile(shards):
    """A stream shard's segment [a, b) of the traversal gets tables of its
    own, whose first tile starts at a, not at a tile of the whole."""
    g_np = _grid(96)[1]
    T = len(g_np["order"])
    bounds = shard_bounds(T, shards)
    assert any(a % 640 for a, _ in bounds)
    for a, b in bounds:
        _assert_tables_rebuild({k: v[a:b] for k, v in g_np.items()}, 640)


def test_tile_tables_refuse_a_tile_they_cannot_index():
    g = tbatch.gathers_to_torch(_grid(8)[1], "cpu")
    for tile in (0, 48, 8192):
        with pytest.raises(ValueError):
            tdev.predict_tiles(g, tile)


def _tiled_reading(q, tiles: tdev.PredictTiles, vmin, vmax):
    """K1's symbols read through its tile tables alone, as the tiled
    kernel reads them: each tile's vertices staged from q (any upload
    layout), each step's values gathered at its local positions."""
    staged = tdev.widen(q)[:, tiles.verts.long()]
    T = tiles.local.shape[1]
    base = tiles.off[:-1].long().repeat_interleave(tiles.tile)[:T]
    loc = tiles.local.long()

    def at(k):
        return staged[:, base + loc[k].clamp(min=0)]
    fallback = torch.where((loc[4] >= 0)[:, None], at(4),
                           torch.zeros_like(at(4)))
    preds = torch.where((loc[1] >= 0)[:, None], at(1) + at(2) - at(3),
                        fallback)
    return tdev._wrapped_zigzag(at(0), preds, vmin, vmax)


def _upload(q: np.ndarray, layout: str):
    if layout == "u8":
        return torch.from_numpy(q.astype(np.uint8))
    if layout == "pack12":
        return tuple(torch.from_numpy(a) for a in native.pack12(q))
    return torch.from_numpy(q.astype(np.uint16 if layout == "u16"
                                     else np.int32))


@pytest.mark.parametrize("layout,bits", (("u8", 8), ("pack12", 11),
                                         ("u16", 14), ("u16", 16),
                                         ("i32", 16)))
@pytest.mark.parametrize("n,fan", ((40, 0), (48, 30)))
def test_tiled_reading_equals_k1_and_jax_step(layout, bits, n, fan):
    """The tiled kernel's indexing, emulated in plain torch, against K1's
    plain version and tpudraco's gather step (``encode_step_from_q``,
    under ``jax.enable_x64`` for 16-bit values), in every layout."""
    pos, g_np = _grid(n, fan)
    q, _, _, vmin, vmax = native.quantize_batch(pos, bits)
    g = tbatch.gathers_to_torch(g_np, "cpu")
    lo, hi = torch.from_numpy(vmin), torch.from_numpy(vmax)
    up = _upload(q, layout)
    want = tdev.predict_residual_ref(up, g, lo, hi)
    for tile in (256, 2048):
        got = _tiled_reading(up, tdev.predict_tiles(g, tile), lo, hi)
        assert torch.equal(got, want), tile
    with jax.enable_x64(True):
        ref = jdev.encode_step_from_q(
            jnp.asarray(q.astype(np.int32)),
            {k: jnp.asarray(v) for k, v in g_np.items()}, bits=bits)
    assert np.array_equal(want.numpy(),
                          np.asarray(ref["symbols"]).astype(np.int64))


@pytest.mark.parametrize("C", (1, 2, 4))
def test_tiled_reading_on_random_gathers(C):
    rng = np.random.default_rng(C)
    V, T = 3000, 700
    q = rng.integers(0, 4096, size=(3, V, C)).astype(np.int32)
    g = tbatch.gathers_to_torch(_random_gathers(rng, V, T), "cpu")
    lo = torch.from_numpy(q.min(axis=(1, 2)))
    hi = torch.from_numpy(q.max(axis=(1, 2)))
    for layout in ("pack12", "u16", "i32"):
        up = _upload(q, layout)
        assert torch.equal(
            _tiled_reading(up, tdev.predict_tiles(g, 128), lo, hi),
            tdev.predict_residual_ref(up, g, lo, hi)), layout


@pytest.mark.parametrize("bins", (1 << 16, 1 << 17))
@pytest.mark.parametrize("kind", ("clustered", "uniform"))
def test_wide_histogram_plain_version_matches_jax(bins, kind):
    """K2's plain version at the wide forms' bin counts against tpudraco's
    ``bincount_kernel``; symbols past the bins are dropped by both."""
    rng = np.random.default_rng(bins)
    if kind == "clustered":  # zigzagged residuals: most near 0
        sym = np.minimum(rng.geometric(0.01, size=(4, 30000)) - 1,
                         bins + 50)
        sym[:, :40] = bins - 1 - np.arange(40)
    else:
        sym = rng.integers(0, bins + 100, size=(4, 30000))
    sym = sym.astype(np.int32)
    want = np.asarray(jdev.bincount_kernel(jnp.asarray(sym), bins))
    got = tdev.bincount_kernel(torch.from_numpy(sym), bins)
    assert np.array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.shape == (4, bins)


def test_predict_form_from_the_shape():
    """Rows kernel while the skewed row fits; past it the tiled kernel for
    C of 1 to 4 and the direct gather beyond; the 12-bit pack stages 2
    bytes a value. The last meshes on the rows kernel and the first on the
    tiled one, at three components."""
    for itemsize, last in ((1, 36078), (2, 18039), (4, 9019)):
        assert tdev.predict_form(last, 3, itemsize) == "rows"
        assert tdev.predict_form(last + 1, 3, itemsize) == "tiled"
    assert tdev.predict_form(1 << 20, 4, 4) == "tiled"
    assert tdev.predict_form(1 << 20, 1, 1) == "tiled"
    assert tdev.predict_form(100, 5, 4) == "gather"


def test_tiled_shared_memory_fits_every_layout_at_the_default_tile():
    """The largest tile PREDICT_TILE can make (5 distinct vertices a step)
    fits a block's shared memory at every staged width and C up to 4."""
    tiles = tdev.PredictTiles(
        torch.zeros(0, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        torch.zeros((5, 0), dtype=torch.int16), tdev.PREDICT_TILE,
        5 * tdev.PREDICT_TILE)
    for itemsize in (1, 2, 4):
        assert tdev._tiled_smem_bytes(tiles, 4, itemsize) \
            <= tdev.SMEM_MAX_BYTES
    wide = tiles._replace(tile=4096, max_verts=5 * 4096)
    assert tdev._tiled_smem_bytes(wide, 4, 4) > tdev.SMEM_MAX_BYTES


def test_histogram_form_from_the_bins():
    assert tdev.histogram_form(tdev.HIST_SMEM_MAX_BINS) == "smem"
    assert tdev.histogram_form(tdev.HIST_SMEM_MAX_BINS + 1) == "wide"
    assert [tdev.histogram_form(tdev.default_hist_bins(b))
            for b in (8, 11, 14, 15, 16)] == ["smem"] * 3 + ["wide"] * 2


def test_histogram_shared_bins_from_the_shape():
    """K2 keeps every bin in shared memory up to HIST_SMEM_MAX_BINS where
    a block owns its row, and at most a quarter of its slice's symbols
    where the row is split; a split row of the shared-memory form still
    keeps every bin (``histogram_splits`` gives it 4 symbols a bin)."""
    cap = tdev.HIST_SMEM_MAX_BINS
    assert tdev.histogram_smem_bins(12288, 1 << 16, 1) == cap
    assert tdev.histogram_smem_bins(12288, 4096, 1) == 4096
    for B, N, bins in ((1, 3 << 20, 4096), (1, 98304, 4096),
                       (3, 1_000_003, 4096)):
        splits = tdev.histogram_splits(B, N, bins, 132)
        assert splits > 1
        assert tdev.histogram_smem_bins(N, bins, splits) == bins
    assert tdev.histogram_splits(32, 196608, 1 << 16, 132) == 9
    assert tdev.histogram_smem_bins(196608, 1 << 16, 9) == 5461
    assert tdev.histogram_smem_bins(3 << 20, 1 << 17, 264) == 2979
    assert tdev.histogram_smem_bins(5, 1 << 17, 4) == 1


def test_topology_keeps_tile_tables_beside_gathers():
    """``_device_tiles`` builds a topology's tables once a device and
    segment, inside a ``position.tiles`` span, ``device_bytes`` counts
    them for the LRU, and ``drop_device_tables`` lets them go; the batch
    path leaves the choice to K1, whose plain version on the CPU asks for
    no tables."""
    pos, faces = torchdraco.make_mesh_batch(1, 30, 2)
    mesh = torchdraco.build_meshes(pos, faces)[0]
    topo = tbatch.PreparedTopology(mesh)
    att = mesh.position_attribute()
    dev = torch.device("cpu")
    g = tbatch._device_gathers(topo, att, dev, 900)
    before = topo.device_bytes()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        tiles = tbatch._device_tiles(topo, att, dev, 900)
        (built,) = trace.spans()
        assert built.name == "position.tiles"
        assert built.end_ns > built.start_ns
        assert tbatch._device_tiles(topo, att, dev, 900) is tiles
    assert trace.spans() == [built]
    trace.clear()
    seg = tbatch._device_tiles(topo, att, dev, 900, (100, 700))
    assert seg is not tiles and seg.local.shape == (5, 600)
    assert topo.device_bytes() == before + tiles.nbytes + seg.nbytes
    q = torch.from_numpy(native.quantize_batch(pos, 11)[0])
    lo = torch.zeros(1, dtype=torch.int32)
    hi = torch.full((1,), 2047, dtype=torch.int32)
    assert torch.equal(_tiled_reading(q, tiles, lo, hi),
                       tdev.predict_residual_ref(q, g, lo, hi))
    topo.drop_device_tables()
    assert topo.device_bytes() == 0 and not topo.dev_tiles
    tbatch.device_encode_group(pos, topo, att, bits=11, device="cpu")
    assert topo.dev_gathers and not topo.dev_tiles


@pytest.mark.parametrize("bits", (11, 15, 16))
def test_batch_past_the_rows_budget_matches_encode_and_jax(bits):
    """Four 140 x 140 grids (19,600 vertices: past the rows kernel's
    budget in every layout but uint8) through ``encode_meshes_device`` on
    the CPU, at -qp 11 (the 12-bit pack), 15 and 16 (uint16, K2's wide
    bins), against tpudraco's ``encode()`` and its batch encoder. The
    host's rANS coder codes the symbols: K3's plain version walks 58,800
    steps a lane in Python (tests/test_torch_rans_lanes.py holds it)."""
    pos, faces = torchdraco.make_mesh_batch(4, 140, 9)
    meshes = torchdraco.build_meshes(pos, faces)
    assert tdev.predict_form(140 * 140, 3, 2) == "tiled"
    cfg = Config(quant_bits={AttributeType.POSITION: bits})
    port_cfg = PortConfig(quant_bits={PortType.POSITION: bits})
    got = tbatch.BatchEncoder(cfg=port_cfg).encode_meshes_device(
        meshes, bits=bits, entropy="host", device="cpu")
    want_jax = JaxBatchEncoder(strict_device=True, cfg=cfg) \
        .encode_meshes_device(meshes, bits=bits)
    assert got == want_jax
    for m, blob in zip(meshes[:2], got):
        assert blob == encode(m, cfg=cfg)

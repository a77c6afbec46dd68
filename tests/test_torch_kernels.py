"""torchdraco's CUDA kernels against their plain PyTorch twins, and its
NORMAL and TEX_COORD chains against their own run on the CPU, on the card.

Every test here needs an NVIDIA GPU and skips without one; on a machine
with a card run them with ``python -m pytest -m cuda
tests/test_torch_kernels.py``. Equality is exact (tolerance 0)."""

import functools

import numpy as np
import pytest
import torch

import torchdraco
from torchdraco.decode import decode
from torchdraco.encode import encode
from torchdraco.entropy.rans import normalize_freq_counts_batch
from torchdraco.ops import device as tdev
from torchdraco.ops import normals as tnormals
from torchdraco.ops import rans_lanes as trl
from torchdraco.ops import texcoords as ttex
from torchdraco.parallel import BatchDecoder
from torchdraco.parallel import batch as tbatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _step_inputs(n, bits, batch, dev, seed=0):
    positions, faces = torchdraco.make_mesh_batch(batch, n, seed)
    mesh0 = torchdraco.build_meshes(positions[:1], faces)[0]
    topo = tbatch.PreparedTopology(mesh0)
    g_np = tbatch.topology_gathers_np(topo, mesh0.position_attribute())
    q, _, _ = tbatch.quantize_positions_host(positions, bits)
    q_up = q.astype(np.uint16) if bits <= 16 else q
    return (torch.from_numpy(q_up).to(dev), tbatch.gathers_to_torch(g_np, dev),
            torch.from_numpy(q.min(axis=(1, 2))).to(dev),
            torch.from_numpy(q.max(axis=(1, 2))).to(dev))


@pytest.mark.parametrize("bits", (11, 16, 20))
def test_predict_residual_kernel_matches_twin(cuda, bits):
    q, g, vmin, vmax = _step_inputs(24, bits, 16, cuda, seed=bits)
    n0 = tdev.predict_residual.n_launches
    got = tdev.predict_residual(q, g, vmin, vmax)
    torch.cuda.synchronize()
    assert tdev.predict_residual.n_launches == n0 + 1
    assert torch.equal(got, tdev.predict_residual_ref(q, g, vmin, vmax))


@pytest.mark.parametrize("bits", (11, 16))
def test_histogram_kernel_matches_twin(cuda, bits):
    bins = tdev.default_hist_bins(bits)
    assert (bins <= tdev.HIST_SMEM_MAX_BINS) == (bits == 11)
    rng = np.random.default_rng(bits)
    sym = torch.from_numpy(rng.integers(-9, bins + 9, size=(33, 5000),
                                        dtype=np.int32)).to(cuda)
    got = tdev.histogram(sym, bins)
    torch.cuda.synchronize()
    assert torch.equal(got, tdev.bincount_kernel(sym, bins))
    drop = torch.tensor([[-3, 0, 0, 5, bins + 7, bins - 1, -1, bins]],
                        dtype=torch.int32, device=cuda)
    assert tdev.histogram(drop, bins).sum().item() == 4


def test_rans_words_kernel_matches_twin(cuda):
    rng = np.random.default_rng(7)
    L, n = 64, 700
    syms = (rng.integers(0, 40, size=(L, n)) ** 2 % 1500).astype(np.int32)
    syms[3] = rng.integers(0, 1 << 12, size=n)
    prec = (12 + np.arange(L) % 9).astype(np.int32)
    counts = np.stack([np.bincount(r, minlength=1 << 12) for r in syms])
    dist, _ = normalize_freq_counts_batch(counts, prec)
    cums = np.zeros_like(dist)
    cums[:, 1:] = np.cumsum(dist[:, :-1], axis=1)
    lengths = rng.integers(0, n + 1, size=L).astype(np.int32)
    lengths[0] = n
    args = [torch.from_numpy(a.astype(np.int32)).to(cuda)
            for a in (syms, dist, cums, prec, lengths)]
    words, meta = trl.rans_words_scan(*args)
    torch.cuda.synchronize()
    ref_w, ref_m = trl.rans_words_scan_ref(*args)
    assert torch.equal(meta, ref_m)
    assert torch.equal(words, ref_w)


@pytest.mark.parametrize("prec", (12, 20))
def test_rans_words_reciprocal_is_exact(cuda, prec):
    """K3 divides by a prepared reciprocal. Tables that put the division at
    its edges: frequencies of 1, powers of two, one below and above a power
    of two, a single symbol of frequency 2^P, and one symbol that takes
    nearly the whole range; every lane at full length, so the state runs
    up to freq * 2^10 - 1 before each step. Staged rows (small alphabets)
    and rows read through L2 (a wide one)."""
    rng = np.random.default_rng(prec)
    n, total = 3000, 1 << prec
    tables = [
        [total],                                     # f = 2^P alone
        [total - 1, 1],
        [1] * 64 + [total - 64],
        [total // 2, total // 4, total // 4],        # powers of two
        [total // 2 - 1, total // 2 + 1],
        [3] * 100 + [total - 300],
        [total // 8 + 1] * 7 + [total - 7 * (total // 8 + 1)],
    ]
    for S in (128, 20000):
        L = len(tables)
        dist = np.zeros((L, S), np.int32)
        for i, t in enumerate(tables):
            dist[i, :len(t)] = t
        cums = np.cumsum(dist, axis=1, dtype=np.int64) - dist
        syms = np.stack([rng.choice(len(t), size=n, p=np.asarray(t) / total)
                         if i % 2 else rng.integers(0, len(t), size=n)
                         for i, t in enumerate(tables)]).astype(np.int32)
        args = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (
            syms, dist, cums, np.full(L, prec), np.full(L, n))]
        words, meta = trl.rans_words_scan(*args)
        torch.cuda.synchronize()
        ref_w, ref_m = trl.rans_words_scan_ref(*args)
        assert torch.equal(meta, ref_m) and torch.equal(words, ref_w)


def test_slice_on_cuda_matches_host(cuda):
    pos, faces = torchdraco.make_mesh_batch(20, 12, seed=5)
    meshes = torchdraco.build_meshes(pos, faces)
    blobs = tbatch.BatchEncoder().encode_meshes_device(meshes, device=cuda)
    assert blobs == [encode(m) for m in meshes]


@pytest.mark.parametrize("prec", (12, 20))
def test_rans_dense_kernel_matches_twin(cuda, prec):
    """Random (freq, cum) pairs, frequency 0 on some active steps, ragged
    and out-of-range lengths."""
    rng = np.random.default_rng(prec)
    L, T = 96, 700
    fs = rng.integers(0, 1 << prec, size=(L, T)) // rng.integers(
        1, 300, size=(L, T))
    fs[:, ::17] = 0
    cs = rng.integers(0, 1 << prec, size=(L, T))
    ln = rng.integers(-3, T + 5, size=L)
    args = [torch.from_numpy(a).to(cuda) for a in (fs, cs, ln)]
    n0 = trl.rans_scan_dense.n_launches
    got = trl.rans_scan_dense(*args, prec)
    torch.cuda.synchronize()
    assert trl.rans_scan_dense.n_launches == n0 + 1
    for g, w in zip(got, trl.rans_scan_dense_ref(*args, prec)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("prec", (12, 20))
@pytest.mark.parametrize("T,dtype", [(720, torch.int32), (701, torch.int64),
                                     (200, torch.int32)])
def test_rans_dense_kernel_on_valid_tables(cuda, prec, T, dtype):
    """Valid per-lane tables, where no step leaves the reciprocal: ragged,
    zero and out-of-range lengths, at T no multiple of the kernel's tile of
    256 (720: rows stored as 32-bit words; 701: as bytes; 200: under one
    tile), int32 and int64 inputs."""
    rng = np.random.default_rng(prec + T)
    L, S = 70, 300
    syms = rng.integers(0, 40, size=(L, T)) ** 2 % S
    syms[3] = rng.integers(0, S, size=T)
    counts = np.stack([np.bincount(r, minlength=S) for r in syms])
    dist, _ = normalize_freq_counts_batch(counts, np.full(L, prec))
    cums = np.zeros_like(dist)
    cums[:, 1:] = np.cumsum(dist[:, :-1], axis=1)
    ln = rng.integers(-3, T + 5, size=L)
    ln[0], ln[1], ln[2] = T, 0, T + 9
    fs, cs = trl.lane_tables_gather(*(torch.from_numpy(a).to(cuda) for a in (
        syms, dist, cums)), dtype=dtype)
    ln = torch.from_numpy(ln).to(cuda)
    guard = torch.full((L,), -1, dtype=torch.int32, device=cuda)
    got = trl.rans_scan_dense(fs, cs, ln, prec, guard_steps=guard)
    torch.cuda.synchronize()
    for g, w in zip(got, trl.rans_scan_dense_ref(fs, cs, ln, prec)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert guard.tolist() == [0] * L


@pytest.mark.parametrize("prec", (12, 20))
def test_rans_dense_guard_steps_match_twin(cuda, prec):
    """Any uint32 (freq, cum): frequencies of 0, past 2^21 and of bit
    length 21, states that leave the coder's range. The kernel takes its
    exact path on the steps the twin counts, and equals it."""
    rng = np.random.default_rng(prec)
    L, T = 64, 500
    fs = rng.integers(0, 1 << 32, size=(L, T)) >> rng.integers(
        0, 32, size=(L, T))
    fs[:, ::11] = rng.integers(1 << 20, 1 << 21, size=fs[:, ::11].shape)
    cs = rng.integers(0, 1 << 32, size=(L, T))
    ln = rng.integers(0, T + 1, size=L)
    args = [torch.from_numpy(a).to(cuda) for a in (fs, cs, ln)]
    guard = torch.full((L,), -1, dtype=torch.int32, device=cuda)
    want_guard = torch.empty_like(guard)
    got = trl.rans_scan_dense(*args, prec, guard_steps=guard)
    torch.cuda.synchronize()
    want = trl.rans_scan_dense_ref(*args, prec, guard_steps=want_guard)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(guard, want_guard) and int(guard.sum()) > 0


@pytest.mark.parametrize("C", (1, 2, 3))
@pytest.mark.parametrize("dtype", (torch.uint16, torch.int32))
@pytest.mark.parametrize("B,V,T", [(9, 300, 517), (5, 4096, 4096),
                                   (3, 50000, 900)])
def test_predict_residual_kernel_shapes(cuda, C, dtype, B, V, T):
    """K1 on random gathers: C = 1..3, uint16 and int32 q, T != V, rows
    that are not 16-byte aligned, and a V past the shared-memory budget
    (the tiled kernel, chosen by the shape, with tables built for the
    call)."""
    past_budget = not tdev.predict_fits_smem(
        V, C, 2 if dtype == torch.uint16 else 4)
    assert past_budget == (V == 50000 and (C > 1 or dtype == torch.int32))
    rng = np.random.default_rng(B * C + T)
    q = rng.integers(0, 1 << 14, size=(B, V, C))
    g = {k: torch.from_numpy(rng.integers(0, V, size=T).astype(np.int32))
         .to(cuda) for k in ("order", "next", "prev", "opp", "fallback")}
    g["can_para"] = torch.from_numpy(rng.random(T) < 0.7).to(cuda)
    g["has_fallback"] = torch.from_numpy(rng.random(T) < 0.6).to(cuda)
    vmin = torch.from_numpy(q.min(axis=(1, 2)).astype(np.int32)).to(cuda)
    vmax = torch.from_numpy(q.max(axis=(1, 2)).astype(np.int32)).to(cuda)
    qt = torch.from_numpy(q.astype(
        np.uint16 if dtype == torch.uint16 else np.int32)).to(cuda)
    got = tdev.predict_residual(qt, g, vmin, vmax)
    torch.cuda.synchronize()
    assert torch.equal(got, tdev.predict_residual_ref(qt, g, vmin, vmax))


@pytest.mark.parametrize("layout", ("u8", "pack12"))
@pytest.mark.parametrize("V,C", [(49, 3), (37, 5), (45001, 3)])
def test_predict_residual_narrow_layouts(cuda, layout, V, C):
    """K1 reading uint8 (8 bits) and the 12-bit pack (12 bits) at B = 3
    with an odd V * C, so that the rows of meshes 1 and 2 start unaligned:
    the shared-memory kernel at 49 x 3, the direct-gather kernel at C = 5
    and the tiled kernel past the shared-memory budget. Equal to the twin
    on the int32 values, and counted under its layout."""
    bits = 8 if layout == "u8" else 12
    assert tdev.predict_fits_smem(V, C, 1 if layout == "u8" else 2) == (
        V == 49)
    rng = np.random.default_rng(V * C)
    q = rng.integers(0, 1 << bits, size=(3, V, C)).astype(np.uint16)
    T = V + 17
    g = {k: torch.from_numpy(rng.integers(0, V, size=T).astype(np.int32))
         .to(cuda) for k in ("order", "next", "prev", "opp", "fallback")}
    g["can_para"] = torch.from_numpy(rng.random(T) < 0.7).to(cuda)
    g["has_fallback"] = torch.from_numpy(rng.random(T) < 0.6).to(cuda)
    vmin = torch.from_numpy(q.min(axis=(1, 2)).astype(np.int32)).to(cuda)
    vmax = torch.from_numpy(q.max(axis=(1, 2)).astype(np.int32)).to(cuda)
    if layout == "u8":
        up = torch.from_numpy(q.astype(np.uint8)).to(cuda)
    else:
        up = tuple(torch.from_numpy(a).to(cuda)
                   for a in torchdraco.native.pack12(q))
    n0 = tdev.predict_residual.n_launches_by_layout[layout]
    got = tdev.predict_residual(up, g, vmin, vmax)
    torch.cuda.synchronize()
    assert tdev.predict_residual.n_launches_by_layout[layout] == n0 + 1
    want = tdev.predict_residual_ref(
        torch.from_numpy(q.astype(np.int32)).to(cuda), g, vmin, vmax)
    assert torch.equal(got, want)
    assert torch.equal(tdev.predict_residual_ref(up, g, vmin, vmax), want)


def _lanes(rng, L, T, prec, alphabet, per_lane):
    counts = rng.integers(0, T + 1, size=L)
    counts[0], counts[1] = T, 0
    syms = rng.integers(0, alphabet, size=(L, T)) ** 2 % alphabet
    tables = np.stack([np.bincount(r, minlength=alphabet) + (not per_lane)
                       for r in (syms if per_lane else syms[:1])])
    dist, _ = normalize_freq_counts_batch(
        tables, np.full(len(tables), prec))
    cums = np.zeros_like(dist)
    cums[:, 1:] = np.cumsum(dist[:, :-1], axis=1)
    if not per_lane:
        dist, cums = dist[0], cums[0]
    return syms.astype(np.int32), dist, cums, counts


@pytest.mark.parametrize("prec,alphabet,per_lane", [
    (12, 200, True), (12, 3000, True), (20, 3000, True), (20, 30000, False),
    (20, 60000, False)])
def test_rans_decode_kernel_matches_twin(cuda, prec, alphabet, per_lane):
    """Both engines encode on the card; D1 equals its twin and gives the
    lanes back, through the packed dtypes (P=12: uint8 and uint16) and the
    generic ones, with the cumulative row in shared memory and (alphabet
    60000) in global memory. The per-lane tables have symbols of frequency
    0 in the middle and at the end of the alphabet (x^2 mod alphabet skips
    most values)."""
    rng = np.random.default_rng(prec + alphabet)
    syms, dist, cums, counts = _lanes(rng, 64, 600, prec, alphabet,
                                      per_lane)
    if per_lane:
        assert (dist[:, 1:-1] == 0).any() and (dist[:, -1] == 0).any()
    args = (torch.from_numpy(syms).to(cuda), dist, cums, counts)
    bufs, nbytes = trl.rans_encode_lanes(*args, precision=prec, dense=True)
    bufs_w, nbytes_w = trl.rans_encode_lanes(*args, precision=prec)
    assert np.array_equal(bufs, bufs_w) and np.array_equal(nbytes, nbytes_w)
    dev_args = (torch.from_numpy(bufs).to(cuda), nbytes, dist, counts)
    n0 = trl.rans_decode_lanes.n_launches
    got = trl.rans_decode_lanes(*dev_args, precision=prec)
    torch.cuda.synchronize()
    assert trl.rans_decode_lanes.n_launches == n0 + 1
    want = trl.rans_decode_lanes_ref(*dev_args, precision=prec)
    assert got.dtype == want.dtype and torch.equal(got, want)
    got = got.cpu().numpy()
    for i, n in enumerate(counts):
        assert np.array_equal(got[i, :n].astype(np.int64), syms[i, :n][::-1])


def test_shared_topology_decode_on_cuda(cuda):
    pos, faces = torchdraco.make_mesh_batch(20, 12, seed=6)
    meshes = torchdraco.build_meshes(pos, faces)
    blobs = tbatch.BatchEncoder().encode_meshes_device(meshes, device=cuda)
    bd = BatchDecoder()
    n0 = trl.rans_decode_lanes.n_launches
    out = bd.decode_blobs_shared_topology(blobs, entropy="device",
                                          device=cuda)
    assert bd.n_host_blobs == 0 and trl.rans_decode_lanes.n_launches > n0
    for blob, got in zip(blobs, out):
        ref = decode(blob)
        assert np.array_equal(got.faces, ref.faces)
        assert np.array_equal(got.attributes[0].values,
                              ref.attributes[0].values)


def test_rans_decode_refuses_unnormalized_table_on_cuda(cuda):
    """A table that does not sum to 2^P has remainders without a symbol:
    the wrapper refuses it before any launch."""
    dist = np.array([1000, 2000, 1000])          # 4000 != 4096
    bufs = torch.zeros((1, 8), dtype=torch.uint8, device=cuda)
    n0 = trl.rans_decode_lanes.n_launches
    with pytest.raises(ValueError, match="not a normalized rANS table"):
        trl.rans_decode_lanes(bufs, np.array([4]), dist, np.array([3]))
    assert trl.rans_decode_lanes.n_launches == n0


def _chain_group(n, batch, seed, qp, spread=1.0):
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed)
    pos = (pos * np.float32(spread)).astype(np.float32)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    topo = tbatch.PreparedTopology(meshes[0])
    q_pos = tbatch.quantize_positions_host(pos, qp)[0]
    return meshes, topo, q_pos, nrm, uvs


def test_card_float32_ops_are_correctly_rounded(cuda):
    """``/``, ``*`` then ``+`` and ``sqrt`` on the card against numpy,
    bit for bit: what lets the chains use them as they are."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(1 << 20)
         * 2.0 ** rng.integers(-30, 31, 1 << 20)).astype(np.float32)
    b = (rng.standard_normal(1 << 20)
         * 2.0 ** rng.integers(-30, 31, 1 << 20)).astype(np.float32)
    b[b == 0] = 1
    c = np.roll(a, 3)
    ta, tb, tc = (torch.from_numpy(x).to(cuda) for x in (a, b, c))

    def same(got, want):
        return np.array_equal(got.cpu().numpy().view(np.int32),
                              want.view(np.int32))
    assert same(ta / tb, a / b)
    assert same((ta * tb) + tc, (a * b) + c)
    assert same(torch.sqrt(ta.abs()), np.sqrt(np.abs(a)))
    assert same(tnormals._f32_sqrt(ta.abs()), np.sqrt(np.abs(a)))


@pytest.mark.parametrize("qp,qn,spread", ((11, 8, 1.0), (18, 16, 1e4)))
def test_normal_chains_on_the_card_equal_the_cpu(cuda, qp, qn, spread):
    meshes, topo, q_pos, nrm, _ = _chain_group(24, 8, qn, qp, spread)
    m0 = meshes[0]
    uo_pos = m0.position_attribute().unique_indices().astype(np.int64)
    uo_nrm = m0.attributes[1].unique_indices().astype(np.int64)
    keys = ("tip_pt", "next_pt", "prev_pt", "mask")
    out = {}
    for where in (cuda, torch.device("cpu")):
        r = tnormals.rings_to_torch(topo.rings_for(1), where)
        ri = tnormals.rings_to_torch(topo.rings_for(1), where, rows=uo_pos)
        q = torch.from_numpy(q_pos).to(where)
        sym, flips = tnormals.normal_encode_chain(
            q, torch.from_numpy(nrm).to(where), *(r[k] for k in keys),
            torch.from_numpy(uo_pos).to(where),
            torch.from_numpy(uo_nrm).to(where), bits=qn)
        back = tnormals.normal_decode_chain(q, sym, flips,
                                            *(ri[k] for k in keys), bits=qn)
        assert sym.device.type == where.type
        out[where.type] = [t.cpu() for t in (sym, flips, back)]
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"], out["cpu"]))


@pytest.mark.parametrize("qp,qt,spread", ((11, 10, 1.0), (18, 16, 1e4)))
def test_uv_chain_on_the_card_equals_the_cpu(cuda, qp, qt, spread):
    meshes, topo, q_pos, _, uvs = _chain_group(24, 8, qt, qp, spread)
    m0 = meshes[0]
    q_uv = tbatch.quantize_positions_host(uvs, qt)[0]
    g = topo.uv_gathers_for(2, m0.position_attribute().num_points)
    args = (q_pos, q_uv, g, m0.position_attribute().unique_indices(),
            m0.attributes[2].unique_indices())
    got = ttex.uv_encode_chain(*args)  # no device: the card
    want = ttex.uv_encode_chain(*args, device="cpu")
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want))


def test_default_attribute_set_round_trip_on_the_card(cuda):
    """encode_meshes_device and the phased decode, without ``device``,
    over pos+normal+UV meshes: encode()'s bytes, decode()'s meshes."""
    meshes, _, _, _, _ = _chain_group(16, 20, 5, 11)
    enc = tbatch.BatchEncoder()
    blobs = enc.encode_meshes_device(meshes)
    assert blobs == [encode(m) for m in meshes]
    assert enc.n_host_attributes == 0
    bd = BatchDecoder()
    out = bd.decode_blobs_shared_topology(blobs, entropy="device",
                                          normals="device")
    assert bd.n_host_blobs == 0 and "normals_s" in bd.timings
    for got, blob in zip(out, blobs):
        ref = decode(blob)
        assert all(np.array_equal(a.values, b.values)
                   for a, b in zip(got.attributes, ref.attributes))


@pytest.mark.parametrize("B,N,bins", [(1, 3 * (1 << 20), 4096),
                                      (1, 98_304, 4096),
                                      (3, 1_000_003, 4096),
                                      (1, 3 * (1 << 20), 1 << 17),
                                      (2, 777_777, 1 << 17)])
def test_histogram_long_rows_match_twin(cuda, B, N, bins):
    """K2 with a row spread over several blocks (the single-mesh routes'
    shapes, odd tails, and bins past shared memory) equals its twin."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tdev.histogram_splits(B, N, bins, sms) > 1
    rng = np.random.default_rng(N)
    # residual-like symbols: most near zero, some out of range
    sym = np.abs(rng.laplace(0, 3, size=(B, N))).astype(np.int32) * 2
    sym[:, ::97] = rng.integers(-5, bins + 5, size=sym[:, ::97].shape)
    sym = torch.from_numpy(sym).to(cuda)
    n0 = tdev.histogram.n_launches
    got = tdev.histogram(sym, bins)
    torch.cuda.synchronize()
    assert tdev.histogram.n_launches == n0 + 1
    assert torch.equal(got, tdev.bincount_kernel(sym, bins))


@pytest.mark.parametrize("bins", [4096, 1 << 17])
def test_histogram_empty_batch(cuda, bins):
    """K2 on a (0, N) batch returns an empty (0, bins) result and launches
    nothing."""
    n0 = tdev.histogram.n_launches
    got = tdev.histogram(torch.zeros((0, 1000), dtype=torch.int32,
                                     device=cuda), bins)
    assert got.shape == (0, bins) and got.dtype == torch.int32
    assert tdev.histogram.n_launches == n0


def test_single_mesh_routes_on_the_card(cuda):
    """encode_mesh_device (one K1 and one K2 launch, positions, normals
    and UVs on the card) and encode_mesh_device_chunked on a 256 x 256
    grid give encode()'s bytes."""
    pos, faces = torchdraco.make_mesh_batch(1, 256, seed=2)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, 256, 3)
    m3 = torchdraco.build_meshes(pos, faces, nrm, uvs)[0]
    m1 = torchdraco.build_meshes(pos, faces)[0]
    enc = tbatch.BatchEncoder()
    k1, k2 = tdev.predict_residual.n_launches, tdev.histogram.n_launches
    assert enc.encode_mesh_device(m3) == encode(m3)
    assert (tdev.predict_residual.n_launches - k1,
            tdev.histogram.n_launches - k2) == (1, 1)
    assert enc.n_host_attributes == 0
    assert enc.encode_mesh_device_chunked(m1, chunk=1 << 13) == encode(m1)
    assert enc.encode_mesh_device(m1) == encode(m1)


@pytest.mark.parametrize("entropy", ("device", "host"))
def test_sharded_group_encode_on_the_card(cuda, entropy):
    """Two shards on one card: 7 meshes with normals and UVs split 4 + 3,
    K1, K2 (and K3 with entropy="device") launched once a shard, the
    joined step and the blobs equal to the unsharded ones."""
    axis = ["cuda:0"] * 2
    pos, faces = torchdraco.make_mesh_batch(7, 12, seed=4)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, 12, 5)
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    topo = tbatch.PreparedTopology(meshes[0])
    att = meshes[0].position_attribute()
    whole = tbatch.device_encode_group(pos, topo, att, device=cuda)
    got = tbatch.device_encode_group(pos, topo, att, mesh_axis=axis)
    for k in ("symbols", "counts"):
        assert torch.equal(torch.cat(got[k]), whole[k][0])
    assert torch.equal(torch.cat([tdev.widen(q) for q in got["q_dev"]]),
                       tdev.widen(whole["q_dev"][0]))
    want = tbatch.BatchEncoder().encode_meshes_device(meshes, entropy=entropy)
    counted = (tdev.predict_residual, tdev.histogram, trl.rans_words_scan)
    before = [fn.n_launches for fn in counted]
    enc = tbatch.BatchEncoder(mesh_axis=axis)
    assert enc.encode_meshes_device(meshes, entropy=entropy) == want
    assert enc.n_host_attributes == 0
    assert [fn.n_launches - n for fn, n in zip(counted, before)] == [
        2, 2, 2 if entropy == "device" else 0]


def test_shards_on_distinct_cards(cuda):
    """An axis of two distinct cards: every wrapper launches on its
    tensor's card, so the sharded bytes equal encode()'s with both
    coders, the dry run's oracles hold, and D1 decodes on the second
    card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (torch.cuda.device_count() < 2)")
    axis = ["cuda:0", "cuda:1"]
    torchdraco.dryrun_multichip(2)
    pos, faces = torchdraco.make_mesh_batch(5, 12, seed=8)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, 12, 9)
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    want = [encode(m) for m in meshes]
    for entropy in ("device", "host"):
        assert tbatch.BatchEncoder(mesh_axis=axis).encode_meshes_device(
            meshes, entropy=entropy) == want
    out = BatchDecoder().decode_blobs_shared_topology(
        want, entropy="device", device="cuda:1")
    for blob, got in zip(want, out):
        assert np.array_equal(got.attributes[0].values,
                              decode(blob).attributes[0].values)


def test_stream_sharded_mesh_on_the_card(cuda):
    """A 257 x 257 grid over two stream shards on one card: the segments'
    symbols and summed counts equal the unsharded step's, and the blob
    equals encode()."""
    axis = ["cuda:0"] * 2
    pos, faces = torchdraco.make_mesh_batch(1, 257, seed=6)
    mesh = torchdraco.build_meshes(pos, faces)[0]
    enc = tbatch.BatchEncoder()
    assert enc.encode_mesh_device_stream_sharded(mesh, axis) == encode(mesh)
    _, topo = enc._topo_for(mesh)
    att = mesh.position_attribute()
    whole = tbatch.device_encode_group(pos, topo, att, device=cuda)
    parts, counts = tdev.encode_step_stream_sharded(
        whole["q"], tbatch._device_gathers(topo, att, cuda, att.num_points),
        whole["vmin"], whole["vmax"], bits=11, mesh_axis=axis)
    assert torch.equal(torch.cat(parts, dim=1), whole["symbols"][0])
    assert torch.equal(counts, whole["counts"][0])


def _upload(q: np.ndarray, layout: str, dev):
    if layout == "u8":
        return torch.from_numpy(q.astype(np.uint8)).to(dev)
    if layout == "pack12":
        return tuple(torch.from_numpy(a).to(dev)
                     for a in torchdraco.native.pack12(q))
    return torch.from_numpy(q.astype(np.uint16 if layout == "u16"
                                     else np.int32)).to(dev)


@pytest.mark.parametrize("layout", ("u8", "pack12", "u16", "i32"))
@pytest.mark.parametrize("C", (1, 2, 3, 4))
@pytest.mark.parametrize("B,V,T", [(3, 50000, 900), (2, 45001, 45018),
                                   (1, 120001, 9000)])
def test_tiled_predict_kernel_shapes(cuda, layout, C, B, V, T):
    """K1's tiled kernel on random gathers past the shared-memory budget
    in every layout and C = 1..4 (odd V * C: rows that start unaligned),
    with tables built for the call and with tables of tile 32 and 4096
    (where they fit): equal to the plain version, counted under its form
    and layout."""
    itemsize = {"u8": 1, "pack12": 2, "u16": 2, "i32": 4}[layout]
    if tdev.predict_form(V, C, itemsize) != "tiled":
        pytest.skip("the rows kernel takes this shape: "
                    "test_predict_residual_kernel_shapes holds it")
    rng = np.random.default_rng(B * V + C)
    q = rng.integers(0, 1 << (8 if layout == "u8" else 12),
                     size=(B, V, C)).astype(np.uint16)
    g = {k: torch.from_numpy(rng.integers(0, V, size=T).astype(np.int32))
         .to(cuda) for k in ("order", "next", "prev", "opp", "fallback")}
    g["can_para"] = torch.from_numpy(rng.random(T) < 0.7).to(cuda)
    g["has_fallback"] = torch.from_numpy(rng.random(T) < 0.6).to(cuda)
    vmin = torch.from_numpy(q.min(axis=(1, 2)).astype(np.int32)).to(cuda)
    vmax = torch.from_numpy(q.max(axis=(1, 2)).astype(np.int32)).to(cuda)
    up = _upload(q, layout, cuda)
    want = tdev.predict_residual_ref(up, g, vmin, vmax)
    forms = dict(tdev.predict_residual.n_launches_by_form)
    n0 = tdev.predict_residual.n_launches_by_layout[layout]
    got = tdev.predict_residual(up, g, vmin, vmax)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tdev.predict_residual.n_launches_by_form["tiled"] == \
        forms["tiled"] + 1
    assert tdev.predict_residual.n_launches_by_layout[layout] == n0 + 1
    for tile in (32, 4096):
        tiles = tdev.predict_tiles(g, tile)
        if tdev._tiled_smem_bytes(tiles, C, itemsize) \
                > tdev.SMEM_MAX_BYTES:
            with pytest.raises(ValueError):
                tdev.predict_residual(up, g, vmin, vmax, tiles)
            continue
        assert torch.equal(tdev.predict_residual(up, g, vmin, vmax, tiles),
                           want), tile


@pytest.mark.parametrize("layout,bits", (("u8", 8), ("pack12", 11),
                                         ("u16", 15), ("i32", 18)))
@pytest.mark.parametrize("n,batch", ((140, 4), (256, 2)))
def test_tiled_predict_kernel_on_grids(cuda, layout, bits, n, batch):
    """The tiled kernel on grid traversals at the batch path's depths,
    with the topology's cached tables, against the plain version."""
    positions, faces = torchdraco.make_mesh_batch(batch, n, bits)
    mesh0 = torchdraco.build_meshes(positions[:1], faces)[0]
    topo = tbatch.PreparedTopology(mesh0)
    att = mesh0.position_attribute()
    g = tbatch._device_gathers(topo, att, cuda, n * n)
    q, _, _, vmin, vmax = torchdraco.native.quantize_batch(positions, bits) \
        if bits <= 16 else (None,) * 5
    if q is None:
        q, _, _ = tbatch.quantize_positions_host(positions, bits)
        vmin, vmax = q.min(axis=(1, 2)), q.max(axis=(1, 2))
    up = _upload(q, layout, cuda)
    lo = torch.from_numpy(np.asarray(vmin, np.int32)).to(cuda)
    hi = torch.from_numpy(np.asarray(vmax, np.int32)).to(cuda)
    got = tdev.predict_residual(up, g, lo, hi, functools.partial(
        tbatch._device_tiles, topo, att, cuda, n * n))
    torch.cuda.synchronize()
    assert torch.equal(got, tdev.predict_residual_ref(up, g, lo, hi))
    assert list(topo.dev_tiles) == [(str(cuda), None)]


def test_predict_form_is_chosen_from_the_shape(cuda):
    """The wrapper launches the rows kernel while ``predict_fits_smem``,
    the tiled kernel past it for C of 1 to 4 and the direct gather only
    for C > 4, counted by form; it asks a caller's function for the tile
    tables only where it takes the tiled kernel."""
    rng = np.random.default_rng(7)
    for V, C, form in ((4096, 3, "rows"), (18040, 3, "tiled"),
                       (300, 5, "gather"), (30000, 5, "gather")):
        assert tdev.predict_form(V, C, 2) == form
        q = torch.from_numpy(rng.integers(0, 4096, size=(2, V, C))
                             .astype(np.uint16)).to(cuda)
        T = 1000
        g = {k: torch.from_numpy(rng.integers(0, V, size=T)
                                 .astype(np.int32)).to(cuda)
             for k in ("order", "next", "prev", "opp", "fallback")}
        g["can_para"] = torch.from_numpy(rng.random(T) < 0.7).to(cuda)
        g["has_fallback"] = torch.from_numpy(rng.random(T) < 0.6).to(cuda)
        lo = torch.zeros(2, dtype=torch.int32, device=cuda)
        hi = torch.full((2,), 4095, dtype=torch.int32, device=cuda)
        before = dict(tdev.predict_residual.n_launches_by_form)
        asked = []
        got = tdev.predict_residual(
            q, g, lo, hi, lambda: asked.append(1) or tdev.predict_tiles(g))
        torch.cuda.synchronize()
        after = tdev.predict_residual.n_launches_by_form
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == form) for k in after}
        assert len(asked) == int(form == "tiled")
        assert torch.equal(got, tdev.predict_residual_ref(q, g, lo, hi))


@pytest.mark.parametrize("kind", ("clustered", "uniform"))
@pytest.mark.parametrize("B,N,bins", [(512, 12288, 1 << 16),
                                      (32, 196608, 1 << 17),
                                      (1, 3 * (1 << 20), 1 << 17),
                                      (3, 100_003, 1 << 16)])
def test_wide_histogram_form_matches_twin(cuda, kind, B, N, bins):
    """K2 past the shared-memory bins in its wide form (shared bins and
    global atomics for the rest), on one block a row and on split rows,
    with residual-like and uniform symbols and some out of range: equal
    to its twin, counted under its form."""
    rng = np.random.default_rng(B + N)
    if kind == "clustered":
        sym = np.abs(rng.laplace(0, 40, size=(B, N))).astype(np.int32) * 2
        sym[:, ::211] = rng.integers(-5, bins + 5, size=sym[:, ::211].shape)
    else:
        sym = rng.integers(-9, bins + 9, size=(B, N), dtype=np.int32)
    sym = torch.from_numpy(sym).to(cuda)
    n0 = tdev.histogram.n_launches_by_form["wide"]
    got = tdev.histogram(sym, bins)
    torch.cuda.synchronize()
    assert tdev.histogram.n_launches_by_form["wide"] == n0 + 1
    assert torch.equal(got, tdev.bincount_kernel(sym, bins))

"""torchdraco's fused-step twins against tpudraco's JAX functions.

Same inputs, made from a seed with numpy, go through both packages; the
tolerance is 0 everywhere (Draco is bit-exact). The Pallas step runs in
interpret mode on the CPU, as tests/test_pallas_kernels.py runs it."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.ops import device as tdev  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from tpudraco.ops import device as jdev  # noqa: E402
from tpudraco.ops.pallas_kernels import build_combined_matrix  # noqa: E402

BITS = (11, 14, 16)


def _case(n: int, bits: int, batch: int = 3, seed: int = 0):
    """(q int32 (B, V, 3), numpy gathers, torch gathers) of an n x n grid
    batch quantized at ``bits`` on the host."""
    positions, faces = torchdraco.make_mesh_batch(batch, n, seed)
    mesh0 = torchdraco.build_meshes(positions[:1], faces)[0]
    topo = tbatch.PreparedTopology(mesh0)
    g_np = tbatch.topology_gathers_np(topo, mesh0.position_attribute())
    q, _, _ = tbatch.quantize_positions_host(positions, bits)
    return q, g_np, tbatch.gathers_to_torch(g_np, "cpu")


def test_zigzag_matches_jax():
    v = np.random.default_rng(0).integers(-(1 << 20), 1 << 20, 5000,
                                          dtype=np.int32)
    want = np.asarray(jdev.zigzag_kernel(jnp.asarray(v))).astype(np.int64)
    got = tdev.zigzag_kernel(torch.from_numpy(v)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_parallelogram_and_wrapped_difference_match_jax(bits):
    q, g_np, g = _case(9, bits, seed=bits)
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    qt = torch.from_numpy(q)
    want_p = np.asarray(jdev.parallelogram_predict_kernel(
        jnp.asarray(q), jg["next"], jg["prev"], jg["opp"], jg["fallback"],
        jg["can_para"], jg["has_fallback"]))
    got_p = tdev.parallelogram_predict_kernel(
        qt, g["next"], g["prev"], g["opp"], g["fallback"], g["can_para"],
        g["has_fallback"])
    assert np.array_equal(got_p.numpy(), want_p)
    trav = q[:, g_np["order"]]
    for src in (None, q):
        want = jdev.wrapped_difference_kernel(
            jnp.asarray(trav), jnp.asarray(want_p),
            range_source=None if src is None else jnp.asarray(src))
        got = tdev.wrapped_difference_kernel(
            torch.from_numpy(trav), got_p,
            range_source=None if src is None else torch.from_numpy(src))
        for w, t in zip(want, got):
            assert np.array_equal(t.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("bits", BITS)
def test_bincount_drops_out_of_range_like_jax(bits):
    """Symbols >= bins are dropped as by JAX's bincount_kernel. Negative
    symbols are dropped as by histogram_pallas: JAX's scatter wraps a
    negative index before mode="drop" applies, so bincount_kernel would
    count -1 in the last bin (zigzag symbols are never negative)."""
    from tpudraco.ops.pallas_kernels import histogram_pallas

    bins = tdev.default_hist_bins(bits)
    assert bins == jdev.default_hist_bins(bits)
    rng = np.random.default_rng(bits)
    sym = rng.integers(0, bins + 50, size=(4, 3000), dtype=np.int32)
    want = np.asarray(jdev.bincount_kernel(jnp.asarray(sym), bins))
    got = tdev.bincount_kernel(torch.from_numpy(sym), bins).numpy()
    assert np.array_equal(got, want)
    assert got.sum() < sym.size  # some were dropped, none clamped
    neg = np.asarray([[-3, 0, 0, 5, bins + 7, bins - 1, -1, bins]],
                     dtype=np.int32)
    want = np.asarray(histogram_pallas(jnp.asarray(neg), bins))
    got = tdev.bincount_kernel(torch.from_numpy(neg), bins).numpy()
    assert np.array_equal(got, want) and got.sum() == 4


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", (8, 10))
def test_encode_step_from_q_matches_jax(bits, n):
    q, g_np, g = _case(n, bits, seed=n + bits)
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    want = jdev.encode_step_from_q(jnp.asarray(q), jg, bits=bits)
    got = tdev.encode_step_from_q(torch.from_numpy(q), g, bits=bits)
    for k in ("symbols", "counts", "vmin", "vmax"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(want[k]).astype(np.int64)), k


@pytest.mark.parametrize("bits", (11, 14))
def test_fused_step_matches_pallas_step(bits):
    """The port's K1+K2 step (on CPU: its twins) against the JAX package's
    Pallas step with the combined matrix, run in interpret mode."""
    q, g_np, g = _case(9, bits, seed=bits)
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    M = jnp.asarray(build_combined_matrix(g_np, q.shape[1]))
    want = jdev.encode_step_pallas_from_q(jnp.asarray(q), jg, M, bits=bits)
    qt = torch.from_numpy(q.astype(np.uint16))
    vmin = torch.from_numpy(q.min(axis=(1, 2)))
    vmax = torch.from_numpy(q.max(axis=(1, 2)))
    syms, counts = tdev.encode_step_from_q_cuda(qt, g, vmin, vmax, bits=bits)
    assert np.array_equal(syms.numpy(),
                          np.asarray(want["symbols"]).astype(np.int64))
    assert np.array_equal(counts.numpy(), np.asarray(want["counts"]))


def test_fused_step_at_16_bits_matches_jax():
    """Past the Pallas step's 14-bit cap the port still runs: it gathers."""
    q, g_np, g = _case(10, 16, seed=4)
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    want = jdev.encode_step_from_q(jnp.asarray(q), jg, bits=16)
    syms, counts = tdev.encode_step_from_q_cuda(
        torch.from_numpy(q.astype(np.uint16)), g,
        torch.from_numpy(q.min(axis=(1, 2))),
        torch.from_numpy(q.max(axis=(1, 2))), bits=16)
    assert np.array_equal(syms.numpy(),
                          np.asarray(want["symbols"]).astype(np.int64))
    assert np.array_equal(counts.numpy(), np.asarray(want["counts"]))


def test_wrappers_take_the_twin_only_for_cpu_tensors():
    """On the CPU a wrapper runs its plain version and counts no launch."""
    q, _, g = _case(8, 11)
    before = (tdev.predict_residual.n_launches, tdev.histogram.n_launches)
    qt = torch.from_numpy(q)
    vmin = torch.from_numpy(q.min(axis=(1, 2)))
    vmax = torch.from_numpy(q.max(axis=(1, 2)))
    syms = tdev.predict_residual(qt, g, vmin, vmax)
    assert torch.equal(syms, tdev.predict_residual_ref(qt, g, vmin, vmax))
    tdev.histogram(syms.view(syms.shape[0], -1), 4096)
    assert (tdev.predict_residual.n_launches,
            tdev.histogram.n_launches) == before
    with pytest.raises(ValueError):
        tdev.predict_residual(qt.to("meta"), g, vmin, vmax)


def test_predict_kernel_is_chosen_from_the_shape():
    """K1's wrapper picks its kernel from (V, C, itemsize) alone: the
    shared-memory kernel while the mesh's skewed q row and the staging
    tile fit the budget, the tiled kernel past it (``predict_form``; the
    direct gather for C > 4)."""
    cap = tdev.PREDICT_SMEM_MAX_BYTES
    assert tdev.predict_fits_smem(4096, 3, 2)
    assert tdev.predict_fits_smem(4096, 3, 4)
    for V, C, size in ((4096, 3, 2), (9000, 3, 4), (9200, 3, 4), (37, 1, 2),
                       (18000, 3, 2), (18500, 3, 2), (cap // 2, 1, 2),
                       (1 << 20, 3, 2)):
        stage = 8 * 32 * C * 4
        words = -(-V * C * size // 4)
        row = (words + words // 32) * 4  # one word of padding every 32
        if tdev.predict_fits_smem(V, C, size):
            assert row + stage <= cap
        else:  # at most 16 bytes of rounding and 4 of slack
            assert row + 20 + stage > cap
    assert not tdev.predict_fits_smem(1 << 20, 3, 2)
    assert not tdev.predict_fits_smem(cap // 2, 1, 2)  # no room: the skew
    assert tdev.predict_fits_smem(9000, 3, 4)
    assert not tdev.predict_fits_smem(9200, 3, 4)
    assert tdev.predict_fits_smem(100, 4, 4)
    assert not tdev.predict_fits_smem(100, 5, 4)  # C past the unrolled 1-4


@pytest.mark.parametrize("n", (33, 48, 64, 100))
def test_predict_rows_skew_spreads_gathers_over_banks(n):
    """Why K1 skews a mesh's q row in shared memory (one 32-bit word of
    padding after every 32, csrc/predict_residual.cu ``skewed``). Counted
    from the traversal of an n x n grid, for the 32 steps a warp gathers
    at once: the lanes that fall on the busiest of the 32 banks, averaged
    over the warps. Flat rows of three uint16 put about 11 lanes on one
    bank on the 64-wide grid (64 vertices are 96 words, a multiple of 32);
    skewed rows stay near 3 at every width."""
    pos, faces = torchdraco.make_mesh_batch(1, n, 1)
    m0 = torchdraco.build_meshes(pos, faces)[0]
    g = tbatch.topology_gathers_np(tbatch.PreparedTopology(m0),
                                   m0.position_attribute())

    def busiest(word_of):
        worst = []
        for k in ("order", "next", "prev", "opp"):
            v = g[k].astype(np.int64)
            per_warp = [np.bincount(np.unique(word_of(v[w:w + 32])) % 32)
                        .max() for w in range(0, len(v), 32)]
            worst.append(float(np.mean(per_warp)))
        return max(worst)

    def flat(v):
        return 3 * v * 2 // 4  # uint16 element 3v of the row, in words

    def skewed(v):
        e = 3 * v
        return (e + e // 64 * 2) * 2 // 4  # 64 uint16 a 128-byte line
    assert busiest(skewed) < 3.6
    if n == 64:
        assert busiest(flat) > 10

"""torchdraco's TEX_COORD encode chain (torchdraco/ops/texcoords.py)
against its tpudraco counterpart (tpudraco/ops/texcoords.py) on the CPU:
the same arrays, made from a numpy seed, through both; every comparison is
equality (tolerance 0)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.ops import texcoords as tt  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from torchdraco.shared.prediction import TexCoordPrediction  # noqa: E402
from tpudraco.ops import texcoords as jt  # noqa: E402

OUTPUTS = ("symbols", "vmin", "vmax", "orient_vals", "orient_flags", "risky")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread, so that a run of
    the whole suite in several worker processes is not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sqrt_operands():
    rng = np.random.default_rng(12)
    roots = rng.integers(0, 1 << 31, size=4000, dtype=np.int64)
    sq = roots * roots
    vals = np.concatenate([
        [0, 1, 2, 3, 4, (1 << 62) - 1, 1 << 61, (1 << 31) ** 2 - 1],
        sq, sq + 1, np.maximum(sq - 1, 0),
        rng.integers(0, 1 << 62, size=4000, dtype=np.int64),
        rng.integers(0, 1 << 20, size=2000, dtype=np.int64)])
    return vals[vals < (1 << 62)]


def test_int_sqrt_matches_jax_and_host():
    vals = _sqrt_operands()
    got = tt._int_sqrt_dev(torch.from_numpy(vals))
    with jax.enable_x64(True):
        want = np.asarray(jt._int_sqrt_dev(jnp.asarray(vals)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          TexCoordPrediction._int_sqrt_vec(vals))
    shaped = tt._int_sqrt_dev(torch.from_numpy(vals[:600].reshape(3, 200)))
    assert torch.equal(shaped.reshape(-1), got[:600])


def test_unsigned_comparison_at_the_boundary():
    """The wrapping int64 product read as unsigned is >= 2^62 exactly where
    the host's uint64 product is, on both sides of 2^62, 2^63 and 2^64."""
    pairs = [(1 << 31, 1 << 31), ((1 << 31) - 1, (1 << 31) + 1),
             (1 << 31, (1 << 31) - 1), (1 << 31, 1 << 32),
             ((1 << 32) - 1, 1 << 31), (1 << 32, 1 << 32),
             ((1 << 32) + 1, (1 << 32) - 1), (3, 1 << 61), (0, 1 << 62),
             (1 << 62, 1), ((1 << 62) - 1, 1), (1 << 40, 1 << 23),
             ((1 << 62) + 5, 3), (12345, 67890)]
    a = torch.tensor([p[0] for p in pairs], dtype=torch.int64)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.int64)
    want = [((x * y) % (1 << 64)) >= (1 << 62) for x, y in pairs]
    assert tt._unsigned_ge_2_62(a * b).tolist() == want
    assert True in want and False in want
    with jax.enable_x64(True):
        ju = (jnp.asarray(a.numpy()).astype(jnp.uint64)
              * jnp.asarray(b.numpy()).astype(jnp.uint64))
        assert np.asarray(ju >= jnp.uint64(1 << 62)).tolist() == want


def _uv_group(n, batch, seed, qp, qt, spread=1.0, random_uv=False, fan=0):
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed, fan=fan)
    pos = (pos * np.float32(spread)).astype(np.float32)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    if random_uv:
        uvs = np.random.default_rng(seed).random(uvs.shape).astype(
            np.float32)
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    m0 = meshes[0]
    topo = tbatch.PreparedTopology(m0)
    g = topo.uv_gathers_for(2, m0.position_attribute().num_points)
    q_pos = tbatch.quantize_positions_host(
        np.stack([m.attributes[0].values for m in meshes]), qp)[0]
    q_uv = tbatch.quantize_positions_host(
        np.stack([m.attributes[2].values for m in meshes]), qt)[0]
    return (q_pos, q_uv, g, m0.position_attribute().unique_indices(),
            m0.attributes[2].unique_indices())


def _assert_same_outputs(got, want):
    assert len(got) == len(want) == len(OUTPUTS)
    for name, a, b in zip(OUTPUTS, got, want):
        assert isinstance(a, np.ndarray), name
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("random_uv", (False, True))
@pytest.mark.parametrize("qp,qt,spread", ((11, 10, 1.0), (18, 12, 1e4),
                                          (11, 16, 1.0)))
def test_uv_encode_chain_matches_jax(qp, qt, spread, random_uv):
    args = _uv_group(9, 5, qp + qt, qp, qt, spread, random_uv)
    got = tt.uv_encode_chain(*args, device="cpu")
    want = jt.uv_encode_chain(*args)
    _assert_same_outputs(got, want)
    assert got[0].dtype == np.uint32
    assert got[4].any()  # the geometric predictor really ran
    # 18-bit positions leave the int64 headroom in some meshes
    assert got[5].any() == (qp == 18)


def test_fan_ring_uv_chain_matches_jax():
    """One fan vertex of valence 40: the chain on the CPU (its plain
    version, also by name) equals tpudraco's."""
    args = _uv_group(41, 3, 8, 11, 10, fan=40)
    got = tt.uv_encode_chain(*args, device="cpu")
    _assert_same_outputs(got, jt.uv_encode_chain(*args))
    _assert_same_outputs(tt.uv_encode_chain_ref(*args, device="cpu"), got)


def _int_sqrt_loop(value: int) -> tuple[int, int, int]:
    """``torchdraco/ops/csrc/uv_chain.cu`` int_sqrt, line for line, in
    Python ints with its int64 product wrapped: (root, seed rounds,
    Newton rounds)."""
    if value <= 0:
        return 0, 0, 0
    act, s, seed = value, 1, 0
    while act >= 2:
        s *= 2
        act >>= 2
        seed += 1
    s = (s + value // s) >> 1
    newton = 0
    while ((s * s + (1 << 63)) % (1 << 64)) - (1 << 63) > value:
        s = (s + value // (s if s > 0 else 1)) >> 1
        newton += 1
    return s, seed, newton


def test_int_sqrt_loop_form_equals_the_fixed_rounds():
    """The early-exit loops of C3 equal the 32 + 64 fixed rounds of
    ``_int_sqrt_dev`` on 0, 1, 2^62 - 1, powers of 2, squares and squares
    +- 1 up to (2^31 - 1)^2, and random values below 2^62; they stay
    within those round counts."""
    rng = np.random.default_rng(31)
    roots = np.concatenate([np.arange(0, 70), 2 ** np.arange(0, 31),
                            2 ** np.arange(1, 32) - 1,
                            [46340, 46341, 3037000499, (1 << 31) - 1],
                            rng.integers(0, 1 << 31, 300)]).astype(np.int64)
    sq = [int(r) * int(r) for r in roots]
    vals = sorted({v for s in sq for v in (s - 1, s, s + 1)
                   if 0 <= v < 1 << 62}
                  | {0, 1, 2, 3, (1 << 62) - 1, (1 << 62) - 2}
                  | {1 << k for k in range(62)}
                  | {int(v) for v in rng.integers(0, 1 << 62, 400)})
    fixed = tt._int_sqrt_dev(torch.tensor(vals, dtype=torch.int64))
    loop = [_int_sqrt_loop(v) for v in vals]
    assert fixed.tolist() == [r for r, _, _ in loop]
    assert max(s for _, s, _ in loop) <= 32
    assert max(n for _, _, n in loop) <= 64
    assert all(r * r <= v < (r + 1) * (r + 1)
               for v, (r, _, _) in zip(vals, loop))


def test_uv_chain_takes_tensors_and_uint16():
    """The batch encoder hands the chain the uploaded positions (uint16 up
    to 16 bits) and the gather tensors it keeps on the device."""
    q_pos, q_uv, g, uo_pos, uo_uv = _uv_group(8, 3, 2, 11, 10)
    want = tt.uv_encode_chain(q_pos, q_uv, g, uo_pos, uo_uv, device="cpu")
    tg = tt.uv_gathers_to_torch(g, "cpu")
    for k, v in tg.items():
        assert v.dtype == (torch.bool if g[k].dtype == np.bool_
                           else torch.int64)
        assert np.array_equal(v.numpy(), g[k])
    got = tt.uv_encode_chain(
        torch.from_numpy(q_pos.astype(np.uint16)),
        torch.from_numpy(q_uv.astype(np.uint16)), tg,
        torch.from_numpy(uo_pos.astype(np.int64)), uo_uv, device="cpu")
    _assert_same_outputs(got, want)


def test_risky_rows_are_flagged_like_jax():
    """Positions that leave the chain's int64 headroom mark their mesh
    risky, and only that mesh: a span of 2^20 and more (the ``wide``
    guard), and below it products past 2^62 (the unsigned comparison)."""
    q_pos, q_uv, g, uo_pos, uo_uv = _uv_group(9, 6, 31, 11, 10,
                                              random_uv=True)
    rng = np.random.default_rng(4)
    q_pos = q_pos.astype(np.int64)
    q_pos[1] = rng.integers(0, 1 << 30, size=q_pos[1].shape)   # wide
    q_pos[3] = rng.integers(0, 1 << 19, size=q_pos[3].shape)   # products
    q_pos[4] = rng.integers(0, (1 << 20) - 1, size=q_pos[4].shape)
    q_uv = q_uv.astype(np.int64)
    q_uv[4] = rng.integers(0, 1 << 30, size=q_uv[4].shape)
    got = tt.uv_encode_chain(q_pos, q_uv, g, uo_pos, uo_uv, device="cpu")
    want = jt.uv_encode_chain(q_pos, q_uv, g, uo_pos, uo_uv)
    _assert_same_outputs(got, want)
    risky = got[5]
    assert risky[1] and risky[3] and not risky[0] and not risky[2]
    # the rows of the meshes that are not risky do not depend on the rest
    alone = tt.uv_encode_chain(q_pos[[0, 2, 5]], q_uv[[0, 2, 5]], g, uo_pos,
                               uo_uv, device="cpu")
    assert np.array_equal(alone[0], got[0][[0, 2, 5]])


def test_uv_chain_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _uv_group(6, 2, 1, 11, 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.uv_encode_chain(*args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.uv_gathers_to_torch(args[2], None)

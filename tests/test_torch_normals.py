"""torchdraco's NORMAL chains (torchdraco/ops/normals.py) against their
tpudraco counterparts (tpudraco/ops/normals.py) on the CPU: the same
arrays, made from a numpy seed, through both; every comparison is equality
(tolerance 0). The float steps are also held, bit for bit, to tpudraco's
integer-only float32 helpers and to numpy."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torchdraco  # noqa: E402
from torchdraco.ops import normals as tn  # noqa: E402
from torchdraco.parallel import batch as tbatch  # noqa: E402
from torchdraco.shared.octahedral import (  # noqa: E402
    invert_diamond_inverse_batched,
)
from tpudraco.ops import normals as jn  # noqa: E402
from tpudraco.ops.device import (  # noqa: E402
    f32_div_exact, f32_mul_exact, f32_sqrt_exact,
)

BITS = (7, 8, 12, 15, 16)
RING_KEYS = ("tip_pt", "next_pt", "prev_pt", "mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread, so that a run of
    the whole suite in several worker processes is not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_of(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(
        np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _float_operands(seed, n=200_000):
    """Pairs for the float ops: random magnitudes over many binades, small
    integers (the ring totals), quotients on .5 quantization boundaries,
    powers of two."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 30, n))
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 30, n))
    ints = rng.integers(-(1 << 29), 1 << 29, size=(2, n // 4))
    scale = np.float32(127.0)
    k = rng.integers(1, 254, n // 4).astype(np.float32)
    half = ((k + np.float32(0.5)) / scale).astype(np.float32)  # x*scale ~ k.5
    pow2 = 2.0 ** rng.integers(-60, 60, n // 8)
    a = np.concatenate([a, ints[0], half, pow2, [0.0, 1.0, 3.0]])
    b = np.concatenate([b, ints[1], np.full(n // 4, 1.0), pow2[::-1],
                        [5.0, 3.0, 1.0]])
    a, b = a.astype(np.float32), b.astype(np.float32)
    b[b == 0] = np.float32(1.0)
    return a, b


def test_float_ops_are_correctly_rounded():
    """``/``, ``*`` then ``+`` as separate ops, and the chains' square
    root on float32 tensors give numpy's float32 results bit for bit, and
    those of tpudraco's f32_div_exact / f32_mul_exact / f32_sqrt_exact."""
    a, b = _float_operands(3)
    ta, tb = _t(a), _t(b)
    with np.errstate(all="ignore"):
        assert np.array_equal(_bits_of((ta / tb).numpy()), _bits_of(a / b))
        prod = ta * tb
        assert np.array_equal(_bits_of(prod.numpy()), _bits_of(a * b))
        c = np.roll(a, 1)
        assert np.array_equal(_bits_of((prod + _t(c)).numpy()),
                              _bits_of((a * b).astype(np.float32) + c))
        assert np.array_equal(_bits_of(tn._f32_sqrt(ta.abs()).numpy()),
                              _bits_of(np.sqrt(np.abs(a))))
    # tpudraco's helpers double-round a subnormal result and do not take
    # an overflow: hold them where the result is a normal number
    tiny, huge = np.float32(2.0 ** -120), np.float32(2.0 ** 120)

    def normal(x):
        return (np.abs(x) > tiny) & (np.abs(x) < huge)
    with np.errstate(all="ignore"):
        q, p = a / b, a * b
    ok = normal(q) & (a != 0)
    assert np.array_equal(
        _bits_of(tn._f32_div(ta, tb).numpy())[ok],
        _bits_of(f32_div_exact(jnp.asarray(a), jnp.asarray(b)))[ok])
    ok = normal(p)
    assert np.array_equal(
        _bits_of(prod.numpy())[ok],
        _bits_of(f32_mul_exact(jnp.asarray(a), jnp.asarray(b)))[ok])
    pos = np.abs(a)
    ok = normal(pos)
    assert np.array_equal(
        _bits_of(tn._f32_sqrt(_t(pos)).numpy())[ok],
        _bits_of(f32_sqrt_exact(jnp.asarray(pos)))[ok])
    # the quotient of zero is zero whatever the divisor, as f32_div_exact
    zero = torch.zeros(3)
    assert torch.equal(tn._f32_div(zero, torch.tensor([0.0, 2.0, -1.0])),
                       zero)


@pytest.mark.parametrize("kind", ("float", "int", "zero"))
def test_oct_transform_matches_jax(kind):
    rng = np.random.default_rng(5)
    if kind == "float":
        v = rng.standard_normal((4, 3000, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v[0, :3] = np.eye(3, dtype=np.float32)
        v[0, 3:6] = -np.eye(3, dtype=np.float32)
    elif kind == "int":
        v = rng.integers(-(1 << 29), 1 << 29, size=(4, 3000, 3)).astype(
            np.int32)
        v[1] = rng.integers(-5, 6, size=(3000, 3))
        v[1, (v[1] == 0).all(-1)] = (1, 0, 0)
    else:  # a zero normal: both packages take 0 / 0 as 0
        v = np.zeros((2, 3), np.float32)
        v[1] = (0.0, 0.6, -0.8)
    got = tn.oct_transform_device(_t(v))
    want = jn.oct_transform_device(jnp.asarray(v))
    assert got.dtype == torch.float32
    if kind == "zero":  # equal values; the zeros' signs are not compared
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got[0].numpy(), [0.0, 0.0])
    else:
        assert np.array_equal(_bits_of(got.numpy()), _bits_of(want))


@pytest.mark.parametrize("bits", BITS)
def test_oct_quantize_and_faithful_match_jax(bits):
    rng = np.random.default_rng(bits)
    v = rng.standard_normal((3, 5000, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[0, 0] = 0.0  # a zero normal
    v[0, 1:4] = np.eye(3, dtype=np.float32)
    v[0, 4:7] = -np.eye(3, dtype=np.float32)
    for fn in ("oct_quantize_device", "oct_quantize_faithful_device"):
        got = getattr(tn, fn)(_t(v), bits)
        want = getattr(jn, fn)(jnp.asarray(v), bits)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want)), fn
    mx = (1 << bits) - 1
    q = rng.integers(0, mx + 1, size=(4000, 2)).astype(np.int32)
    edges = np.array([0, 1, mx // 2 - 1, mx // 2, mx // 2 + 1, mx - 1, mx])
    q = np.concatenate([q, np.stack(np.meshgrid(edges, edges), -1)
                        .reshape(-1, 2).astype(np.int32)])
    assert np.array_equal(tn.into_faithful_device(_t(q), bits).numpy(),
                          np.asarray(jn.into_faithful_device(jnp.asarray(q),
                                                             bits)))


def _centered_pairs(bits, seed, n=6000):
    rng = np.random.default_rng(seed)
    one = ((1 << bits) - 1) // 2
    w = rng.integers(-one - 2, one + 3, size=(n, 2)).astype(np.int32)
    edges = np.array([-one, -1, 0, 1, one])
    grid = np.stack(np.meshgrid(edges, edges), -1).reshape(-1, 2)
    return np.concatenate([w, grid.astype(np.int32)]), one


@pytest.mark.parametrize("bits", BITS)
def test_invert_diamond_and_its_inverse_match_jax(bits):
    w, one = _centered_pairs(bits, bits + 40)
    got = tn.invert_diamond_device(_t(w), one)
    assert np.array_equal(got.numpy(), np.asarray(
        jn.invert_diamond_device(jnp.asarray(w), one)))
    inv = tn.invert_diamond_inverse_device(_t(w), one)
    assert np.array_equal(inv.numpy(), np.asarray(
        jn.invert_diamond_inverse_device(jnp.asarray(w), one)))
    assert np.array_equal(inv.numpy().astype(np.int64),
                          invert_diamond_inverse_batched(
                              w.astype(np.int64), one))


def test_invert_diamond_inverse_first_true_selection():
    """The preimage is the FIRST candidate that maps back, also where that
    is not candidate 0 (inputs far past the diamond), and candidate 0 where
    none does: the first-True selection over an all-False column is index
    0, as jnp.argmax gives on booleans."""
    one = 127
    r = np.arange(-3 * one, 3 * one + 1, 5)
    w = np.stack(np.meshgrid(r, r), -1).reshape(-1, 2).astype(np.int32)
    tw = _t(w)
    cands = torch.stack([
        tn.invert_diamond_device(tw, one),
        torch.stack([one - tw[:, 1], one - tw[:, 0]], -1),
        torch.stack([-tw[:, 1] - one, -tw[:, 0] - one], -1),
        torch.stack([tw[:, 1] + one, tw[:, 0] - one], -1),
        torch.stack([tw[:, 1] - one, tw[:, 0] + one], -1)])
    ok = (tn.invert_diamond_device(cands, one) == tw[None]).all(-1)
    first = tn._first_true(ok)
    assert int((first > 0).sum()) > 0 and int((first == 0).sum()) > 0
    assert np.array_equal(first.numpy(), np.asarray(jnp.argmax(
        jnp.asarray(ok.numpy()), axis=0)))
    got = tn.invert_diamond_inverse_device(tw, one)
    assert torch.equal(got, cands[first, torch.arange(len(w))])
    assert np.array_equal(got.numpy(), np.asarray(
        jn.invert_diamond_inverse_device(jnp.asarray(w), one)))
    # no input leaves all five candidates unmatched, so the none-match
    # column is pinned on the selection itself
    none = torch.zeros(5, 4, dtype=torch.bool)
    assert torch.equal(tn._first_true(none), torch.zeros(4, dtype=torch.int64))
    assert np.array_equal(np.asarray(jnp.argmax(jnp.asarray(none.numpy()),
                                                axis=0)), np.zeros(4))
    later = torch.tensor([[False, True], [True, True], [True, False]])
    assert tn._first_true(later).tolist() == [1, 0]
    stack = torch.arange(5 * 4 * 2, dtype=torch.int32).view(5, 4, 2)
    assert torch.equal(tn._take_dim0(stack, tn._first_true(none)), stack[0])


def test_trunc_div_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.integers(-(1 << 40), 1 << 40, size=5000)
    b = rng.integers(-9, 10, size=5000)  # zeros too: clamped to 1
    with jax.enable_x64(True):
        want = np.asarray(jn._trunc_div(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(tn._trunc_div(_t(a), _t(b)).numpy(), want)


def _normal_group(n, batch, seed, qp, spread=1.0, fan=0):
    """A topology group of ``batch`` grids with normals and UVs (one
    vertex of valence ``fan``, which widens every ring to it): the
    quantized positions at depth ``qp``, the normals, the rings and the
    point -> unique-value maps, all numpy."""
    pos, faces = torchdraco.make_mesh_batch(batch, n, seed, fan=fan)
    pos = (pos * np.float32(spread)).astype(np.float32)
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, seed + 1)
    nrm[0, 2] = 0.0  # a zero normal
    meshes = torchdraco.build_meshes(pos, faces, nrm, uvs)
    topo = tbatch.PreparedTopology(meshes[0])
    m0 = meshes[0]
    rings = dict(topo.rings_for(1))
    rings["mask"] = rings["mask"].copy()
    rings["mask"][1] = False  # a zero ring: no slot valid
    q = tbatch.quantize_positions_host(
        np.stack([m.attributes[0].values for m in meshes]), qp)[0]
    q[1] = q[1, :1]  # and a mesh whose rings all sum to zero
    return {"q": q,
            "normals": np.stack([m.attributes[1].values for m in meshes]),
            "rings": rings,
            "uo_pos": m0.position_attribute().unique_indices(),
            "uo_nrm": m0.attributes[1].unique_indices()}


def _jax_rings(rings, rows=None):
    out = []
    for k in RING_KEYS[:3]:
        v = np.asarray(rings[k])
        out.append(jnp.asarray(v if rows is None
                               else np.asarray(rows, np.int32)[v]))
    return out + [jnp.asarray(rings["mask"])]


@pytest.mark.parametrize("qp,spread", ((11, 1.0), (18, 1e4)))
@pytest.mark.parametrize("bits", BITS)
def test_ring_predict_matches_jax(bits, qp, spread):
    g = _normal_group(9, 4, 20 + bits, qp, spread)
    tr = tn.rings_to_torch(g["rings"], "cpu", rows=g["uo_pos"])
    pred, nonzero = tn._ring_predict(_t(g["q"]), *(tr[k] for k in RING_KEYS),
                                     bits)
    with jax.enable_x64(True):
        jp, jnz = jn._ring_predict(
            jnp.asarray(g["q"]), *_jax_rings(g["rings"], g["uo_pos"]), bits)
        jp, jnz = np.asarray(jp), np.asarray(jnz)
    assert pred.dtype == torch.int32 and nonzero.dtype == torch.bool
    assert np.array_equal(pred.numpy(), jp)
    assert np.array_equal(nonzero.numpy(), jnz)
    assert not nonzero[:, 1].any() and not nonzero[1].any()
    assert nonzero[0].any()
    if qp == 18:  # ring sums past int32: the clamp reads the int64 sum
        q64 = g["q"].astype(np.int64)
        assert np.abs(q64[:, 1:] - q64[:, :-1]).max() ** 2 > 1 << 31


@pytest.mark.parametrize("qp,spread", ((11, 1.0), (18, 1e4)))
@pytest.mark.parametrize("bits", BITS)
def test_normal_encode_chain_matches_jax(bits, qp, spread):
    g = _normal_group(9, 5, bits, qp, spread)
    tr = tn.rings_to_torch(g["rings"], "cpu")
    sym, flips = tn.normal_encode_chain(
        _t(g["q"]), _t(g["normals"]), *(tr[k] for k in RING_KEYS),
        _t(g["uo_pos"].astype(np.int64)), _t(g["uo_nrm"].astype(np.int64)),
        bits=bits)
    jsym, jflips = jn.normal_encode_chain(
        jnp.asarray(g["q"]), jnp.asarray(g["normals"]),
        *_jax_rings(g["rings"]),
        jnp.asarray(g["uo_pos"].astype(np.int32)),
        jnp.asarray(g["uo_nrm"].astype(np.int32)), bits=bits)
    assert sym.dtype == torch.int32 and flips.dtype == torch.bool
    assert sym.shape == (5, len(g["rings"]["tip_pt"]), 2)
    assert np.array_equal(sym.numpy(), np.asarray(jsym))
    assert np.array_equal(flips.numpy(), np.asarray(jflips))
    # the uploaded form of shallow depths: uint16
    if qp <= 16:
        sym16, _ = tn.normal_encode_chain(
            _t(g["q"].astype(np.uint16)), _t(g["normals"]),
            *(tr[k] for k in RING_KEYS), _t(g["uo_pos"].astype(np.int64)),
            _t(g["uo_nrm"].astype(np.int64)), bits=bits)
        assert torch.equal(sym16, sym)


@pytest.mark.parametrize("qp,spread", ((11, 1.0), (18, 1e4)))
@pytest.mark.parametrize("bits", BITS)
def test_normal_decode_chain_matches_jax(bits, qp, spread):
    g = _normal_group(9, 5, 7 * bits, qp, spread)
    rng = np.random.default_rng(bits)
    T = len(g["rings"]["tip_pt"])
    mx = (1 << bits) - 1
    sym = rng.integers(0, mx, size=(5, T, 2)).astype(np.int32)
    flips = rng.random((5, T)) < 0.5
    tr = tn.rings_to_torch(g["rings"], "cpu", rows=g["uo_pos"])
    got = tn.normal_decode_chain(_t(g["q"]), _t(sym), _t(flips),
                                 *(tr[k] for k in RING_KEYS), bits=bits)
    want = jn.normal_decode_chain(
        jnp.asarray(g["q"]), jnp.asarray(sym), jnp.asarray(flips),
        *_jax_rings(g["rings"], g["uo_pos"]), bits=bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


FAN = 44


@pytest.mark.parametrize("bits", (8, 15, 16))
def test_fan_ring_chains_match_jax(bits):
    """A ring of FAN slots (one fan vertex), a zero normal, a zero ring
    and a mesh whose rings sum to zero: both chains on CPU tensors (their
    plain versions) equal tpudraco's jitted chains."""
    g = _normal_group(FAN + 1, 3, bits, 11, fan=FAN)
    assert g["rings"]["next_pt"].shape[1] == FAN
    tr = tn.rings_to_torch(g["rings"], "cpu")
    sym, flips = tn.normal_encode_chain(
        _t(g["q"]), _t(g["normals"]), *(tr[k] for k in RING_KEYS),
        _t(g["uo_pos"].astype(np.int64)), _t(g["uo_nrm"].astype(np.int64)),
        bits=bits)
    jsym, jflips = jn.normal_encode_chain(
        jnp.asarray(g["q"]), jnp.asarray(g["normals"]),
        *_jax_rings(g["rings"]),
        jnp.asarray(g["uo_pos"].astype(np.int32)),
        jnp.asarray(g["uo_nrm"].astype(np.int32)), bits=bits)
    assert np.array_equal(sym.numpy(), np.asarray(jsym))
    assert np.array_equal(flips.numpy(), np.asarray(jflips))
    ti = tn.rings_to_torch(g["rings"], "cpu", rows=g["uo_pos"])
    back = tn.normal_decode_chain(_t(g["q"]), sym, flips,
                                  *(ti[k] for k in RING_KEYS), bits=bits)
    jback = jn.normal_decode_chain(
        jnp.asarray(g["q"]), jnp.asarray(sym.numpy()),
        jnp.asarray(flips.numpy()), *_jax_rings(g["rings"], g["uo_pos"]),
        bits=bits)
    assert np.array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("bits", (8, 16))
def test_decode_chain_inverts_encode_chain(bits):
    g = _normal_group(8, 3, 50 + bits, 11)
    g["normals"][0, 2] = (0.0, 0.0, 1.0)  # only defined normals round-trip
    tr = tn.rings_to_torch(g["rings"], "cpu")
    uo_pos = _t(g["uo_pos"].astype(np.int64))
    uo_nrm = _t(g["uo_nrm"].astype(np.int64))
    sym, flips = tn.normal_encode_chain(
        _t(g["q"]), _t(g["normals"]), *(tr[k] for k in RING_KEYS), uo_pos,
        uo_nrm, bits=bits)
    ti = tn.rings_to_torch(g["rings"], "cpu", rows=g["uo_pos"])
    back = tn.normal_decode_chain(_t(g["q"]), sym, flips,
                                  *(ti[k] for k in RING_KEYS), bits=bits)
    # but for the corner (max, max), which the transform folds onto the
    # corners near 0 (the same direction)
    q_n = tn.oct_quantize_faithful_device(_t(g["normals"]), bits)
    orig = q_n[:, uo_nrm[tr["tip_pt"]], :]
    folded = (orig == (1 << bits) - 1).all(-1)
    assert torch.equal(back[~folded], orig[~folded])
    assert int(folded.sum()) <= 2


def _sq_sum_limbs(v):
    """The flip selection's squared distance as tpudraco computes it: in
    base-2^16 limbs that fit int32 (tpudraco/ops/normals.py:227)."""
    a = np.abs(v).astype(np.int32)
    ah, al = a >> 8, a & 255
    m = ah * al * 512 + al * al
    hi = (ah * ah + (m >> 16)).sum(-1)
    lo = (m & 65535).sum(-1)
    return hi + (lo >> 16), lo & 65535


@pytest.mark.parametrize("bits", (8, 15, 16))
def test_flip_select_equals_the_limb_comparison(bits):
    rng = np.random.default_rng(bits)
    mx = (1 << bits) - 1
    pred = rng.integers(-mx, mx + 1, size=(20000, 2)).astype(np.int32)
    orig = rng.integers(0, mx + 1, size=(20000, 2)).astype(np.int32)
    orig[:100] = pred[:100]
    orig[100:200] = -pred[100:200]
    h1, l1 = _sq_sum_limbs(pred - orig)
    h2, l2 = _sq_sum_limbs(-pred - orig)
    want = (h1 > h2) | ((h1 == h2) & (l1 > l2))
    got = tn._flip_select(_t(pred), _t(orig)).numpy()
    assert np.array_equal(got, want) and want.any() and not want.all()
    if bits >= 15:  # where an int32 square would have overflowed
        assert (np.abs((-pred - orig).astype(np.int64)) ** 2).max() > 1 << 31


def test_ring_budget_splits_the_batch_without_changing_it(monkeypatch):
    g = _normal_group(8, 5, 77, 11)
    tr = tn.rings_to_torch(g["rings"], "cpu")
    args = (_t(g["q"]), _t(g["normals"]), *(tr[k] for k in RING_KEYS),
            _t(g["uo_pos"].astype(np.int64)),
            _t(g["uo_nrm"].astype(np.int64)))
    whole = tn.normal_encode_chain(*args, bits=8)
    ti = tn.rings_to_torch(g["rings"], "cpu", rows=g["uo_pos"])
    dec_args = (_t(g["q"]), whole[0], whole[1], *(ti[k] for k in RING_KEYS))
    whole_dec = tn.normal_decode_chain(*dec_args, bits=8)
    calls = []
    real = tn._ring_predict

    def counted(q_pos, *a):
        calls.append(q_pos.shape[0])
        return real(q_pos, *a)
    monkeypatch.setattr(tn, "_ring_predict", counted)
    T, R = tr["next_pt"].shape
    monkeypatch.setattr(tn, "RING_BUDGET_BYTES",
                        2 * T * R * tn.RING_BYTES_PER_SLOT)
    split = tn.normal_encode_chain(*args, bits=8)
    assert calls == [2, 2, 1]
    assert all(torch.equal(a, b) for a, b in zip(split, whole))
    assert torch.equal(tn.normal_decode_chain(*dec_args, bits=8), whole_dec)
    assert calls == [2, 2, 1] * 2


def test_rings_to_torch_layout():
    g = _normal_group(6, 2, 3, 11)
    tr = tn.rings_to_torch(g["rings"], "cpu")
    for k in RING_KEYS[:3]:
        assert tr[k].dtype == torch.int64
        assert np.array_equal(tr[k].numpy(), g["rings"][k])
    assert tr["mask"].dtype == torch.bool
    assert np.array_equal(tr["mask"].numpy(), g["rings"]["mask"])
    rows = np.arange(int(g["rings"]["next_pt"].max()) + 1)[::-1].copy()
    mapped = tn.rings_to_torch(g["rings"], "cpu", rows=rows)
    assert np.array_equal(mapped["next_pt"].numpy(),
                          rows[g["rings"]["next_pt"]])

"""torchdraco's multi-lane rANS twins against tpudraco's JAX functions and
the host coder. Inputs are made from a seed with numpy; the tolerance is 0.

The words-scan twin is held against the JAX package's Pallas words kernel
(``kernel=True``), run in interpret mode. ``compact="sort"`` is forced: the
CPU default, "marks", never reaches the kernel."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torchdraco.ops import rans_lanes as trl  # noqa: E402
from tpudraco.entropy.rans import normalize_freq_counts_batch  # noqa: E402
from tpudraco.entropy.symbol_coding import (  # noqa: E402
    DIRECT_CODED, encode_symbols,
)
from tpudraco.ops import rans_lanes as jrl  # noqa: E402
from tpudraco.wire import ByteWriter  # noqa: E402


def _host_payload(stream: np.ndarray) -> bytes:
    w = ByteWriter()
    encode_symbols(stream.ravel().astype(np.uint64), 3, DIRECT_CODED, w)
    return w.getvalue()


def _count_rows(seed: int, S: int = 96) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(12):
        r = (rng.integers(0, 40, size=S) ** 2) * rng.integers(0, 2, size=S)
        r[rng.integers(0, S)] += 1
        rows.append(r)
    tie = np.zeros(S, dtype=np.int64)
    tie[0], tie[5] = 1, 2047       # total a power of two
    one = np.zeros(S, dtype=np.int64)
    one[7] = 5000                  # single symbol: dist[7] = rp
    wide = rng.integers(1, 3, size=S)
    rows += [tie, one, wide, np.zeros(S, dtype=np.int64)]  # last: patho
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("n_sym", (300, 5000, 70000, 1 << 21))
def test_normalize_tables_matches_jax(n_sym):
    """Every output, the pathological flag of the all-zero row included,
    at symbol counts whose schedule picks precisions 12 to 20."""
    counts = _count_rows(n_sym)
    with jax.enable_x64(True):
        want = jrl._normalize_tables_x64(jnp.asarray(counts),
                                         jnp.int32(n_sym))
        want = [np.asarray(w) for w in want]
    got = trl.normalize_tables(torch.from_numpy(counts), n_sym)
    for name, w, t in zip(("dist", "cums", "prec", "tiny"), want, got):
        assert t.dtype == torch.int32, name
        assert np.array_equal(t.numpy(), w), name
    assert got[3][-1, 3] == 1 and not got[3][:-1, 3].any()


def test_flip_and_pregather_match_jax():
    rng = np.random.default_rng(3)
    syms = rng.integers(0, 60, size=(5, 40, 3)).astype(np.int32)
    want = np.asarray(jrl._flip_lanes(jnp.asarray(syms)))
    lanes = trl.flip_lanes(torch.from_numpy(syms))
    assert np.array_equal(lanes.numpy(), want)
    counts = np.stack([np.bincount(r.ravel(), minlength=64) for r in syms])
    dist, _ = normalize_freq_counts_batch(counts, np.full(5, 14))
    cums = np.zeros_like(dist)
    cums[:, 1:] = np.cumsum(dist[:, :-1], axis=1)
    idx = jnp.clip(jnp.asarray(want), 0, dist.shape[1] - 1)
    fs, cs = jrl._take_packed_u32u8(
        jnp.asarray(dist, jnp.uint32), jnp.asarray(cums, jnp.uint32),
        lambda tbl: jnp.take_along_axis(tbl, idx, axis=1))
    gf, gc = trl.lane_tables_gather(lanes, torch.from_numpy(dist),
                                    torch.from_numpy(cums))
    assert np.array_equal(gf.numpy(), np.asarray(fs))
    assert np.array_equal(gc.numpy(), np.asarray(cs))


def test_words_scan_twin_matches_pallas_words_kernel():
    """Mixed per-lane precisions 12-20, ragged and empty lanes."""
    rng = np.random.default_rng(11)
    L, n = 11, 200
    syms = (rng.integers(0, 12, size=(L, n)) ** 2).astype(np.int32)
    syms[4] = rng.integers(0, 250, size=n)
    prec = (12 + np.arange(L) % 9).astype(np.int32)
    counts = np.stack([np.bincount(r, minlength=256) for r in syms])
    dist, _ = normalize_freq_counts_batch(counts, prec)
    dist = dist.astype(np.int32)
    cums = np.zeros_like(dist)
    cums[:, 1:] = np.cumsum(dist[:, :-1], axis=1)
    lengths = np.full(L, n, np.int32)
    lengths[2], lengths[3], lengths[7] = 57, 0, 1
    combined = np.asarray(jrl._rans_scan_lanes_words_vprec(
        jrl._flip_lanes(jnp.asarray(syms)), jnp.asarray(dist),
        jnp.asarray(cums), jnp.asarray(lengths), jnp.asarray(prec),
        compact="sort", k=8, kernel=True))
    words, meta = trl.rans_words_scan_ref(
        torch.from_numpy(syms), torch.from_numpy(dist),
        torch.from_numpy(cums), torch.from_numpy(prec),
        torch.from_numpy(lengths))
    meta = meta.numpy().view(np.uint32)
    words = words.numpy().view(np.uint32)
    assert np.array_equal(meta, combined[:, :5])
    assert words.shape[1] == combined.shape[1] - 5 == trl.words_cap(n)
    for lane in range(L):
        nw = int(meta[lane, 0])
        assert np.array_equal(words[lane, :nw], combined[lane, 5:5 + nw])
        assert not words[lane, nw:].any()


@pytest.mark.parametrize("width", (16, 3000))
def test_group_entropy_matches_host_and_jax(width):
    rng = np.random.default_rng(width)
    B, T, C = 6, 70, 3
    syms = rng.integers(0, width, size=(B, T, C)).astype(np.int32)
    syms[1] = 0                                       # one-symbol lane
    counts = np.stack([np.bincount(s.ravel(), minlength=4096)
                       for s in syms]).astype(np.int32)
    got = trl.encode_group_entropy_device(torch.from_numpy(syms),
                                          torch.from_numpy(counts))
    want_jax = jrl.encode_group_entropy_device(jnp.asarray(syms),
                                               jnp.asarray(counts))
    assert got == want_jax
    for b in range(B):
        assert got[b] == _host_payload(syms[b]), b


def test_group_entropy_histogram_deficit_raises():
    syms = np.full((2, 10, 3), 5, dtype=np.int32)
    counts = np.zeros((2, 8), dtype=np.int32)
    counts[:, 5] = 30
    counts[1, 5] = 29                                 # one symbol dropped
    with pytest.raises(ValueError, match="dropped symbols"):
        trl.encode_group_entropy_device(torch.from_numpy(syms),
                                        torch.from_numpy(counts))


def test_pathological_lanes_take_host_tables(monkeypatch):
    """Flag two healthy lanes pathological: they take the host's tables
    into the same launch, are counted, and the bytes do not change."""
    rng = np.random.default_rng(5)
    syms = (rng.integers(0, 9, size=(4, 50, 3)) ** 2).astype(np.int32)
    counts = np.stack([np.bincount(s.ravel(), minlength=128)
                       for s in syms]).astype(np.int32)
    real = trl.normalize_tables

    def flag_two(c, n_sym):
        dist, cums, prec, tiny = real(c, n_sym)
        tiny[[0, 2], 3] = 1
        dist[[0, 2]] = 0          # the host tables must replace these
        cums[[0, 2]] = 0
        return dist, cums, prec, tiny

    monkeypatch.setattr(trl, "normalize_tables", flag_two)
    before = trl.encode_group_entropy_device.n_patho_lanes
    got = trl.encode_group_entropy_device(torch.from_numpy(syms),
                                          torch.from_numpy(counts))
    assert trl.encode_group_entropy_device.n_patho_lanes == before + 2
    assert got == [_host_payload(s) for s in syms]


def test_collect_words_refuses_overflow():
    meta = np.zeros((1, 5), np.uint32)
    meta[0, 0] = 9
    with pytest.raises(ValueError, match="capacity"):
        trl.collect_words(np.zeros((1, 4), np.uint32), meta, 8)


@pytest.mark.parametrize("lo,hi", [(1, 1 << 12), (1 << 12, 1 << 17),
                                   (1 << 17, (1 << 20) + 1)])
def test_words_kernel_reciprocal_formula_is_exact(lo, hi):
    """K3 (csrc/rans_words.cu, ``table_entry``) divides the state by a
    frequency f with q = umulhi(x, m) >> s. For every f of the range and
    states at the edges the coder can reach (x <= f * 2^10 - 1; multiples
    of f, one below, one below the next; the largest; random ones) the
    quotient is floor(x / f), m fits 32 bits and x * m fits 64. f = 1 is
    the kernel's flagged case (q = 0, x' = x << P + c) and is left out."""
    f = np.arange(max(lo, 2), hi, dtype=np.uint64)
    b = np.array([int(v).bit_length() for v in f], dtype=np.uint64)
    pow2 = (f & (f - 1)) == 0
    k = np.maximum(32, 2 * b + 10)
    m = np.where(pow2, 1 << 31, (np.uint64(1) << k) // f + 1)
    s = np.where(pow2, b - 2, k - 32)
    assert int(m.max()) < 1 << 32 and int(s.max()) < 32
    rng = np.random.default_rng(lo)
    states = [f * 1024 - 1]
    for j in (1, 2, 3, 511, 512, 1000, 1023):
        states += [f * j, f * j - 1, f * j + f - 1]
    states += [(rng.random(len(f)) * (f * 1024).astype(np.float64))
               .astype(np.uint64) for _ in range(8)]
    for x in states:
        assert int((x * m).max()) < 1 << 63
        assert np.array_equal(((x * m) >> np.uint64(32)) >> s, x // f)


def _dense_step_quotient(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """The quotient K4 (csrc/rans_dense.cu) takes for a renormalised state
    x and a frequency f, both uint64 holding uint32 values: the prepared
    reciprocal of csrc/rans_reciprocal.cuh where 0 < f < 2^21 and
    x < f << 10, else the exact path's true division, with jnp's answer
    for f = 0."""
    fast = (f != 0) & (f < trl.DENSE_FAST_MAX_FREQ) & (x < (f << 10))
    ff = np.where(fast, f, 3)  # any valid f where the fast path is unused
    b = np.array([int(v).bit_length() for v in ff], dtype=np.uint64)
    pow2 = (ff & (ff - 1)) == 0
    k = np.maximum(32, 2 * b + 10)
    m = np.where(pow2, 1 << 31, (np.uint64(1) << k) // ff + 1)
    sh = np.where(pow2, b - np.minimum(b, 2), k - 32)
    assert int(m.max()) < 1 << 32 and int(sh.max()) < 32
    xf = np.where(fast, x, 0)
    assert int((xf * m).max()) < 1 << 63
    q_fast = np.where(ff == 1, xf, ((xf * m) >> np.uint64(32)) >> sh)
    q_exact = np.where(f == 0, 0xFFFFFFFF, x // np.maximum(f, 1))
    return np.where(fast, q_fast, q_exact).astype(np.uint64)


@pytest.mark.parametrize("case", ("bit_length_21", "edges", "random"))
def test_dense_kernel_guarded_quotient_is_exact(case):
    """K4 takes any uint32 (x, f): its guarded quotient equals x // f (and
    0xFFFFFFFF for f = 0) on every frequency of bit length 21, which K3's
    tables never hold, at the edges of the guard, and on random pairs."""
    rng = np.random.default_rng(21)
    if case == "bit_length_21":
        f = np.arange(1 << 20, 1 << 21, dtype=np.uint64)
        xs = [f * 1024 - 1, f * 1024, f * 1023, f * 1023 - 1, f, f - 1,
              np.zeros_like(f), np.full_like(f, 0xFFFFFFFF)]
        xs += [(rng.random(len(f)) * (f * 1024).astype(np.float64))
               .astype(np.uint64) for _ in range(4)]
        pairs = [(x, f) for x in xs]
    elif case == "edges":
        fe = np.array([0, 1, 2, 3, 4, 5, 255, 256, 257, (1 << 12) - 1,
                       1 << 12, (1 << 20) - 1, 1 << 20, (1 << 20) + 1,
                       (1 << 21) - 1, 1 << 21, (1 << 21) + 1, 1 << 22,
                       (1 << 22) + 5, 1 << 31, 0xFFFFFFFF], dtype=np.uint64)
        xe = np.array([0, 1, 2, 255, 256, 1023, 1024, 1025, (1 << 22) - 1,
                       1 << 22, (1 << 30) - 1, 1 << 30, (1 << 31) - 1,
                       1 << 31, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint64)
        f, x = (a.ravel() for a in np.meshgrid(fe, xe))
        near = np.concatenate([(fe.astype(np.int64) << 10) + d
                               for d in (-1, 0, 1)])
        keep = (near >= 0) & (near <= 0xFFFFFFFF)
        pairs = [(x, f), (near[keep].astype(np.uint64),
                          np.tile(fe, 3)[keep])]
    else:
        n = 400_000
        f = rng.integers(0, 1 << 32, size=n, dtype=np.uint64) \
            >> rng.integers(0, 32, size=n).astype(np.uint64)
        x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64) \
            >> rng.integers(0, 24, size=n).astype(np.uint64)
        pairs = [(x, f), (np.minimum(x, (f << 10) - (f > 0)), f)]
    for x, f in pairs:
        want = np.where(f == 0, 0xFFFFFFFF, x // np.maximum(f, 1))
        assert np.array_equal(_dense_step_quotient(x, f), want)


def test_dense_twin_counts_guard_steps():
    """The twin's ``guard_steps``: none on valid tables, and on random
    pairs at least every active step of frequency 0 or past 2^21."""
    rng = np.random.default_rng(5)
    L, T, prec = 6, 90, 12
    syms = rng.integers(0, 30, size=(L, T))
    counts = np.stack([np.bincount(r, minlength=30) for r in syms])
    dist, _ = normalize_freq_counts_batch(counts, np.full(L, prec))
    cums = np.zeros_like(dist)
    cums[:, 1:] = np.cumsum(dist[:, :-1], axis=1)
    fs, cs = trl.lane_tables_gather(*(torch.from_numpy(a) for a in (
        syms, dist, cums)))
    ln = torch.from_numpy(rng.integers(0, T + 1, size=L))
    guard = torch.full((L,), -1, dtype=torch.int32)
    plain = trl.rans_scan_dense_ref(fs, cs, ln, prec)
    got = trl.rans_scan_dense(fs, cs, ln, prec, guard_steps=guard)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert guard.tolist() == [0] * L
    wild = torch.from_numpy(rng.integers(0, 1 << 23, size=(L, T)))
    wild[:, ::7] = 0
    trl.rans_scan_dense(wild, cs, ln, prec, guard_steps=guard)
    active = torch.arange(T)[None, :] < ln[:, None]
    flagged = (active & ((wild == 0)
                         | (wild >= trl.DENSE_FAST_MAX_FREQ))).sum(dim=1)
    assert bool((guard >= flagged).all()) and int(flagged.sum()) > 0

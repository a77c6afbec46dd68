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

"""torchdraco's stream-lane rANS plane against tpudraco's JAX functions and
the host coder: the dense scan (K4's twin), the lane coder through both
engines, its host-facing callers, and the lane decoder (D1's twin).
Inputs are made from a seed with numpy; the tolerance is 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import tpudraco.ops.pallas_kernels as pk  # noqa: E402
from torchdraco.ops import rans_lanes as trl  # noqa: E402
from tpudraco.entropy.rans import (  # noqa: E402
    RansEncoder, normalize_freq_counts,
)
from tpudraco.entropy.symbol_coding import (  # noqa: E402
    DIRECT_CODED, encode_symbols,
)
from tpudraco.ops import rans_lanes as jrl  # noqa: E402
from tpudraco.wire import ByteWriter  # noqa: E402


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _host_encode(stream, dist, prec=12):
    enc = RansEncoder(dist, precision=prec)
    enc.write_all(stream)
    return enc.flush()


def _pallas_case(zero_freq: bool):
    """tests/test_pallas_kernels.py's K4 shape: L=7, T=700, per-lane
    tables, a short lane and an empty lane; or a few steps on a table
    without the coded symbol (frequency 0 while active)."""
    rng = np.random.default_rng(5)
    if zero_freq:
        fs = rng.integers(0, 40, size=(3, 9)).astype(np.uint32)
        fs[:, ::3] = 0
        cs = rng.integers(0, 4000, size=(3, 9)).astype(np.uint32)
        return fs, cs, np.array([9, 4, 0], np.int32), 12
    L, T, prec = 7, 700, 12
    streams = [rng.integers(0, 30 + 11 * i, size=T) for i in range(L)]
    S = max(int(s.max()) + 1 for s in streams)
    freqs = np.zeros((L, S), np.uint32)
    cums = np.zeros((L, S), np.uint32)
    for i, s in enumerate(streams):
        d = normalize_freq_counts(np.bincount(s), prec)
        freqs[i, :len(d)] = d
        cums[i, 1:len(d)] = np.cumsum(d)[:-1]
    sym = np.stack(streams)
    lengths = np.full(L, T, np.int32)
    lengths[3], lengths[5] = T // 2, 0
    fs = np.take_along_axis(freqs, sym, axis=1)
    cs = np.take_along_axis(cums, sym, axis=1)
    return fs, cs, lengths, prec


@pytest.mark.parametrize("zero_freq", (False, True))
def test_dense_scan_twin_matches_pallas_kernel(zero_freq):
    fs, cs, lengths, prec = _pallas_case(zero_freq)
    want = [np.asarray(w) for w in pk.rans_scan_pallas(
        jnp.asarray(fs), jnp.asarray(cs), jnp.asarray(lengths),
        precision=prec)]
    got = trl.rans_scan_dense(_t(fs), _t(cs), _t(lengths), prec)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.bool
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(got[2].numpy().view(np.uint32), want[2])


def _lane_case(tables: str, seed: int = 5):
    """tests/test_rans_lanes.py's dense/words case: L=20, T=700, ragged
    lanes, one empty and one full; on a shared table, per-lane tables, or
    a shared table that lacks a coded symbol (frequency 0)."""
    rng = np.random.RandomState(seed)
    L, T = 20, 700
    syms = rng.randint(0, 37, (L, T)).astype(np.int32)
    lengths = rng.randint(1, T + 1, L).astype(np.int32)
    lengths[0], lengths[1] = 0, T
    if tables != "per_lane":
        counts = np.bincount(syms.ravel())
        if tables == "missing":
            counts[7] = 0
        dist = normalize_freq_counts(counts, 12)
        cums = np.concatenate([[0], np.cumsum(dist)[:-1]])
        return syms, dist.astype(np.uint32), cums.astype(np.uint32), lengths
    syms[3] = rng.randint(0, 60, T)          # past the shared alphabet
    freqs = np.zeros((L, 64), np.uint32)
    cums = np.zeros((L, 64), np.uint32)
    for i in range(L):
        d = normalize_freq_counts(np.bincount(syms[i], minlength=2), 12)
        freqs[i, :len(d)] = d
        cums[i, 1:len(d)] = np.cumsum(d)[:-1]
    return syms, freqs, cums, lengths


@pytest.mark.parametrize("tables", ("shared", "per_lane"))
def test_scan_lanes_dense_matches_jax(tables):
    syms, freqs, cums, lengths = _lane_case(tables)
    want = [np.asarray(w) for w in jrl._rans_scan_lanes(
        jnp.asarray(syms), jnp.asarray(freqs), jnp.asarray(cums),
        jnp.asarray(lengths), precision=12)]
    got = trl.rans_scan_lanes_dense(_t(syms), _t(freqs), _t(cums),
                                    _t(lengths), 12)
    assert np.array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64))


@pytest.mark.parametrize("dense", (False, True))
@pytest.mark.parametrize("tables", ("shared", "per_lane"))
def test_encode_lanes_matches_jax_both_engines(monkeypatch, dense, tables):
    """Whole buffers and nbytes equal JAX's words path AND its forced
    dense path, whichever engine the port runs."""
    syms, freqs, cums, lengths = _lane_case(tables)
    buf_w, n_w = jrl.rans_encode_lanes(syms, freqs, cums, lengths)
    monkeypatch.setattr(pk, "rans_scan_pallas_viable", lambda L, T: True)
    buf_d, n_d = jrl.rans_encode_lanes(syms, freqs, cums, lengths)
    got, n = trl.rans_encode_lanes(torch.from_numpy(syms), freqs, cums,
                                   lengths, dense=dense)
    assert got.dtype == np.uint8 and n.dtype == np.int32
    for buf, nb in ((buf_w, n_w), (buf_d, n_d)):
        assert np.array_equal(n, nb)
        assert np.array_equal(got, np.asarray(buf))


@pytest.mark.parametrize("dense", (False, True))
def test_encode_lanes_rejects_zero_frequency(dense):
    """A table without a coded symbol is outside the coder's contract, and
    there JAX's two engines part (its words path packs freq - 1 into 20
    bits, so 0 reads as 2^20): both of the port's engines refuse it. The
    same symbol past every lane's length is not coded and passes."""
    syms, freqs, cums, lengths = _lane_case("missing")
    with pytest.raises(ValueError, match="frequency 0"):
        trl.rans_encode_lanes(torch.from_numpy(syms), freqs, cums, lengths,
                              dense=dense)
    syms = np.where(syms == 7, 8, syms)
    syms[:, -1] = 7
    short = np.minimum(lengths, syms.shape[1] - 1)
    got, n = trl.rans_encode_lanes(torch.from_numpy(syms), freqs, cums,
                                   short, dense=dense)
    want, n_j = jrl.rans_encode_lanes(syms, freqs, cums, short)
    assert np.array_equal(n, n_j) and np.array_equal(got, np.asarray(want))


def test_dense_engine_is_not_the_default(monkeypatch):
    calls = []
    monkeypatch.setattr(trl, "rans_scan_lanes_dense",
                        lambda *a: calls.append(a))
    syms, freqs, cums, lengths = _lane_case("shared")
    trl.rans_encode_lanes(torch.from_numpy(syms), freqs, cums, lengths)
    assert not calls


@pytest.mark.parametrize("tables", ("shared", "per_lane", "missing"))
def test_zero_frequency_hit(tables):
    """True exactly where a coded symbol (clipped to the table, as the
    pre-gather clips it) has frequency 0; symbols past a lane's length do
    not count."""
    syms, freqs, cums, lengths = _lane_case(tables)
    f2 = np.broadcast_to(freqs, (len(syms), freqs.shape[-1]))
    idx = np.clip(syms, 0, f2.shape[1] - 1)
    coded = np.arange(syms.shape[1])[None, :] < lengths[:, None]
    want = bool(((np.take_along_axis(f2, idx, 1) == 0) & coded).any())
    assert want == (tables == "missing")
    got = trl.zero_frequency_hit(_t(syms), _t(f2), _t(lengths))
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want
    if want:  # the same symbols past every length are not coded
        first = np.flatnonzero(((np.take_along_axis(f2, idx, 1) == 0)
                                & coded).any(0))[0]
        short = np.minimum(lengths, first)
        assert not bool(trl.zero_frequency_hit(_t(syms), _t(f2), _t(short)))


def _skew_streams():
    rng = np.random.RandomState(2)
    counts = np.zeros(9, dtype=np.int64)
    counts[0], counts[8] = 1000, 1
    streams = [np.zeros(rng.randint(1, 200), dtype=np.int32)
               for _ in range(5)]
    streams[2][:] = 8              # the rare symbol: most renormalisation
    return streams, counts


def _mixed_streams():
    rng = np.random.RandomState(0)
    counts = rng.randint(1, 50, size=37)
    streams = [rng.randint(0, 37, size=rng.randint(5, 400)).astype(np.int32)
               for _ in range(16)]
    return streams, counts


@pytest.mark.parametrize("case", (_mixed_streams, _skew_streams))
def test_encode_streams_device_matches_host(case):
    streams, counts = case()
    dist = normalize_freq_counts(counts, 12)
    got = trl.encode_streams_device(streams, counts, device="cpu")
    assert got == jrl.encode_streams_device(streams, counts)
    for s, blob in zip(streams, got):
        assert blob == _host_encode(s, dist)


def test_encode_direct_coded_streams_matches_host():
    rng = np.random.default_rng(3)
    streams = [
        rng.integers(0, 40, size=333, dtype=np.uint64),
        rng.integers(0, 3, size=50, dtype=np.uint64),      # small alphabet
        np.zeros(64, dtype=np.uint64),                      # all zero
        rng.integers(0, 5000, size=1200, dtype=np.uint64),  # high precision
    ]
    got = trl.encode_direct_coded_streams_device(streams, device="cpu")
    for i, s in enumerate(streams):
        w = ByteWriter()
        encode_symbols(s, 1, DIRECT_CODED, w)
        assert got[i] == w.getvalue(), f"stream {i}"


def _decode_case(prec, alpha_max, per_lane=True, holes=False):
    """tests/test_rans_lanes.py's packed/generic decode grid: L=24,
    T=600, ragged counts, a per-lane alphabet each (or one shared). With
    ``holes`` a lane's symbols are squares modulo its alphabet, so its
    table has symbols of frequency 0 in the middle and at the end. The
    slot tables are for the JAX side only."""
    rng = np.random.RandomState(11)
    L, T = 24, 600
    counts = rng.randint(1, T + 1, L).astype(np.int64)
    counts[0] = T
    counts[5] = 0
    syms = np.zeros((L, T), np.int32)
    S = 16
    while S < alpha_max:
        S *= 2
    shared = None
    if not per_lane:  # every symbol below alpha_max keeps a frequency
        shared = normalize_freq_counts(
            np.bincount(rng.randint(0, alpha_max, 4 * T),
                        minlength=alpha_max) + 1, prec)
    dists = []
    for i in range(L):
        a = rng.randint(2, alpha_max)
        s = rng.randint(0, a, counts[i])
        if holes:
            s = s.astype(np.int64) ** 2 % a
        syms[i, :counts[i]] = s[::-1]                 # reversed feed
        dists.append(shared if shared is not None else normalize_freq_counts(
            np.bincount(s if len(s) else [0], minlength=a), prec))
    freqs = np.zeros((L, S), np.uint32)
    cums = np.zeros((L, S), np.uint32)
    slots = np.zeros((L, 1 << prec), np.int32)
    for i, d in enumerate(dists):
        freqs[i, :len(d)] = d
        cums[i, 1:len(d)] = np.cumsum(d)[:-1]
        reps = np.repeat(np.arange(len(d)), d)
        slots[i, :len(reps)] = reps
    if not per_lane:
        freqs, cums, slots = freqs[0], cums[0], slots[0]
    return syms, freqs, cums, slots, counts


@pytest.mark.parametrize("prec,alpha_max,per_lane,holes", [
    (12, 50, True, False), (12, 400, True, False), (13, 60, True, False),
    (14, 300, True, False), (12, 50, False, False), (18, 3000, True, False),
    (20, 40000, False, False), (12, 400, True, True), (20, 3000, True, True),
    (20, 3000, True, False)])
def test_decode_twin_matches_jax(prec, alpha_max, per_lane, holes):
    """Both JAX scans (packed P <= 14: uint8/uint16; generic: int16/int32)
    and their dtypes; the port's own encoder feeds both decoders. The
    port's twin searches the cumulative row; JAX reads a slot table."""
    syms, freqs, cums, slots, counts = _decode_case(prec, alpha_max,
                                                    per_lane, holes)
    if holes:  # zero frequencies inside and at the end of an alphabet
        assert ((freqs[:, 1:-1] == 0) & (freqs[:, 2:] > 0)).any()
    bufs, nbytes = trl.rans_encode_lanes(torch.from_numpy(syms), freqs,
                                         cums, counts, precision=prec)
    want = np.asarray(jrl.rans_decode_lanes(
        jnp.asarray(bufs), jnp.asarray(nbytes), jnp.asarray(freqs),
        jnp.asarray(cums), jnp.asarray(slots), counts, precision=prec))
    got = trl.rans_decode_lanes(torch.from_numpy(bufs), nbytes, freqs,
                                counts, precision=prec).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    for i, n in enumerate(counts):
        assert np.array_equal(got[i, :n].astype(np.int64),
                              syms[i, :n][::-1])


def test_decode_never_returns_zero_frequency_symbol():
    """A table with holes at the start, in the middle and at the end: the
    remainder on each hole's boundary decodes to the next symbol of
    frequency > 0, as JAX's slot table gives it."""
    dist = np.array([0, 1000, 0, 0, 2000, 1096, 0, 0])
    cums = np.concatenate([[0], np.cumsum(dist)[:-1]])
    slots = np.repeat(np.arange(len(dist)), dist).astype(np.int32)
    stream = np.array([1, 4, 5, 5, 4, 1, 1, 5, 4, 4] * 9, np.int64)
    syms = stream[::-1].astype(np.int32)[None, :]
    n = np.array([len(stream)], np.int64)
    bufs, nbytes = trl.rans_encode_lanes(torch.from_numpy(syms), dist, cums,
                                         n, precision=12)
    want = np.asarray(jrl.rans_decode_lanes(
        jnp.asarray(bufs), jnp.asarray(nbytes),
        jnp.asarray(dist.astype(np.uint32)),
        jnp.asarray(cums.astype(np.uint32)), jnp.asarray(slots), n))
    got = trl.rans_decode_lanes(torch.from_numpy(bufs), nbytes, dist,
                                n).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got[0].astype(np.int64), stream)
    assert (dist[got[0]] > 0).all()


@pytest.mark.parametrize("tables", ("short", "long", "empty"))
def test_decode_refuses_unnormalized_table(tables):
    """A remainder at or past a table's total has no symbol (JAX's
    zero-filled slot table answers 0 there): the port refuses a table that
    does not sum to 2^P for any lane that has symbols; a lane without
    symbols may carry any table."""
    dist = np.array([[1000, 2000, 1096], [1000, 2000, 1096]])
    if tables == "short":
        dist[1, 2] = 1000                      # sums to 4000
    elif tables == "long":
        dist[1, 2] = 1100                      # sums to 4100
    else:
        dist[1] = 0                            # a padding row
    bufs = torch.zeros((2, 8), dtype=torch.uint8)
    bufs[:, 3] = 1
    with pytest.raises(ValueError, match="table 1 is not a normalized"):
        trl.rans_decode_lanes(bufs, np.array([4, 4]), dist, np.array([3, 3]))
    out = trl.rans_decode_lanes(bufs, np.array([4, 0]), dist,
                                np.array([3, 0]))
    assert out.shape == (2, 3) and out.dtype == torch.uint8
    shared = trl.rans_decode_lanes(bufs, np.array([4, 4]), dist[0],
                                   np.array([3, 3]))
    assert torch.equal(shared[0], out[0])
    with pytest.raises(ValueError, match="table 0 is not a normalized"):
        trl.rans_decode_lanes(bufs, np.array([4, 4]), dist[1],
                              np.array([3, 3]))


def test_decode_wide_alphabet_low_precision():
    """A P=12 stream whose symbols pass 2^16 takes the generic int32 form
    and round-trips (a u16 table would truncate 69999)."""
    stream = np.array([0, 69999, 3, 0, 69999, 1, 2, 3] * 4, np.int64)
    dist = normalize_freq_counts(np.bincount(stream), 12)
    cums = np.concatenate([[0], np.cumsum(dist)[:-1]])
    slots = np.repeat(np.arange(len(dist)), dist).astype(np.int32)
    syms = stream[::-1].astype(np.int32)[None, :]
    n = np.array([len(stream)], np.int64)
    bufs, nbytes = trl.rans_encode_lanes(torch.from_numpy(syms), dist, cums,
                                         n, precision=12)
    want = np.asarray(jrl.rans_decode_lanes(
        jnp.asarray(bufs), jnp.asarray(nbytes),
        jnp.asarray(dist.astype(np.uint32)),
        jnp.asarray(cums.astype(np.uint32)), jnp.asarray(slots), n))
    got = trl.rans_decode_lanes(torch.from_numpy(bufs), nbytes, dist,
                                n).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got[0].astype(np.int64), stream)


def test_decode_rejects_streams_without_bytes():
    """JAX reads a wrapped index for nbytes == 0; the port refuses a lane
    with symbols and no metadata byte, or more bytes than its row."""
    dist = np.array([4096])
    args = (np.zeros(1, np.int64), dist, np.array([3]))
    bufs = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="lane 0"):
        trl.rans_decode_lanes(bufs, *args)
    with pytest.raises(ValueError, match="lane 0"):
        trl.rans_decode_lanes(bufs, np.array([9]), *args[1:])
    out = trl.rans_decode_lanes(bufs, np.zeros(1, np.int64), dist,
                                np.array([0]))
    assert out.shape == (1, 16) and not out.any()  # 2 * cap, sentinel 0

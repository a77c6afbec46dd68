"""Multi-lane rANS: the encode side of a topology group's symbol streams,
the generic lane coder and its inverse.

Counterpart of ``tpudraco/ops/rans_lanes.py``. One lane is one Draco
DirectCoded stream, coded on its own normalized table at its own precision.
The group encoder follows ``_group_entropy_device_tables``:

1. ``normalize_tables`` builds every lane's table and precision on the
   device (int64, bit-identical to the host's f64 normalization);
2. the host reads a (B, 4) summary, raises on a histogram deficit, and
   swaps in host tables for lanes flagged pathological;
3. one launch of ``rans_words_scan`` (K3, ``csrc/rans_words.cu``) codes all
   lanes: reversed feed, per-lane (freq, cum) lookup, the recurrence, word
   packing, compaction and flush framing;
4. the host unpacks the words into byte streams (``collect_words``,
   ``append_flush``) and frames the payloads (``assemble_payloads``).

The stream-lane plane beside it:

- ``rans_encode_lanes`` codes (L, T) lanes on a shared or per-lane table at
  one precision through either engine: the words scan (K3) or the dense
  scan (K4, ``rans_scan_dense``, ``csrc/rans_dense.cu``) with its
  compaction (``rans_scan_lanes_dense``). Both give the same bytes.
  ``encode_streams_device`` and ``encode_direct_coded_streams_device``
  are its host-facing callers.
- ``rans_decode_lanes`` (D1, ``csrc/rans_decode.cu``) decodes lanes back.

The plain twins (``flip_lanes``, ``lane_tables_gather``,
``rans_words_scan_ref``, ``rans_scan_dense_ref``,
``rans_decode_lanes_ref``) are the spec for the kernels and the path of CPU
tensors. They carry rANS states in int64 masked with 0xFFFFFFFF, since
torch has no division, remainder, shift or compare on uint32. The JAX
package's readback buckets, lane chunking, compaction modes and
compile-cache padding existed for a high-latency link and for XLA, and are
not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..entropy.rans import (
    normalize_freq_counts, normalize_freq_counts_batch,
    rans_precision_for_bit_length, serialize_rans_table,
    serialize_rans_tables_batch,
)
from ..entropy.symbol_coding import DIRECT_CODED, bit_length_u64
from ..wire.byte_io import ByteWriter
from ..wire.varint import leb128_bytes, leb128_write
from . import _build
from .device import _cuda_stream, _require

MAX_RENORM_PER_SYMBOL = 3
_U32 = 0xFFFFFFFF
# the precisions a lane may take: Draco's DirectCoded schedule gives 12-20
# (``rans_precision_for_bit_length``); K3's reciprocal division is exact up
# to 20 (``csrc/rans_words.cu``)
MAX_PRECISION = 20


def normalize_tables(counts: torch.Tensor, n_sym: int):
    """Per-lane rANS table normalization on the tensor's device,
    bit-identical to ``entropy/rans.py normalize_freq_counts_batch``, which
    replicates the reference's f64 ``floor(f / total * rp + 0.5)``.

    Exactness: rp is a power of two, so the f64 expression rounds exactly
    once (the division; ``* rp`` and ``+ 0.5`` are exact), with absolute
    error <= rp * 2^-53. The exact value f * rp / total is either ON a
    half-integer (then f / total is dyadic, exact in f64, and both forms
    agree) or at least 1 / (2 * total) >> rp * 2^-53 away from one. So the
    integer form floor((2 * f * rp + total) / (2 * total)) used here equals
    the host's f64 result for every input this encoder can see.

    counts (B, S) int32 and the lanes' common symbol count ``n_sym``.
    Returns (dist (B, S) int32, cums (B, S) int32 exclusive cumulative,
    prec (B,) int32, tiny (B, 4) int32) where tiny rows are
    [counts[:, 0], num_symbols, total, pathological]. A lane is
    pathological when the over-fixup needs more than one decrement per
    entry (err > num_symbols) or its counts are all zero; with the
    round-half-up rule err <= num_symbols always holds, so only an
    all-zero row is flagged in practice."""
    B, S = counts.shape
    dev = counts.device
    c = counts.to(torch.int64)
    nz = c > 0
    ns = S - nz.flip(1).to(torch.int8).argmax(dim=1)             # (B,)
    col = torch.arange(S, dtype=torch.int64, device=dev)
    valid = col[None, :] < ns[:, None]
    f = torch.where(valid, c, 0)
    total = f.sum(dim=1)
    # precision schedule: must mirror the host (bls from the zero bin)
    num_nonzero = int(n_sym) - c[:, 0]
    pow2 = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, dtype=torch.int64, device=dev)
    bl = (num_nonzero[:, None] >= pow2[None, :]).sum(dim=1)
    bls = torch.clamp(bl + 1, 1, 18)
    prec = torch.clamp((3 * bls) // 2, 12, 20)
    rp = torch.ones_like(prec) << prec
    safe_total = torch.clamp(total, min=1)
    dist = ((2 * f * rp[:, None] + safe_total[:, None])
            // (2 * safe_total[:, None]))
    dist = torch.where((dist == 0) & (f > 0), 1, dist)
    err = dist.sum(dim=1) - rp
    # stable-ascending rank order == the unique key (clamped dist, col)
    key = torch.where(valid, dist, -1)
    kcl = torch.clamp(key + 1, 0, (1 << 20) - 1)
    s_pad = 1
    while s_pad < S:
        s_pad *= 2
    combined = kcl * s_pad + col[None, :]
    # under: the whole deficit goes to the stable-order tail
    rows = torch.arange(B, device=dev)
    tgt = combined.argmax(dim=1)
    dist[rows, tgt] += torch.where(err < 0, -err, 0)
    # over: decrement each of the top-err entries by one
    desc = torch.sort(combined, dim=1, descending=True).values
    e_ix = torch.clamp(err, 1, S) - 1
    thresh = desc.gather(1, e_ix[:, None])
    dist = dist - ((err > 0)[:, None] & (combined >= thresh)).to(torch.int64)
    patho = (err > ns) | (total == 0)
    tiny = torch.stack([c[:, 0], ns, total, patho.to(torch.int64)],
                       dim=1).to(torch.int32)
    dist32 = dist.to(torch.int32)
    cums = torch.zeros_like(dist32)
    cums[:, 1:] = torch.cumsum(dist32[:, :-1], dim=1, dtype=torch.int32)
    return dist32, cums, prec.to(torch.int32), tiny


def flip_lanes(symbols: torch.Tensor) -> torch.Tensor:
    """Reversed feed: rANS codes each lane's flattened stream back to
    front. (B, ...) -> (B, n) int32."""
    B = symbols.shape[0]
    return torch.flip(symbols.reshape(B, -1).to(torch.int32), dims=(1,))


def lane_tables_gather(lanes: torch.Tensor, dist: torch.Tensor,
                       cums: torch.Tensor, dtype=torch.int64):
    """Per-symbol (freq, cum) from each lane's own table row, in ``dtype``
    (int64 for the twins' arithmetic)."""
    idx = torch.clamp(lanes.to(torch.int64), 0, dist.shape[1] - 1)
    return dist.to(dtype).gather(1, idx), cums.to(dtype).gather(1, idx)


def words_cap(n: int) -> int:
    """Compacted words per lane: <= 3 renorm bytes per symbol plus <= 3
    carried bytes, 4 to a word."""
    return min(n, (3 * n) // 4 + 2)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def rans_words_scan_ref(symbols, dist, cums, prec, lengths):
    """Plain version of K3: the ``_words_scan_core`` recurrence, one step
    over all lanes at a time. symbols (L, n) int32 unreversed streams;
    dist/cums (L, S) int32 tables; prec, lengths (L,) int32 (lengths clip
    to [0, n]; a lane codes the LAST ``length`` symbols of its row, read
    back to front). Returns (words (L, cap) int32, meta (L, 5) int32),
    both holding uint32 bits: each lane's full words compacted to the row
    front (zeros after), and meta = [nwords, nacc, partial word, packed
    flush state, flush byte count]."""
    L, n = symbols.shape
    dev = symbols.device
    fs, cs = lane_tables_gather(flip_lanes(symbols), dist, cums)
    p = prec.to(torch.int64)
    l_base = 4 << p
    ln = torch.clamp(lengths.to(torch.int64), 0, n)
    zeros = torch.zeros(L, dtype=torch.int64, device=dev)
    state, lo, hi, nacc = l_base.clone(), zeros, zeros, zeros
    words = torch.zeros((L, n), dtype=torch.int64, device=dev)
    flags = torch.zeros((L, n), dtype=torch.bool, device=dev)
    for t in range(n):
        active = ln > t
        f = torch.where(active, fs[:, t], 1)
        limit = (4 * f) << 8
        for _ in range(MAX_RENORM_PER_SYMBOL):
            do = active & (state >= limit)
            b = state & 0xFF
            in_lo = nacc < 4
            sh_lo = 8 * torch.where(in_lo, nacc, 0)
            sh_hi = 8 * torch.where(in_lo, 0, nacc - 4)
            lo = torch.where(do & in_lo, (lo | (b << sh_lo)) & _U32, lo)
            hi = torch.where(do & ~in_lo, (hi | (b << sh_hi)) & _U32, hi)
            nacc = nacc + do.to(torch.int64)
            state = torch.where(do, state >> 8, state)
        new = (((state // f) << p) + state % f + cs[:, t]) & _U32
        state = torch.where(active, new, state)
        fl = nacc >= 4
        words[:, t] = lo
        flags[:, t] = fl
        lo = torch.where(fl, hi, lo)
        hi = torch.where(fl, 0, hi)
        nacc = torch.where(fl, nacc - 4, nacc)
    cap_w = words_cap(n)
    pos = torch.cumsum(flags.to(torch.int64), dim=1) - 1
    target = torch.where(flags & (pos < cap_w), pos, cap_w)
    out = torch.zeros((L, cap_w + 1), dtype=torch.int64, device=dev)
    out.scatter_(1, target, torch.where(flags, words, 0))
    nwords = flags.sum(dim=1)
    st = state - l_base
    nbytes = torch.where(st < (1 << 6), 1, torch.where(
        st < (1 << 14), 2, torch.where(st < (1 << 22), 3, 4)))
    packed = (st + ((nbytes - 1) << (6 + 8 * (nbytes - 1)))) & _U32
    meta = torch.stack([nwords, nacc, lo, packed, nbytes], dim=1)
    return _u32_bits(out[:, :cap_w]), _u32_bits(meta)


def rans_words_scan(symbols, dist, cums, prec, lengths):
    """K3: see ``rans_words_scan_ref`` for the contract, which the kernel
    meets bit for bit. On CUDA one block codes one lane and reads its
    (n,) row as it lies."""
    if symbols.device.type == "cpu":
        return rans_words_scan_ref(symbols, dist, cums, prec, lengths)
    dev = symbols.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _require(symbols.dim() == 2 and symbols.dtype == torch.int32,
             "symbols must be (L, n) int32")
    L, n = symbols.shape
    _require(dist.shape == cums.shape and dist.dim() == 2
             and dist.shape[0] == L and dist.shape[1] > 0,
             "dist/cums must be (L, S) with S > 0")
    for name, t, shape in (("dist", dist, None), ("cums", cums, None),
                           ("prec", prec, (L,)), ("lengths", lengths, (L,))):
        _require(t.device == dev and t.dtype == torch.int32
                 and t.is_contiguous()
                 and (shape is None or tuple(t.shape) == shape),
                 f"{name} must be contiguous int32 on {dev}"
                 + (f" with shape {shape}" if shape else ""))
    cap_w = words_cap(n)
    words = torch.zeros((L, cap_w), dtype=torch.int32, device=dev)
    meta = torch.empty((L, 5), dtype=torch.int32, device=dev)
    if L == 0:
        return words, meta
    sym = symbols.contiguous()
    lib = _build.load()
    rc = lib.tdr_rans_words(sym.data_ptr(), dist.data_ptr(),
                            cums.data_ptr(), int(dist.shape[1]),
                            prec.data_ptr(), lengths.data_ptr(), L, n, cap_w,
                            words.data_ptr(), meta.data_ptr(),
                            _cuda_stream(symbols))
    _build.check(rc, "rans_words_scan")
    rans_words_scan.n_launches += 1
    return words, meta


rans_words_scan.n_launches = 0


def collect_words(words: np.ndarray, meta: np.ndarray, n: int):
    """Host unpack of a words scan: the uint32 word rows viewed
    little-endian ARE the byte streams, then up to 3 partial-word bytes.
    words (L, W) uint32, the leading W >= max(nwords) columns; meta (L, 5)
    uint32. Returns (buffers (L, 3n+8) uint8 without the flush bytes,
    byte counts, packed flush states, flush byte counts)."""
    L = meta.shape[0]
    nwords = meta[:, 0].astype(np.int64)
    if L and int(nwords.max()) > min(words.shape[1], words_cap(n)):
        raise ValueError("rANS words scan overflowed its word capacity")
    naccs = meta[:, 1].astype(np.int64)
    partial = meta[:, 2].astype(np.uint64)
    cap = 3 * n + 8  # true bound (3 renorm bytes/symbol + flush)
    counts = 4 * nwords + naccs
    buffers = np.zeros((L, cap), dtype=np.uint8)
    nb4 = min(words.shape[1] * 4, cap)
    buffers[:, :nb4] = np.ascontiguousarray(words).view(np.uint8)[:, :nb4]
    p_idx = np.arange(3, dtype=np.int64)[None, :]
    pmask = p_idx < naccs[:, None]
    prow = np.repeat(np.arange(L, dtype=np.int64)[:, None], 3, axis=1)
    pcol = 4 * nwords[:, None] + p_idx
    pval = ((partial[:, None] >> (8 * p_idx).astype(np.uint64))
            & np.uint64(0xFF)).astype(np.uint8)
    buffers[prow[pmask], pcol[pmask]] = pval[pmask]
    return buffers, counts, meta[:, 3], meta[:, 4]


def append_flush(buffers, counts, packed, nflush):
    """Flush append (up to 4 state bytes per lane) into the unpacked
    stream buffers; returns per-lane byte counts."""
    L = buffers.shape[0]
    packed = np.asarray(packed).astype(np.uint64)
    nflush = np.asarray(nflush).astype(np.int64)
    b_idx = np.arange(4, dtype=np.int64)[None, :]
    mask = b_idx < nflush[:, None]
    rows = np.repeat(np.arange(L, dtype=np.int64)[:, None], 4, axis=1)
    cols = counts[:, None] + b_idx
    vals = ((packed[:, None] >> (8 * b_idx).astype(np.uint64))
            & np.uint64(0xFF)).astype(np.uint8)
    buffers[rows[mask], cols[mask]] = vals[mask]
    return (counts + nflush).astype(np.int32)


def assemble_payloads(bls, tables, blobs) -> list[bytes]:
    """DirectCoded payload per lane: [tag, bit-length, table,
    leb128(len), stream]."""
    tag = bytes((DIRECT_CODED,))
    return [b"".join((tag, bytes((int(bl),)), tb,
                      leb128_bytes(len(blob)), blob))
            for bl, tb, blob in zip(bls, tables, blobs)]


def encode_group_entropy_device(symbols: torch.Tensor,
                                counts: torch.Tensor) -> list[bytes]:
    """DirectCoded payloads for a topology group: ``symbols`` (B, T, C)
    int32 from the fused step, ``counts`` (B, bins) int32 their per-mesh
    histogram, both on one device. Bit-exact with
    ``encode_symbols(..., DIRECT_CODED)``. Raises ValueError when the
    histogram dropped symbols (its bins were too few for the residuals).
    Lanes flagged pathological take the host's tables and precision into
    the same launch; ``n_patho_lanes`` counts them."""
    B, T, C = symbols.shape
    n_sym = T * C
    dev = symbols.device
    dist, cums, prec, tiny = normalize_tables(counts, n_sym)
    counts0, ns, totals, patho = tiny.cpu().numpy().astype(np.int64).T
    if not np.all(totals == n_sym):
        bad = int(np.flatnonzero(totals != n_sym)[0])
        raise ValueError(
            f"device histogram dropped symbols (lane {bad}: "
            f"{int(totals[bad])}/{n_sym} binned) — hist_bins too small for "
            "the symbol range")
    if patho.any():
        rows = np.flatnonzero(patho)
        rows_dev = torch.from_numpy(rows).to(dev)
        d_host, ns_host = normalize_freq_counts_batch(
            counts[rows_dev].cpu().numpy(), prec[rows_dev].cpu().numpy())
        d = torch.from_numpy(d_host.astype(np.int32)).to(dev)
        dist[rows_dev] = d
        cums[rows_dev] = 0
        cums[rows_dev, 1:] = torch.cumsum(d[:, :-1], dim=1, dtype=torch.int32)
        ns[rows] = ns_host
        encode_group_entropy_device.n_patho_lanes += len(rows)
    # tables come back before the launch, so their serialization on the
    # host overlaps the kernel
    dist_np = dist[:, :max(int(ns.max()), 1)].cpu().numpy().astype(np.int64)
    lengths = torch.full((B,), n_sym, dtype=torch.int32, device=dev)
    words, meta = rans_words_scan(symbols.reshape(B, n_sym), dist, cums,
                                  prec, lengths)
    bls = np.clip(bit_length_u64((n_sym - counts0).astype(np.uint64))
                  + 1, 1, 18)
    tables = serialize_rans_tables_batch(dist_np, ns)
    meta_np = meta.cpu().numpy().view(np.uint32)
    w = max(int(meta_np[:, 0].max()), 1) if B else 1
    words_np = words[:, :w].cpu().numpy().view(np.uint32)
    buffers, cnts, packed, nflush = collect_words(words_np, meta_np, n_sym)
    nbytes = append_flush(buffers, cnts, packed, nflush)
    blobs = [buffers[k, :nbytes[k]].tobytes() for k in range(B)]
    return assemble_payloads(bls, tables, blobs)


encode_group_entropy_device.n_patho_lanes = 0


# ---------------------------------------------------------------------------
# The stream-lane coder: shared or per-lane tables at one precision
# ---------------------------------------------------------------------------


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    """A tensor on ``dev``; numpy input (uint32 tables included) becomes
    int64, which holds every value a lane table or count can take."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)


def _check_precision(precision: int) -> None:
    _require(1 <= int(precision) <= MAX_PRECISION,
             f"precision must be in 1..{MAX_PRECISION}, got {precision}")


# K4's reciprocal division holds for frequencies in (0, 2^21); any other
# sends the step to the kernel's exact path (``csrc/rans_dense.cu``)
DENSE_FAST_MAX_FREQ = 1 << 21


def rans_scan_dense_ref(fs, cs, lengths, precision: int, guard_steps=None):
    """Plain version of K4 (``rans_scan_pallas``), the lax.scan branch of
    ``_rans_scan_lanes``. fs/cs (L, T) integer tensors of uint32 values,
    each lane's pre-gathered (freq, cum) per symbol; lengths (L,): lane l
    codes its first ``lengths[l]`` symbols (clipped to [0, T]) front to
    back. Returns (emitted (L, 3T) uint8, is_byte (L, 3T) bool, states (L,)
    int32 holding uint32 bits): slot ``t * 3 + r`` is the r-th
    renormalisation byte of step t, 0 and False where there is none. A
    frequency of 0 divides as jnp does for uint32: quotient 0xFFFFFFFF,
    remainder 0.

    ``guard_steps``, an (L,) int32 tensor where given, receives each
    lane's count of steps that K4 cannot take on its reciprocal: a
    frequency of 0 or at least 2^21, or a renormalised state that is not
    below ``freq << 10``. Valid streams have none."""
    _check_precision(precision)
    L, T = fs.shape
    dev = fs.device
    p = int(precision)
    f_all = fs.to(torch.int64) & _U32
    c_all = cs.to(torch.int64) & _U32
    ln = torch.clamp(lengths.to(device=dev, dtype=torch.int64), 0, T)
    state = torch.full((L,), 4 << p, dtype=torch.int64, device=dev)
    emitted = torch.zeros((L, T, MAX_RENORM_PER_SYMBOL), dtype=torch.uint8,
                          device=dev)
    is_byte = torch.zeros((L, T, MAX_RENORM_PER_SYMBOL), dtype=torch.bool,
                          device=dev)
    guarded = torch.zeros(L, dtype=torch.int64, device=dev)
    for t in range(T):
        active = ln > t
        f = f_all[:, t]
        limit = ((4 * f) << 8) & _U32
        for r in range(MAX_RENORM_PER_SYMBOL):
            do = active & (state >= limit)
            emitted[:, t, r] = torch.where(do, state & 0xFF, 0).to(
                torch.uint8)
            is_byte[:, t, r] = do
            state = torch.where(do, state >> 8, state)
        zero = f == 0
        guarded += active & (zero | (f >= DENSE_FAST_MAX_FREQ)
                             | (state >= limit))
        safe = torch.where(zero, 1, f)
        q = torch.where(zero, _U32, state // safe)
        m = torch.where(zero, 0, state % safe)
        state = torch.where(active, ((q << p) + m + c_all[:, t]) & _U32,
                            state)
    if guard_steps is not None:
        guard_steps.copy_(guarded)
    return (emitted.reshape(L, -1), is_byte.reshape(L, -1),
            _u32_bits(state))


def rans_scan_dense(fs, cs, lengths, precision: int, guard_steps=None):
    """K4: see ``rans_scan_dense_ref`` for the contract, which the kernel
    meets bit for bit. On CUDA one block codes one lane: it reads the
    lane's fs/cs rows as they lie (int32 or int64 elements) and writes
    every byte and mask slot of the lane's rows in their final layout and
    type, so nothing is transposed, zeroed or cast around the launch."""
    if fs.device.type == "cpu":
        return rans_scan_dense_ref(fs, cs, lengths, precision, guard_steps)
    dev = fs.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _check_precision(precision)
    _require(fs.dim() == 2 and cs.shape == fs.shape and cs.device == dev
             and cs.dtype == fs.dtype
             and fs.dtype in (torch.int32, torch.int64),
             "fs/cs must be (L, T) int32 or int64 of one dtype on one "
             "device")
    L, T = fs.shape
    _require(tuple(lengths.shape) == (L,) and lengths.device == dev,
             f"lengths must be ({L},) on {dev}")
    _require(guard_steps is None or (
        guard_steps.device == dev and guard_steps.dtype == torch.int32
        and tuple(guard_steps.shape) == (L,)
        and guard_steps.is_contiguous()),
        f"guard_steps must be ({L},) contiguous int32 on {dev}")
    fs, cs = fs.contiguous(), cs.contiguous()
    ln = lengths.to(torch.int32).contiguous()
    width = MAX_RENORM_PER_SYMBOL * T
    emitted = torch.empty((L, width), dtype=torch.uint8, device=dev)
    is_byte = torch.empty((L, width), dtype=torch.bool, device=dev)
    states = torch.empty((L,), dtype=torch.int32, device=dev)
    if L and T:
        lib = _build.load()
        rc = lib.tdr_rans_dense(
            fs.data_ptr(), cs.data_ptr(), int(fs.dtype == torch.int64),
            ln.data_ptr(), L, T, int(precision), emitted.data_ptr(),
            is_byte.data_ptr(), states.data_ptr(),
            guard_steps.data_ptr() if guard_steps is not None else None,
            _cuda_stream(fs))
        _build.check(rc, "rans_scan_dense")
        rans_scan_dense.n_launches += 1
    else:  # no step runs: every lane keeps its initial state
        states.fill_(4 << int(precision))
        if guard_steps is not None:
            guard_steps.zero_()
    return emitted, is_byte, states


rans_scan_dense.n_launches = 0


def rans_scan_lanes_dense(symbols, freqs, cums, lengths, precision: int):
    """Counterpart of ``_rans_scan_lanes``: the (freq, cum) pre-gather from
    a shared (S,) or per-lane (L, S) table (symbols clipped to [0, S-1]),
    K4, the flush framing (rans.rs:48-68) and the compaction of each lane's
    real bytes to the row front. Returns (compacted (L, 3T) uint8 with a
    zero tail, counts (L,) int32, packed flush states (L,) int64, flush
    byte counts (L,) int32)."""
    L, T = symbols.shape
    dev = symbols.device
    if freqs.dim() == 1:  # one table for every lane
        freqs, cums = freqs.expand(L, -1), cums.expand(L, -1)
    # int32 holds a normalized table's values, and K4 reads half the bytes
    fs, cs = lane_tables_gather(symbols, freqs, cums, dtype=torch.int32)
    emitted, is_byte, states = rans_scan_dense(fs, cs, lengths, precision)
    st = ((states.to(torch.int64) & _U32) - (4 << int(precision))) & _U32
    nflush = torch.where(st < (1 << 6), 1, torch.where(
        st < (1 << 14), 2, torch.where(st < (1 << 22), 3, 4)))
    packed = (st + ((nflush - 1) << (6 + 8 * (nflush - 1)))) & _U32
    # stable partition: byte k of a lane goes to column k, idle slots
    # (emitted as 0) to a spare column that is dropped
    width = MAX_RENORM_PER_SYMBOL * T
    pos = torch.cumsum(is_byte.to(torch.int64), dim=1) - 1
    target = torch.where(is_byte, pos, width)
    out = torch.zeros((L, width + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, target, emitted)
    counts = is_byte.sum(dim=1).to(torch.int32)
    return out[:, :width], counts, packed, nflush.to(torch.int32)


def zero_frequency_hit(symbols, freqs, lengths) -> torch.Tensor:
    """Whether any lane codes a symbol of frequency 0, as a bool scalar on
    the device of ``symbols``: one gather of a bool table, where the
    pre-gather reads two int64 rows. symbols (L, T), clipped to [0, S-1]
    as the pre-gather clips them; freqs (L, S); a lane codes its first
    ``lengths[l]`` symbols."""
    T = symbols.shape[1]
    idx = torch.clamp(symbols.to(torch.int64), 0, freqs.shape[1] - 1)
    coded = torch.arange(T, device=symbols.device) \
        < lengths.to(torch.int64)[:, None]
    return ((freqs == 0).gather(1, idx) & coded).any()


def rans_encode_lanes(symbols, freqs, cums, lengths, precision: int = 12,
                      dense: bool = False):
    """Encode L lanes of up to T symbols each. symbols (L, T) int (a lane
    codes ``symbols[l, :lengths[l]]`` front to back, i.e. a Draco stream
    fed reversed); freqs/cums (S,) shared or (L, S) per-lane normalized
    tables summing to 2^precision; lengths (L,). Tensors or numpy; the
    work runs on the device of ``symbols``. ``dense`` picks the engine:
    False the words scan (K3), True the dense scan (K4) and its
    compaction, which was slower on an H100. Returns numpy (buffers
    (L, 3T+8) uint8, nbytes (L,) int32), the same bytes either way.

    A coded symbol of frequency 0 raises ValueError: the stream could not
    be decoded, and the JAX package's two engines give different bytes
    for it."""
    _check_precision(precision)
    if not isinstance(symbols, torch.Tensor):
        symbols = torch.from_numpy(np.asarray(symbols).astype(np.int64))
    dev = symbols.device
    freqs, cums, lengths = (_as_tensor(a, dev) for a in (freqs, cums,
                                                         lengths))
    _require(symbols.dim() == 2, "symbols must be (L, T)")
    L, T = symbols.shape
    _require(freqs.shape == cums.shape and freqs.dim() in (1, 2)
             and freqs.shape[-1] > 0
             and (freqs.dim() == 1 or freqs.shape[0] == L),
             f"freqs/cums must be (S,) or ({L}, S) with S > 0")
    _require(tuple(lengths.shape) == (L,), f"lengths must be ({L},)")
    if freqs.dim() == 1:  # one table for every lane
        freqs, cums = freqs.expand(L, -1), cums.expand(L, -1)
    # before either engine: the plain words scan would divide by zero
    _require(not bool(zero_frequency_hit(symbols, freqs, lengths)),
             "a lane codes a symbol of frequency 0")
    if dense:
        compacted, counts, packed, nflush = rans_scan_lanes_dense(
            symbols, freqs, cums, lengths, precision)
        buffers = np.zeros((L, 3 * T + 8), dtype=np.uint8)
        buffers[:, :3 * T] = compacted.cpu().numpy()
        counts = counts.cpu().numpy().astype(np.int64)
        packed, nflush = packed.cpu().numpy(), nflush.cpu().numpy()
    else:
        # K3 codes the LAST length symbols of a row back to front
        dist = freqs.to(torch.int32).contiguous()
        cum2 = cums.to(torch.int32).contiguous()
        prec = torch.full((L,), int(precision), dtype=torch.int32,
                          device=dev)
        words, meta = rans_words_scan(
            symbols.to(torch.int32).flip(1), dist, cum2, prec,
            lengths.to(torch.int32).contiguous())
        meta_np = meta.cpu().numpy().view(np.uint32)
        w = max(int(meta_np[:, 0].max()), 1) if L else 1
        words_np = words[:, :w].cpu().numpy().view(np.uint32)
        buffers, counts, packed, nflush = collect_words(words_np, meta_np, T)
    nbytes = append_flush(buffers, counts, packed, nflush)
    return buffers, nbytes


def encode_streams_device(symbol_streams, freq_counts, precision: int = 12,
                          device=None) -> list[bytes]:
    """Pad streams into lanes on one shared table, run the lane coder on
    ``device`` (None: the card; ``"cpu"`` runs the plain twin) and slice
    each lane's bytes: bit-exact with the host ``RansEncoder`` over
    ``normalize_freq_counts(freq_counts, precision)``."""
    dist = normalize_freq_counts(freq_counts, precision)
    cums = np.concatenate(([0], np.cumsum(dist)[:-1]))
    L = len(symbol_streams)
    T = max(len(s) for s in symbol_streams)
    symbols = np.zeros((L, T), dtype=np.int32)
    lengths = np.zeros(L, dtype=np.int32)
    for i, s in enumerate(symbol_streams):
        symbols[i, :len(s)] = s
        lengths[i] = len(s)
    dev = resolve(device)
    bufs, nbytes = rans_encode_lanes(torch.from_numpy(symbols).to(dev), dist,
                                     cums, lengths, precision=precision)
    return [bufs[i, :nbytes[i]].tobytes() for i in range(L)]


def encode_direct_coded_streams_device(streams, device=None) -> list[bytes]:
    """Full DirectCoded payloads for independent streams with the rANS
    inner loop on ``device`` (None: the card; ``"cpu"`` runs the plain
    twin), bit-exact with the host
    ``encode_symbols(s, n, DIRECT_CODED, w)``. Each stream gets its own
    table; lanes are bucketed by precision (a function of each stream's
    nonzero count), each bucket is one lane-coder call with per-lane
    tables, and the host writes each header (method, bit length, table,
    leb128 blob length)."""
    dev = resolve(device)
    L = len(streams)
    streams = [np.asarray(s, dtype=np.int64).ravel() for s in streams]
    bls = np.empty(L, dtype=np.int64)
    precisions = np.empty(L, dtype=np.int64)
    dists: list[np.ndarray] = []
    for i, s in enumerate(streams):
        num_nonzero = int(np.count_nonzero(s))
        bl = int(bit_length_u64(np.asarray([num_nonzero]))[0]) + 1
        bls[i] = max(1, min(18, bl))
        precisions[i] = rans_precision_for_bit_length(int(bls[i]))
        counts = np.bincount(s, minlength=1)
        dists.append(normalize_freq_counts(counts, int(precisions[i])))

    blobs: list[bytes] = [b""] * L
    for prec in sorted(set(precisions.tolist())):
        lanes = np.flatnonzero(precisions == prec)
        T = max(1, max(len(streams[i]) for i in lanes))
        S = max(len(dists[i]) for i in lanes)
        sym = np.zeros((len(lanes), T), dtype=np.int32)
        lengths = np.zeros(len(lanes), dtype=np.int32)
        freqs = np.zeros((len(lanes), S), dtype=np.int64)
        cums = np.zeros((len(lanes), S), dtype=np.int64)
        for k, i in enumerate(lanes):
            sym[k, :len(streams[i])] = streams[i][::-1]  # reversed feed
            lengths[k] = len(streams[i])
            d = dists[i]
            freqs[k, :len(d)] = d
            cums[k, 1:len(d)] = np.cumsum(d)[:-1]
        bufs, nbytes = rans_encode_lanes(torch.from_numpy(sym).to(dev), freqs,
                                         cums, lengths, precision=int(prec))
        for k, i in enumerate(lanes):
            blobs[i] = bufs[k, :nbytes[k]].tobytes()

    out: list[bytes] = []
    for i in range(L):
        w = ByteWriter()
        w.write_u8(DIRECT_CODED)
        w.write_u8(int(bls[i]))
        serialize_rans_table(dists[i], w)
        leb128_write(len(blobs[i]), w)
        w.write_bytes(blobs[i])
        out.append(w.getvalue())
    return out


# ---------------------------------------------------------------------------
# The lane decoder
# ---------------------------------------------------------------------------


def decode_dtype(precision: int, S: int):
    """(dtype, sentinel) of ``rans_decode_lanes``' output, as the JAX
    package picks them: its packed P <= 14 scan (alphabets up to 2^16)
    returns uint8 at P == 12 with S <= 256, else uint16, with 0 past a
    lane's count; its generic scan returns int16 where S fits, else int32,
    with -1."""
    if precision <= 14 and S <= (1 << 16):
        return (torch.uint8 if precision == 12 and S <= 256
                else torch.uint16), 0
    return (torch.int16 if S <= (1 << 15) - 1 else torch.int32), -1


def _decode_inputs(buffers, nbytes, freqs, counts, precision: int):
    """Checked tensors of a lane decode on the buffers' device, the
    inclusive cumulative rows that the symbol search reads, and the output
    length T: max(counts), or 2 * cap when no lane has a symbol. Every
    table a lane with symbols decodes on must sum to 2^precision. Anything
    else is refused (one compare per table and a readback), as
    ``zero_frequency_hit`` refuses a table the encoder cannot code on: a
    remainder at or past the table's total has no symbol."""
    _check_precision(precision)
    _require(isinstance(buffers, torch.Tensor) and buffers.dim() == 2
             and buffers.dtype == torch.uint8,
             "buffers must be an (L, cap) uint8 tensor")
    dev = buffers.device
    L, cap = buffers.shape
    # host copies of the per-lane scalars, without a round trip through
    # the device where the caller gave numpy
    nbytes_h, counts_h = (
        (a.cpu() if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.asarray(a))).to(torch.int64)
        for a in (nbytes, counts))
    nbytes, freqs, counts = (_as_tensor(a, dev)
                             for a in (nbytes, freqs, counts))
    _require(tuple(nbytes.shape) == (L,) and tuple(counts.shape) == (L,),
             f"nbytes/counts must be ({L},)")
    _require(freqs.dim() in (1, 2) and freqs.shape[-1] > 0
             and (freqs.dim() == 1 or freqs.shape[0] == L),
             f"freqs must be (S,) or ({L}, S) with S > 0")
    inc = torch.cumsum(freqs.to(torch.int64) & _U32, dim=-1)
    used = counts > 0
    off = (inc[..., -1] != 1 << int(precision)) \
        & (used if freqs.dim() == 2 else used.any())
    if bool(off.any()):
        k = int(torch.nonzero(off.reshape(-1))[0, 0])
        raise ValueError(
            f"table {k} is not a normalized rANS table at precision "
            f"{precision}: its frequencies must sum to "
            f"{1 << int(precision)}")
    bad = (counts_h > 0) & ((nbytes_h < 1) | (nbytes_h > cap))
    if bool(bad.any()):
        k = int(torch.nonzero(bad)[0, 0])
        raise ValueError(f"lane {k}: a stream of {int(counts_h[k])} symbols "
                         f"needs 1..{cap} bytes, got {int(nbytes_h[k])}")
    T = int(counts_h.max()) if L else 0
    T = T if T > 0 else 2 * cap
    return nbytes, inc, counts, T


def rans_decode_lanes_ref(buffers, nbytes, freqs, counts,
                          precision: int = 12) -> torch.Tensor:
    """Plain version of D1, with the output contract of the JAX
    ``rans_decode_lanes`` but neither a slot table nor a ``cums`` argument
    (both follow from ``freqs``): buffers (L, cap) uint8 streams of nbytes
    (L,) bytes; counts (L,) symbols per lane; freqs (S,) shared or (L, S)
    per lane, normalized at ``precision``.
    The symbol of a remainder r is the first one whose inclusive
    cumulative frequency exceeds r (``torch.searchsorted(..., right=True)``
    on the int64 row), so a symbol of frequency 0, which shares its
    inclusive sum with its predecessor, is never returned. Returns (L, T)
    symbols in decode order (the reverse of the coded order),
    T = max(counts), in ``decode_dtype(precision, S)`` with its sentinel
    past each count. A lane with symbols needs 1..cap bytes (JAX would
    read a wrapped index for nbytes == 0) and a normalized table;
    ValueError otherwise."""
    nbytes, inc, counts, T = _decode_inputs(buffers, nbytes, freqs, counts,
                                            precision)
    dev = buffers.device
    L, cap = buffers.shape
    S = inc.shape[-1]
    dtype, sentinel = decode_dtype(precision, S)
    n = torch.clamp(counts.to(torch.int64), 0, T)
    out = torch.full((L, T), sentinel, dtype=torch.int64, device=dev)
    if not L or not bool((n > 0).any()):
        return out.to(dtype)
    p = int(precision)
    l_base, rmask = 4 << p, (1 << p) - 1
    lane = torch.arange(L, device=dev)
    bufs = buffers.to(torch.int64)
    if inc.dim() == 1:
        inc = inc[None].expand(L, -1)
    inc = inc.contiguous()
    # exclusive sums: a zero in front of the inclusive row
    exc = torch.cat([inc.new_zeros((L, 1)), inc[:, :-1]], dim=1)
    pos = torch.clamp(nbytes.to(torch.int64) - 1, 0, cap - 1)
    meta = bufs[lane, pos]
    flag = meta >> 6
    x = torch.zeros(L, dtype=torch.int64, device=dev)
    for k in range(3):
        do = flag > k
        pos = torch.where(do, pos - 1, pos)
        byte = bufs[lane, torch.clamp(pos, min=0)]
        x = torch.where(do, ((x << 8) | byte) & _U32, x)
    x = ((x | ((meta & 0x3F) << (8 * flag))) + l_base) & _U32
    for t in range(T):
        active = n > t
        for _ in range(MAX_RENORM_PER_SYMBOL):
            need = active & (x < l_base) & (pos > 0)
            pos = torch.where(need, pos - 1, pos)
            byte = bufs[lane, torch.clamp(pos, min=0)]
            x = torch.where(need, (x * 256 + byte) & _U32, x)
        r = x & rmask
        s = torch.searchsorted(inc, r[:, None], right=True)[:, 0]
        s = torch.clamp(s, max=S - 1)
        c = exc[lane, s]
        new = ((x >> p) * (inc[lane, s] - c) + r - c) & _U32
        x = torch.where(active, new, x)
        out[:, t] = torch.where(active, s, sentinel)
    return out.to(dtype)


def rans_decode_lanes(buffers, nbytes, freqs, counts,
                      precision: int = 12) -> torch.Tensor:
    """D1: see ``rans_decode_lanes_ref`` for the contract, which the kernel
    meets bit for bit. Runs on the device of ``buffers``; the other inputs
    may be tensors or numpy. On CUDA the kernel reads each lane's inclusive
    cumulative row (built here by one cumsum) and writes the (L, T) output
    in its final dtype."""
    if not isinstance(buffers, torch.Tensor) or buffers.device.type == "cpu":
        return rans_decode_lanes_ref(buffers, nbytes, freqs, counts,
                                     precision)
    dev = buffers.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    nbytes, inc, counts, T = _decode_inputs(buffers, nbytes, freqs, counts,
                                            precision)
    L, cap = buffers.shape
    _require(cap < 1 << 31, "a lane's stream must be under 2^31 bytes")
    S = inc.shape[-1]
    dtype, sentinel = decode_dtype(precision, S)
    bufs = buffers.contiguous()
    nb = nbytes.to(torch.int32).contiguous()
    inc32 = inc.to(torch.int32).contiguous()  # checked: at most 2^precision
    cn = torch.clamp(counts, 0, T).to(torch.int32)
    out = torch.empty((L, T), dtype=dtype, device=dev)
    if L and T:
        lib = _build.load()
        rc = lib.tdr_rans_decode(bufs.data_ptr(), cap, nb.data_ptr(),
                                 inc32.data_ptr(), S,
                                 S if inc.dim() == 2 else 0,
                                 cn.data_ptr(), L, T, int(precision),
                                 sentinel, out.element_size(),
                                 out.data_ptr(), _cuda_stream(buffers))
        _build.check(rc, "rans_decode_lanes")
        rans_decode_lanes.n_launches += 1
    return out


rans_decode_lanes.n_launches = 0

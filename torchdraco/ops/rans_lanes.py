"""Multi-lane rANS encode of a topology group's symbol streams.

Counterpart of the encode side of ``tpudraco/ops/rans_lanes.py``: one lane
is one mesh's DirectCoded stream, coded on its own normalized table at its
own precision. The flow is that of ``_group_entropy_device_tables``:

1. ``normalize_tables`` builds every lane's table and precision on the
   device (int64, bit-identical to the host's f64 normalization);
2. the host reads a (B, 4) summary, raises on a histogram deficit, and
   swaps in host tables for lanes flagged pathological;
3. one launch of ``rans_words_scan`` (K3, ``csrc/rans_words.cu``) codes all
   lanes: reversed feed, per-lane (freq, cum) lookup, the recurrence, word
   packing, compaction and flush framing;
4. the host unpacks the words into byte streams (``collect_words``,
   ``append_flush``) and frames the payloads (``assemble_payloads``).

The plain twins (``flip_lanes``, ``lane_tables_gather``,
``rans_words_scan_ref``) are the spec for K3 and the path of CPU tensors.
They carry rANS states in int64 masked with 0xFFFFFFFF, since torch has no
division, remainder, shift or compare on uint32. The JAX package's
readback buckets, lane chunking and compaction modes existed for a
high-latency link and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _host
from . import _build
from .device import _cuda_stream, _require

MAX_RENORM_PER_SYMBOL = 3
_U32 = 0xFFFFFFFF


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
                       cums: torch.Tensor):
    """Per-symbol (freq, cum) from each lane's own table row, int64."""
    idx = torch.clamp(lanes.to(torch.int64), 0, dist.shape[1] - 1)
    return (dist.to(torch.int64).gather(1, idx),
            cums.to(torch.int64).gather(1, idx))


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
    meets bit for bit. On CUDA the kernel reads the symbols transposed to
    (n, L), so the lanes of a warp load neighbouring addresses."""
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
    sym_t = symbols.t().contiguous()
    lib = _build.load()
    rc = lib.tdr_rans_words(sym_t.data_ptr(), dist.data_ptr(),
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
    tag = bytes((_host.DIRECT_CODED,))
    return [b"".join((tag, bytes((int(bl),)), tb,
                      _host.leb128_bytes(len(blob)), blob))
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
        d_host, ns_host = _host.normalize_freq_counts_batch(
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
    bls = np.clip(_host.bit_length_u64((n_sym - counts0).astype(np.uint64))
                  + 1, 1, 18)
    tables = _host.serialize_rans_tables_batch(dist_np, ns)
    meta_np = meta.cpu().numpy().view(np.uint32)
    w = max(int(meta_np[:, 0].max()), 1) if B else 1
    words_np = words[:, :w].cpu().numpy().view(np.uint32)
    buffers, cnts, packed, nflush = collect_words(words_np, meta_np, n_sym)
    nbytes = append_flush(buffers, cnts, packed, nflush)
    blobs = [buffers[k, :nbytes[k]].tobytes() for k in range(B)]
    return assemble_payloads(bls, tables, blobs)


encode_group_entropy_device.n_patho_lanes = 0

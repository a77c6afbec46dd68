"""Host (CPU) rANS / RAbS entropy coders, bit-exact with the Draco bitstream.

This is the reference implementation; the vectorized multi-lane device
version lives in torchdraco.ops.rans_lanes and the native C++ fast path in
torchdraco.native. All three must produce identical bytes.

Reference behavior:
  - draco-oxide/src/encode/entropy/rans.rs:10-69   (RansCoder, precision 12)
  - draco-oxide/src/encode/entropy/rans.rs:71-128  (RabsCoder, precision 8)
  - draco-oxide/src/encode/entropy/rans.rs:131-256 (RansSymbolEncoder:
    frequency normalization + table serialization + payload framing)
  - draco-oxide/src/decode/entropy/rans.rs         (decoder mirrors)
  - draco-oxide/src/shared/entropy/mod.rs          (table build, constants)
"""

from __future__ import annotations

import numpy as np

from ..wire.byte_io import ByteReader, ByteWriter, ReverseByteReader
from ..wire.varint import leb128_read, leb128_write

L_RANS_BASE = 4096
DEFAULT_RANS_PRECISION = 12
DEFAULT_RABS_PRECISION = 8


def default_l_rans_base(precision: int) -> int:
    return (1 << precision) << 2


def _flush_state(state: int, out: bytearray) -> None:
    """Write the final coder state with a 2-bit size flag packed in the top
    bits (encode/entropy/rans.rs:48-68)."""
    if state < (1 << 6):
        out.append(state)
    elif state < (1 << 14):
        out += ((0x01 << 14) + state).to_bytes(2, "little")
    elif state < (1 << 22):
        out += ((0x02 << 22) + state).to_bytes(3, "little")
    elif state < (1 << 30):
        out += ((0x03 << 30) + state).to_bytes(4, "little")
    else:
        raise ValueError("rANS state too large at flush")


def _read_initial_state(rev, l_base: int) -> int:
    """Reconstruct the flushed state from the stream tail
    (decode/entropy/rans.rs:30-56)."""
    metadata = rev.read_u8_back()
    flag = metadata >> 6
    if flag == 0:
        state = 0
    elif flag == 1:
        state = rev.read_u8_back()
    elif flag == 2:
        state = rev.read_u16_back()
    else:
        state = rev.read_u24_back()
    state |= (metadata & 0x3F) << (flag << 3)
    return state + l_base


class RansEncoder:
    """Byte-wise rANS encoder over a normalized frequency table.

    ``freq_counts`` must sum to 1 << precision. Symbols are buffered and the
    sequential state recurrence runs at flush — in native C++ when available
    (torchdraco.native), else the Python reference loop."""

    def __init__(self, freq_counts, precision: int = DEFAULT_RANS_PRECISION,
                 l_rans_base: int | None = None) -> None:
        freq_counts = np.asarray(freq_counts, dtype=np.int64)
        if int(freq_counts.sum()) != (1 << precision):
            raise ValueError(
                f"freq counts sum {int(freq_counts.sum())} != 2^{precision}")
        self.precision = precision
        self.l_base = l_rans_base if l_rans_base is not None else default_l_rans_base(precision)
        self.freqs = freq_counts
        self.cums = np.concatenate(([0], np.cumsum(freq_counts)[:-1]))
        self._chunks: list[np.ndarray] = []

    def write(self, idx: int) -> None:
        self._chunks.append(np.asarray([idx], dtype=np.int64))

    def write_all(self, symbols) -> None:
        self._chunks.append(np.asarray(symbols, dtype=np.int64))

    def _encode_python(self, symbols: np.ndarray) -> bytes:
        freqs = self.freqs
        cums = self.cums
        precision = self.precision
        base_sh = self.l_base >> precision
        state = self.l_base
        out = bytearray()
        for s in symbols.tolist():
            freq = int(freqs[s])
            limit = (base_sh * freq) << 8
            while state >= limit:
                out.append(state & 0xFF)
                state >>= 8
            state = ((state // freq) << precision) + state % freq + int(cums[s])
        _flush_state(state - self.l_base, out)
        return bytes(out)

    def flush(self) -> bytes:
        symbols = (np.concatenate(self._chunks) if self._chunks
                   else np.zeros(0, dtype=np.int64))
        from .. import native
        blob = native.rans_encode(symbols, self.freqs, self.cums,
                                  self.precision, self.l_base) \
            if native.load_library() is not None else None
        if blob is None:
            blob = self._encode_python(symbols)
        return blob


class RabsEncoder:
    """Binary rANS coder with a fixed zero-symbol probability byte
    (encode/entropy/rans.rs:71-128). Note: renormalization is a single
    ``if``, not a loop, mirroring the reference. Bits are buffered and
    encoded at flush (native C++ when available)."""

    def __init__(self, freq_count_0: int, precision: int = DEFAULT_RABS_PRECISION,
                 l_rabs_base: int | None = None) -> None:
        self.precision = precision
        self.freq0 = freq_count_0
        self.freq1 = (1 << precision) - freq_count_0
        self.l_base = l_rabs_base if l_rabs_base is not None else L_RANS_BASE
        self._bits: list[int] = []  # single writes not yet in _chunks
        self._chunks: list[np.ndarray] = []  # uint8 0 / 1

    def write(self, value: int) -> None:
        self._bits.append(1 if value > 0 else 0)

    def write_all(self, bits) -> None:
        """Every element as a bit: set where its integer part is
        positive."""
        b = np.asarray(bits).ravel()
        if b.dtype.kind in "bu":
            b = b != 0
        elif b.dtype.kind == "i":
            b = b > 0
        else:
            b = np.fromiter((int(x) > 0 for x in b.tolist()), bool, b.size)
        self._take_singles()
        self._chunks.append(b.view(np.uint8))

    def _take_singles(self) -> None:
        if self._bits:
            self._chunks.append(np.asarray(self._bits, dtype=np.uint8))
            self._bits = []

    def _encode_python(self, bits) -> bytes:
        state = self.l_base
        out = bytearray()
        base_sh = self.l_base >> self.precision
        for b in bits:
            freq = self.freq1 if b else self.freq0
            if state >= (base_sh * freq) << 8:
                out.append(state & 0xFF)
                state >>= 8
            q, r = divmod(state, freq)
            state = (q << self.precision) + r + (0 if b else self.freq1)
        _flush_state(state - self.l_base, out)
        return bytes(out)

    def flush(self) -> bytes:
        from .. import native
        self._take_singles()
        bits = (np.concatenate(self._chunks) if self._chunks
                else np.zeros(0, dtype=np.uint8))
        blob = native.rabs_encode(bits, self.freq0, self.precision,
                                  self.l_base)
        if blob is None:
            blob = self._encode_python(bits.tolist())
        return blob


class RansDecoder:
    """Decodes symbols back-to-front from a forward reader; consumes
    ``offset`` bytes of the stream (the whole rANS blob). ``read_all`` uses
    the native C++ path when no incremental read has started."""

    def __init__(self, reader: ByteReader, offset: int, freq_counts,
                 precision: int = DEFAULT_RANS_PRECISION,
                 l_rans_base: int | None = None) -> None:
        self.precision = precision
        self.l_base = l_rans_base if l_rans_base is not None else default_l_rans_base(precision)
        self._blob = reader.read_bytes(offset)
        self._started = False
        self.rev = None
        self.state = 0
        # int32 storage: every count/cum fits (sum == 2^P <= 2^20) and the
        # native decoder takes int32 — int64 here forced a full copy of
        # freqs + cums + the 2^P-entry slot table on EVERY read_all call
        freq_counts = np.asarray(freq_counts, dtype=np.int64)
        if int(freq_counts.sum()) != (1 << precision):
            raise ValueError("freq counts incompatible with precision")
        self.freqs = freq_counts.astype(np.int32)
        cums = np.zeros(len(freq_counts), dtype=np.int32)
        np.cumsum(self.freqs[:-1], out=cums[1:])
        self.cums = cums
        self._slots = None

    @property
    def slots(self) -> np.ndarray:
        """Slot table mapping r in [0, 2^P) -> symbol index. Built
        lazily: the native bulk path builds its own in C++ (the
        np.repeat here is costly at the deep direct-coded precisions),
        so only the incremental Python read() pays it."""
        if self._slots is None:
            self._slots = np.repeat(
                np.arange(len(self.freqs), dtype=np.int32), self.freqs)
        return self._slots

    def _start_python(self) -> None:
        if not self._started:
            self.rev = ReverseByteReader(memoryview(self._blob))
            self.state = _read_initial_state(self.rev, self.l_base)
            self._started = True

    def read(self) -> int:
        self._start_python()
        state = self.state
        l_base = self.l_base
        while state < l_base:
            state = state * 256 + self.rev.read_u8_back()
        q, r = divmod(state, 1 << self.precision)
        idx = int(self.slots[r])
        self.state = q * int(self.freqs[idx]) + r - int(self.cums[idx])
        return idx

    def read_all(self, n: int) -> np.ndarray:
        if not self._started:
            from .. import native
            if native.load_library() is not None:
                out = native.rans_decode_auto(self._blob, self.freqs,
                                              self.cums, self.precision,
                                              self.l_base, n)
                if out is not None:
                    self._started = True  # python state no longer valid
                    return out.astype(np.int64)
        out = np.empty(n, dtype=np.int64)
        for i in range(n):
            out[i] = self.read()
        return out


class RabsDecoder:
    def __init__(self, reader: ByteReader, offset: int, freq_count_0: int,
                 precision: int = DEFAULT_RABS_PRECISION,
                 l_rabs_base: int | None = None) -> None:
        self.precision = precision
        self.freq0 = freq_count_0
        self.freq1 = (1 << precision) - freq_count_0
        if freq_count_0 >= (1 << precision):
            raise ValueError("invalid freq_count_0")
        self.l_base = l_rabs_base if l_rabs_base is not None else L_RANS_BASE
        self._blob = reader.read_bytes(offset)
        self._started = False
        self.rev = None
        self.state = 0

    def _start_python(self) -> None:
        if not self._started:
            self.rev = ReverseByteReader(memoryview(self._blob))
            self.state = _read_initial_state(self.rev, self.l_base)
            self._started = True

    def read(self) -> int:
        self._start_python()
        if self.state < self.l_base:
            self.state = (self.state << 8) + self.rev.read_u8_back()
        x = self.state
        q = x >> self.precision
        r = x & ((1 << self.precision) - 1)
        xn = q * self.freq1
        if r < self.freq1:
            self.state = xn + r
            return 1
        self.state = x - xn - self.freq1
        return 0

    def read_all(self, n: int) -> np.ndarray:
        if not self._started:
            from .. import native
            if native.load_library() is not None:
                out = native.rabs_decode(self._blob, self.freq0,
                                         self.precision, self.l_base, n)
                if out is not None:
                    self._started = True
                    return out.astype(np.int64)
        out = np.empty(n, dtype=np.int64)
        for i in range(n):
            out[i] = self.read()
        return out


def normalize_freq_counts(freq_counts, precision: int) -> np.ndarray:
    """Normalize raw counts to sum to 1 << precision, replicating the
    reference's rounding + greedy fixup (encode/entropy/rans.rs:156-190).
    Trailing zero-count symbols are dropped."""
    freq_counts = np.asarray(freq_counts, dtype=np.int64)
    nz = np.nonzero(freq_counts)[0]
    if len(nz) == 0:
        raise ValueError("cannot build rANS table from all-zero counts")
    num_symbols = int(nz[-1]) + 1
    freqs = freq_counts[:num_symbols]
    total = float(freqs.sum())
    rp = 1 << precision
    # (prob * rp + 0.5) as usize  == floor for non-negative values
    dist = np.floor(freqs.astype(np.float64) / total * rp + 0.5).astype(np.int64)
    dist[(dist == 0) & (freqs > 0)] = 1
    total_rans = int(dist.sum())
    if total_rans != rp:
        order = np.argsort(dist, kind="stable")
        if total_rans < rp:
            dist[order[-1]] += rp - total_rans
        else:
            err = total_rans - rp
            i = num_symbols - 1
            while err > 0:
                dist[order[i]] -= 1
                i -= 1
                err -= 1
    assert int(dist.sum()) == rp
    return dist


def normalize_freq_counts_batch(counts: np.ndarray,
                                precisions: np.ndarray):
    """Batched normalize_freq_counts over the rows of a (B, S) count
    matrix with per-row precisions. Returns (dist (B, S) int64,
    num_symbols (B,)): row i's table is dist[i, :num_symbols[i]].

    Bit-identical to per-row normalize_freq_counts (pinned by tests); the
    device batch encoder builds hundreds of per-mesh tables per dispatch,
    where the per-row python call overhead dominates the actual math."""
    counts = np.asarray(counts, dtype=np.int64)
    B, S = counts.shape
    precisions = np.broadcast_to(np.asarray(precisions, dtype=np.int64), (B,))
    nz = counts > 0
    if not nz.any(axis=1).all():
        raise ValueError("cannot build rANS table from all-zero counts")
    num_symbols = S - np.argmax(nz[:, ::-1], axis=1)  # last nonzero + 1
    col = np.arange(S)
    valid = col[None, :] < num_symbols[:, None]
    f = np.where(valid, counts, 0)
    total = f.sum(axis=1, dtype=np.int64).astype(np.float64)
    rp = (np.int64(1) << precisions)
    dist = np.floor(f.astype(np.float64) / total[:, None]
                    * rp[:, None].astype(np.float64) + 0.5).astype(np.int64)
    dist[(dist == 0) & (f > 0)] = 1
    err = dist.sum(axis=1) - rp
    if (err != 0).any():
        # the scalar fixup targets entries by stable-ascending argsort of
        # dist; padding sorts first under key -1, so the valid entries keep
        # their relative (stable) order and occupy the tail
        key = np.where(valid, dist, -1)
        order = np.argsort(key, axis=1, kind="stable")
        under = err < 0
        if under.any():
            dist[under, order[under, -1]] += -err[under]
        over = err > 0
        if over.any():
            safe = err <= num_symbols  # one decrement per entry max
            sel = over[:, None] & safe[:, None] & (
                col[None, :] >= (S - np.maximum(err, 0))[:, None])
            rows = np.broadcast_to(np.arange(B)[:, None], (B, S))
            dist[rows[sel], order[sel]] -= 1
            for b in np.flatnonzero(over & ~safe):  # pathological: scalar
                d = normalize_freq_counts(counts[b, :num_symbols[b]],
                                          int(precisions[b]))
                dist[b] = 0
                dist[b, :len(d)] = d
    assert np.array_equal(dist.sum(axis=1), rp)
    return dist, num_symbols


def serialize_rans_table(dist: np.ndarray, writer: ByteWriter) -> None:
    """Serialize a normalized frequency table (encode/entropy/rans.rs:194-230):
    leb128 symbol count; per symbol one byte with a 2-bit token (0-2 = number
    of extra bytes, 3 = zero-run with 6-bit offset), byte-identical to the
    reference's per-entry loop including the >=65-zero-run quirk where the
    reference writes ((64<<2)|3) truncated to u8 == 3.

    Delegates to serialize_rans_tables_batch (B=1) so the quirk-critical
    token layout has exactly ONE implementation; only the (unreachable for
    normalized tables) num_symbols >= 2^21 case keeps a scalar leb128."""
    dist = np.asarray(dist, dtype=np.int64)
    if len(dist) >= (1 << 28):
        raise ValueError("rANS table too large to serialize")
    if len(dist) == 0:
        leb128_write(0, writer)
        return
    writer.write_bytes(serialize_rans_tables_batch(
        dist[None, :], np.asarray([len(dist)]))[0])


def serialize_rans_tables_batch(dist: np.ndarray,
                                num_symbols: np.ndarray) -> list[bytes]:
    """Batched serialize_rans_table over the rows of a (B, S) dist matrix
    (row b's table is dist[b, :num_symbols[b]]). Byte-identical to the
    per-row serializer (pinned by tests) in ONE vectorized pass over all
    lanes — the per-row python/numpy call overhead dominates the device
    batch encoder's assembly stage at B in the hundreds."""
    dist = np.asarray(dist, dtype=np.int64)
    B, S = dist.shape
    ns = np.asarray(num_symbols, dtype=np.int64)
    col = np.arange(S)
    valid = (col[None, :] < ns[:, None]) & (dist > 0)
    bidx, cols = np.nonzero(valid)          # row-major: lanes contiguous
    freqs = dist[bidx, cols]
    if len(freqs) and int(freqs.max()) >= (1 << 22):
        raise ValueError("frequency too large for table serialization")
    if (ns >= (1 << 28)).any():
        # a >=2^28-entry table is multiple GB serialized — practical
        # ceiling, not a wire limit (the scalar reference loop is
        # unbounded; deep -qp with symbol_coding="auto"/"length" never
        # builds tables this wide)
        raise ValueError("num_symbols too large to serialize a "
                         "DirectCoded table (use symbol_coding='auto')")
    endz = (ns > 0) & (dist[np.arange(B), np.maximum(ns - 1, 0)] <= 0)
    if endz.any():
        raise ValueError("rANS table must end with a nonzero frequency")

    first = np.ones(len(bidx), bool)
    first[1:] = bidx[1:] != bidx[:-1]
    prev = np.empty_like(cols)
    prev[1:] = cols[:-1]
    prev[first] = -1
    gap = cols - prev - 1
    run_len = np.where(gap > 64, gap - 63, (gap > 0).astype(np.int64))
    extra = ((freqs >= (1 << 6)).astype(np.int64)
             + (freqs >= (1 << 14)).astype(np.int64))
    seg = run_len + 1 + extra

    # leb128 prefix for num_symbols (1-4 bytes for ns < 2^28)
    plen = (1 + (ns >= (1 << 7)) + (ns >= (1 << 14))
            + (ns >= (1 << 21)))
    token_total = np.bincount(bidx, weights=seg, minlength=B).astype(
        np.int64)
    lane_len = plen + token_total
    lane_start = np.concatenate([[0], np.cumsum(lane_len)[:-1]])
    out = np.zeros(int(lane_len.sum()), dtype=np.uint8)

    # prefixes
    v = ns
    out[lane_start] = (v & 0x7F) | np.where(plen > 1, 0x80, 0)
    m2 = plen >= 2
    out[lane_start[m2] + 1] = ((v[m2] >> 7) & 0x7F) \
        | np.where(plen[m2] > 2, 0x80, 0)
    m3 = plen >= 3
    out[lane_start[m3] + 2] = ((v[m3] >> 14) & 0x7F) \
        | np.where(plen[m3] > 3, 0x80, 0)
    m4 = plen >= 4
    out[lane_start[m4] + 3] = (v[m4] >> 21) & 0x7F

    # entry offsets: global exclusive cumsum of seg, re-based per lane
    goff = np.concatenate([[0], np.cumsum(seg)[:-1]])
    lane_tok0 = np.concatenate([[0], np.cumsum(token_total)[:-1]])
    off = (lane_start + plen)[bidx] + (goff - lane_tok0[bidx])

    if int(run_len.sum()):
        starts = np.repeat(off, run_len)
        intra = (np.arange(len(starts))
                 - np.repeat(np.concatenate([[0], np.cumsum(run_len)[:-1]]),
                             run_len))
        out[starts + intra] = 3  # degraded single-zero tokens (the quirk)
        has_run = gap > 0
        tok = (((np.minimum(gap, 64) - 1) << 2) | 3) & 0xFF
        out[(off + run_len - 1)[has_run]] = tok[has_run]
    pos0 = off + run_len
    out[pos0] = ((freqs << 2) | extra) & 0xFF
    e1 = extra >= 1
    out[pos0[e1] + 1] = (freqs[e1] >> 6) & 0xFF
    e2 = extra == 2
    out[pos0[e2] + 2] = (freqs[e2] >> 14) & 0xFF

    ob = out.tobytes()
    return [ob[lane_start[b]:lane_start[b] + lane_len[b]]
            for b in range(B)]


def parse_rans_table(reader: ByteReader) -> np.ndarray:
    """Inverse of serialize_rans_table (decode/entropy/rans.rs:162-188)."""
    num_symbols = leb128_read(reader)
    # a corrupt count must not bomb the allocator: each serialized token
    # byte covers at most 64 table entries (the zero-run cap), so a
    # valid table never claims more than 64 x the remaining bytes
    if num_symbols > 64 * max(reader.remaining(), 1):
        raise ValueError("corrupt rANS table: num_symbols exceeds the "
                         "remaining stream")
    # native fast path: the per-byte token loop below is slow in Python
    # (it was the largest stage of a grouped corpus decode); the C++ twin parses the same tokens and returns the bytes consumed.
    # None (corrupt stream) falls through so the canonical errors raise.
    from .. import native
    got = native.parse_rans_table_body(
        reader.buf[reader.pos:], num_symbols)
    if got is not None:
        dist, consumed = got
        reader.pos += consumed
        return dist
    dist = np.zeros(num_symbols, dtype=np.int64)
    i = 0
    while i < num_symbols:
        count = reader.read_u8()
        token = count & 3
        if token == 3:
            offset = count >> 2
            if i + offset >= num_symbols:
                raise ValueError("invalid zero-run offset in rANS table")
            i += offset  # entries already zero
        else:
            freq = count >> 2
            for j in range(token):
                freq |= reader.read_u8() << (8 * (j + 1) - 2)
            dist[i] = freq
        i += 1
    return dist


class RansSymbolEncoder:
    """Frequency-table header + framed rANS payload
    (encode/entropy/rans.rs:131-256). ``flush`` writes leb128 byte-length
    followed by the rANS blob into ``writer``."""

    def __init__(self, writer: ByteWriter, freq_counts,
                 precision: int = DEFAULT_RANS_PRECISION,
                 l_rans_base: int | None = None) -> None:
        dist = normalize_freq_counts(freq_counts, precision)
        serialize_rans_table(dist, writer)
        self.writer = writer
        self.num_symbols = len(dist)
        self.coder = RansEncoder(dist, precision, l_rans_base)

    def write(self, idx: int) -> None:
        if idx >= self.num_symbols:
            raise ValueError("invalid symbol index")
        self.coder.write(idx)

    def write_all(self, symbols) -> None:
        self.coder.write_all(symbols)

    def flush(self) -> None:
        blob = self.coder.flush()
        leb128_write(len(blob), self.writer)
        self.writer.write_bytes(blob)


class RansSymbolDecoder:
    """Mirror of RansSymbolEncoder (decode/entropy/rans.rs:146-208)."""

    def __init__(self, reader: ByteReader,
                 precision: int = DEFAULT_RANS_PRECISION) -> None:
        freq_counts = parse_rans_table(reader)
        self.freq_counts = freq_counts
        offset = leb128_read(reader)
        self.decoder = RansDecoder(reader, offset, freq_counts, precision)
        self.num_symbols = len(freq_counts)

    def decode_symbol(self) -> int:
        return self.decoder.read()

    def decode_all(self, n: int) -> np.ndarray:
        return self.decoder.read_all(n)


def rans_precision_for_bit_length(bit_length: int) -> int:
    """Draco's precision schedule for direct-coded symbols: clamp(3*b/2, 12, 20)
    (matches the dispatch table in encode/entropy/symbol_coding.rs:118-140)."""
    return max(12, min(20, (3 * bit_length) // 2))

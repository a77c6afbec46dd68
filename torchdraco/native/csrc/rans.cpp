// Native rANS / RAbS bulk coders — bit-exact with the Python reference
// implementation in torchdraco/entropy/rans.py (which mirrors
// draco-oxide/src/encode/entropy/rans.rs and decode/entropy/rans.rs).
//
// The per-symbol state recurrence is inherently sequential; C++ removes the
// interpreter overhead (~100x on large streams). Exposed via a C ABI for
// ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// x / d by a multiply: m = rcp50(d) = ceil(2^50 / d) = (2^50 + e) / d
// with 0 <= e < d, so x * m / 2^50 = x / d + x * e / (d * 2^50), and the
// floor is x / d's wherever x * e < 2^50: for every x < 2^30 where
// 0 < d <= 2^20. The coders' states stay below 2^30 at the division
// (the DIRECT_CODED one below 2^10 * d, RAbS at precision 8 below 2^20).
inline uint64_t rcp50(uint64_t d) {
    return (((uint64_t)1 << 50) + d - 1) / d;
}

inline uint64_t div_rcp50(uint64_t x, uint64_t m) {
    return (uint64_t)(((unsigned __int128)x * m) >> 50);
}

}  // namespace

extern "C" {

// Encode n symbols with a normalized frequency table (sum == 1<<precision).
// Writes the rANS byte stream including the final state flush into out
// (capacity cap). Returns the number of bytes written, or -1 on overflow /
// invalid input.
int64_t tdn_rans_encode(const int32_t* symbols, int64_t n,
                         const int32_t* freqs, const int32_t* cums,
                         int32_t precision, int64_t l_base,
                         uint8_t* out, int64_t cap) {
    uint64_t state = (uint64_t)l_base;
    int64_t pos = 0;
    const uint64_t base_shift = (uint64_t)l_base >> precision;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t s = symbols[i];
        const uint64_t freq = (uint64_t)freqs[s];
        if (freq == 0) return -1;
        const uint64_t limit = (base_shift * freq) << 8;
        while (state >= limit) {
            if (pos >= cap) return -1;
            out[pos++] = (uint8_t)(state & 0xFF);
            state >>= 8;
        }
        state = ((state / freq) << precision) + state % freq
                + (uint64_t)cums[s];
    }
    // flush (encode/entropy/rans.rs:48-68)
    state -= (uint64_t)l_base;
    if (state < (1u << 6)) {
        if (pos + 1 > cap) return -1;
        out[pos++] = (uint8_t)state;
    } else if (state < (1u << 14)) {
        if (pos + 2 > cap) return -1;
        uint32_t v = (0x01u << 14) + (uint32_t)state;
        out[pos++] = (uint8_t)(v & 0xFF);
        out[pos++] = (uint8_t)(v >> 8);
    } else if (state < (1u << 22)) {
        if (pos + 3 > cap) return -1;
        uint32_t v = (0x02u << 22) + (uint32_t)state;
        out[pos++] = (uint8_t)(v & 0xFF);
        out[pos++] = (uint8_t)((v >> 8) & 0xFF);
        out[pos++] = (uint8_t)(v >> 16);
    } else if (state < (1u << 30)) {
        if (pos + 4 > cap) return -1;
        uint32_t v = (0x03u << 30) + (uint32_t)state;
        out[pos++] = (uint8_t)(v & 0xFF);
        out[pos++] = (uint8_t)((v >> 8) & 0xFF);
        out[pos++] = (uint8_t)((v >> 16) & 0xFF);
        out[pos++] = (uint8_t)(v >> 24);
    } else {
        return -1;
    }
    return pos;
}

// Decode n symbols from a complete rANS blob (read back-to-front).
// slots maps r in [0, 1<<precision) -> symbol. Returns 0 on success.
int32_t tdn_rans_decode(const uint8_t* buf, int64_t len,
                         const int32_t* freqs, const int32_t* cums,
                         const int32_t* slots, int32_t precision,
                         int64_t l_base, int64_t n, int32_t* out) {
    int64_t pos = len;  // reverse reader position
    if (pos <= 0) return -1;
    uint8_t metadata = buf[--pos];
    uint32_t flag = metadata >> 6;
    uint64_t state = 0;
    if (flag >= 1) {
        if (pos < (int64_t)flag) return -1;
        // read `flag` bytes back-to-front, MSB first
        for (uint32_t i = 0; i < flag; ++i)
            state = (state << 8) | buf[--pos];
    }
    state |= ((uint64_t)(metadata & 0x3F)) << (flag << 3);
    state += (uint64_t)l_base;

    const uint64_t mask = ((uint64_t)1 << precision) - 1;
    for (int64_t i = 0; i < n; ++i) {
        while (state < (uint64_t)l_base) {
            if (pos <= 0) return -1;
            state = state * 256 + buf[--pos];
        }
        const uint64_t q = state >> precision;
        const uint64_t r = state & mask;
        const int32_t idx = slots[r];
        state = q * (uint64_t)freqs[idx] + r - (uint64_t)cums[idx];
        out[i] = idx;
    }
    return 0;
}

// RAbS encode (binary, single-`if` renormalization per the reference).
int64_t tdn_rabs_encode(const uint8_t* bits, int64_t n, int32_t freq0,
                         int32_t precision, int64_t l_base,
                         uint8_t* out, int64_t cap) {
    uint64_t state = (uint64_t)l_base;
    int64_t pos = 0;
    const uint64_t f0 = (uint64_t)freq0;
    const uint64_t f1 = ((uint64_t)1 << precision) - f0;
    const uint64_t base_shift = (uint64_t)l_base >> precision;
    const bool exact = precision <= 20 && f0 > 0 && f1 > 0;
    const uint64_t m0 = exact ? rcp50(f0) : 0, m1 = exact ? rcp50(f1) : 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t freq = bits[i] ? f1 : f0;
        if (state >= (base_shift * freq) << 8) {
            if (pos >= cap) return -1;
            out[pos++] = (uint8_t)(state & 0xFF);
            state >>= 8;
        }
        const uint64_t q = exact && state < ((uint64_t)1 << 30)
            ? div_rcp50(state, bits[i] ? m1 : m0) : state / freq;
        state = (q << precision) + (state - q * freq) + (bits[i] ? 0 : f1);
    }
    state -= (uint64_t)l_base;
    if (state < (1u << 6)) {
        if (pos + 1 > cap) return -1;
        out[pos++] = (uint8_t)state;
    } else if (state < (1u << 14)) {
        if (pos + 2 > cap) return -1;
        uint32_t v = (0x01u << 14) + (uint32_t)state;
        out[pos++] = (uint8_t)(v & 0xFF);
        out[pos++] = (uint8_t)(v >> 8);
    } else if (state < (1u << 22)) {
        if (pos + 3 > cap) return -1;
        uint32_t v = (0x02u << 22) + (uint32_t)state;
        out[pos++] = (uint8_t)(v & 0xFF);
        out[pos++] = (uint8_t)((v >> 8) & 0xFF);
        out[pos++] = (uint8_t)(v >> 16);
    } else if (state < (1u << 30)) {
        if (pos + 4 > cap) return -1;
        uint32_t v = (0x03u << 30) + (uint32_t)state;
        out[pos++] = (uint8_t)(v & 0xFF);
        out[pos++] = (uint8_t)((v >> 8) & 0xFF);
        out[pos++] = (uint8_t)((v >> 16) & 0xFF);
        out[pos++] = (uint8_t)(v >> 24);
    } else {
        return -1;
    }
    return pos;
}

int32_t tdn_rabs_decode(const uint8_t* buf, int64_t len, int32_t freq0,
                         int32_t precision, int64_t l_base, int64_t n,
                         uint8_t* out) {
    int64_t pos = len;
    if (pos <= 0) return -1;
    uint8_t metadata = buf[--pos];
    uint32_t flag = metadata >> 6;
    uint64_t state = 0;
    if (flag >= 1) {
        if (pos < (int64_t)flag) return -1;
        for (uint32_t i = 0; i < flag; ++i)
            state = (state << 8) | buf[--pos];
    }
    state |= ((uint64_t)(metadata & 0x3F)) << (flag << 3);
    state += (uint64_t)l_base;

    const uint64_t f1 = ((uint64_t)1 << precision) - (uint64_t)freq0;
    const uint64_t mask = ((uint64_t)1 << precision) - 1;
    for (int64_t i = 0; i < n; ++i) {
        if (state < (uint64_t)l_base) {
            if (pos <= 0) return -1;
            state = (state << 8) + buf[--pos];
        }
        const uint64_t q = state >> precision;
        const uint64_t r = state & mask;
        const uint64_t xn = q * f1;
        if (r < f1) {
            state = xn + r;
            out[i] = 1;
        } else {
            state = state - xn - f1;
            out[i] = 0;
        }
    }
    return 0;
}

// (extern "C" continues below)

// Parse a serialized rANS frequency table (the token stream AFTER the
// leb128 num_symbols header): token = byte & 3; 3 = zero-run of
// (byte >> 2) extra entries, else the frequency continues in `token`
// extra bytes. Mirror of entropy/rans.py::parse_rans_table (itself a
// transliteration of draco-oxide decode/entropy/rans.rs:162-188).
// Returns bytes consumed, or -1 on a truncated/invalid stream.
int64_t tdn_parse_rans_table(const uint8_t* buf, int64_t len,
                              int64_t num_symbols, int64_t* dist_out) {
    for (int64_t i = 0; i < num_symbols; ++i) dist_out[i] = 0;
    int64_t pos = 0;
    int64_t i = 0;
    while (i < num_symbols) {
        if (pos >= len) return -1;
        const uint32_t count = buf[pos++];
        const uint32_t token = count & 3u;
        if (token == 3u) {
            const int64_t offset = count >> 2;
            if (i + offset >= num_symbols) return -1;
            i += offset;  // entries already zero
        } else {
            uint64_t freq = count >> 2;
            for (uint32_t j = 0; j < token; ++j) {
                if (pos >= len) return -1;
                freq |= (uint64_t)buf[pos++] << (8 * (j + 1) - 2);
            }
            dist_out[i] = (int64_t)freq;
        }
        ++i;
    }
    return pos;
}

// tdn_rans_decode without a caller-provided slot table: builds the
// r -> symbol map itself (2^precision int32 writes, ~100x cheaper than
// the Python np.repeat it replaces per decoded blob). S = table width.
int32_t tdn_rans_decode_auto(const uint8_t* buf, int64_t len,
                              const int32_t* freqs, const int32_t* cums,
                              int64_t S, int32_t precision, int64_t l_base,
                              int64_t n, int32_t* out) {
    const int64_t P = (int64_t)1 << precision;
    int32_t* slots = new int32_t[P];
    int64_t k = 0;
    for (int64_t s = 0; s < S; ++s)
        for (int32_t f = 0; f < freqs[s] && k < P; ++f) slots[k++] = s;
    // a malformed table (sum != 2^P) is rejected by the caller before
    // this point; guard anyway so a bug cannot read uninitialized slots
    int32_t rc = -1;
    if (k == P)
        rc = tdn_rans_decode(buf, len, freqs, cums, slots, precision,
                              l_base, n, out);
    delete[] slots;
    return rc;
}


}  // extern "C"

namespace {

void leb128_emit(uint64_t v, uint8_t* out, int64_t* pos) {
    while (true) {
        uint8_t b = v & 0x7F;
        v >>= 7;
        if (v == 0) { out[(*pos)++] = b; return; }
        out[(*pos)++] = b | 0x80;
    }
}

void u32_emit(uint32_t v, uint8_t* out, int64_t* pos) {
    for (int b = 0; b < 4; ++b) out[(*pos)++] = (uint8_t)(v >> (8 * b));
}

// Whole DirectCoded symbol-stream encode in one call, twin of
// entropy/symbol_coding.py::_encode_direct_coded (bit-length token,
// bincount, normalize_freq_counts, serialize_rans_table incl. the
// >=65-zero-run quirk, reversed rANS feed, flush framing, leb128 blob
// length) — the per-mesh numpy/Python overhead of these five stages
// dominated warm host encode once the prediction step went native.
// Emits [u8 bit_length][leb128 ns][table tokens][leb128 blob_len][blob]
// into out; returns bytes written or -1 (caller falls back to the
// Python path, which raises the canonical errors). ``blob`` is scratch
// space, grown here as needed.
template <typename Sym>
int64_t encode_direct_into(const Sym* symbols, int64_t n, uint8_t* out,
                           int64_t cap, std::vector<uint8_t>& blob) {
    if (n <= 0) return -1;
    Sym max_sym = 0;
    int64_t num_nonzero = 0;
    for (int64_t i = 0; i < n; ++i) {
        max_sym = std::max(max_sym, symbols[i]);
        num_nonzero += symbols[i] != 0;
    }
    const uint64_t max_symbol = max_sym;
    if (max_symbol >= ((uint64_t)1 << 24)) return -1;  // numpy path
    // bit_length(num_nonzero) + 1, clamped to [1, 18]
    int32_t bl = 0;
    for (uint64_t v = (uint64_t)num_nonzero; v; v >>= 1) ++bl;
    bl += 1;
    if (bl < 1) bl = 1;
    if (bl > 18) bl = 18;
    const int32_t precision = std::max(12, std::min(20, (3 * bl) / 2));
    const int64_t rp = (int64_t)1 << precision;
    const uint64_t l_base = (uint64_t)rp << 2;

    const int64_t S = (int64_t)max_symbol + 1;
    std::vector<int64_t> freqs(S, 0);
    for (int64_t i = 0; i < n; ++i) ++freqs[symbols[i]];

    // normalize_freq_counts (rans.py:284): same f64 expression, then the
    // greedy stable-order fixup
    const double total = (double)n;
    std::vector<int64_t> dist(S);
    int64_t total_rans = 0;
    for (int64_t s = 0; s < S; ++s) {
        double d = std::floor((double)freqs[s] / total * (double)rp + 0.5);
        int64_t di = (int64_t)d;
        if (di == 0 && freqs[s] > 0) di = 1;
        dist[s] = di;
        total_rans += di;
    }
    if (total_rans != rp) {
        std::vector<int64_t> order(S);
        for (int64_t s = 0; s < S; ++s) order[s] = s;
        std::stable_sort(order.begin(), order.end(),
                         [&](int64_t a, int64_t b) {
                             return dist[a] < dist[b];
                         });
        if (total_rans < rp) {
            dist[order[S - 1]] += rp - total_rans;
        } else {
            int64_t err = total_rans - rp;
            int64_t i = S - 1;
            while (err > 0) {
                dist[order[i]] -= 1;
                --i;
                --err;
            }
        }
    }

    int64_t pos = 0;
    if (cap < 16) return -1;
    out[pos++] = (uint8_t)bl;
    // table: leb128 symbol count + tokens (rans.rs:194-230 incl. the
    // >=65-run quirk where each overflow zero degrades to a bare 3)
    leb128_emit((uint64_t)S, out, &pos);
    int64_t gap = 0;
    for (int64_t s = 0; s < S; ++s) {
        if (dist[s] <= 0) { ++gap; continue; }
        if (gap > 0) {
            int64_t run = gap > 64 ? gap - 63 : 1;
            if (pos + run + 4 > cap) return -1;
            for (int64_t r = 0; r < run - 1; ++r) out[pos++] = 3;
            int64_t capped = gap > 64 ? 64 : gap;
            out[pos++] = (uint8_t)((((capped - 1) << 2) | 3) & 0xFF);
            gap = 0;
        }
        const int64_t f = dist[s];
        const int32_t extra = (f >= (1 << 6)) + (f >= (1 << 14));
        if (pos + 3 > cap) return -1;
        out[pos++] = (uint8_t)(((f << 2) | extra) & 0xFF);
        if (extra >= 1) out[pos++] = (uint8_t)((f >> 6) & 0xFF);
        if (extra == 2) out[pos++] = (uint8_t)((f >> 14) & 0xFF);
    }

    // rANS encode, symbols fed in REVERSE (write_all(symbols[::-1]))
    std::vector<int64_t> cums(S, 0);
    for (int64_t s = 1; s < S; ++s) cums[s] = cums[s - 1] + dist[s - 1];
    if ((int64_t)blob.size() < n * 8 + 16) blob.resize(n * 8 + 16);
    uint8_t* bl_out = blob.data();
    // the state stays below 2^10 * 2^precision: a symbol emits at most 3
    // bytes (its state >> 24 < 2^6, under any limit), and the state
    // left to divide is below its limit, 2^10 * freq <= 2^30
    std::vector<uint64_t> rcp(S, 0);
    for (int64_t s = 0; s < S; ++s)
        if (dist[s] > 0) rcp[s] = rcp50((uint64_t)dist[s]);
    uint64_t state = l_base;
    int64_t bpos = 0;
    const uint64_t base_shift = l_base >> precision;
    for (int64_t i = n - 1; i >= 0; --i) {
        const uint64_t s = symbols[i];
        const uint64_t freq = (uint64_t)dist[s];
        if (freq == 0) return -1;
        const uint64_t limit = (base_shift * freq) << 8;
        const int k = (state >= limit) + (state >= (limit << 8))
                      + (state >= (limit << 16));
        bl_out[bpos] = (uint8_t)state;
        bl_out[bpos + 1] = (uint8_t)(state >> 8);
        bl_out[bpos + 2] = (uint8_t)(state >> 16);
        bpos += k;
        state >>= 8 * k;
        const uint64_t q = div_rcp50(state, rcp[s]);
        state = (q << precision) + (state - q * freq) + (uint64_t)cums[s];
    }
    // flush framing (rans.rs:48-68): state - l_base with a 2-bit size
    // flag in the top bits of the last byte
    uint64_t st = state - l_base;
    int32_t nbytes;
    if (st < ((uint64_t)1 << 6)) nbytes = 1;
    else if (st < ((uint64_t)1 << 14)) nbytes = 2;
    else if (st < ((uint64_t)1 << 22)) nbytes = 3;
    else nbytes = 4;
    const uint64_t packed = st + ((uint64_t)(nbytes - 1)
                                  << (6 + 8 * (nbytes - 1)));
    for (int32_t b = 0; b < nbytes; ++b)
        bl_out[bpos++] = (uint8_t)((packed >> (8 * b)) & 0xFF);

    if (pos + 10 + bpos > cap) return -1;
    leb128_emit((uint64_t)bpos, out, &pos);
    std::memcpy(out + pos, bl_out, (size_t)bpos);
    return pos + bpos;
}

// RAbS precision and base of the transform metadata's bit streams
// (RabsEncoder's defaults, entropy/rans.py)
constexpr int32_t kRabsPrecision = 8;
constexpr int64_t kRabsBase = 4096;

}  // namespace

extern "C" {

int64_t tdn_encode_direct(const uint64_t* symbols, int64_t n,
                           uint8_t* out, int64_t cap) {
    std::vector<uint8_t> blob;
    return encode_direct_into(symbols, n, out, cap, blob);
}

// The chain entries of one NORMAL or TEX_COORD attribute of a chunk of n
// meshes, as batch.py::_chain_payloads writes them one mesh at a time:
// for mesh k, the transform metadata ("xform_meta") and then the
// DIRECT_CODED payload ([u8 method] + tdn_encode_direct) of its T * C
// symbols, back to back in out.
//   NORMAL (flags null): u32 n_mx, u32 n_mx / 2, the flip bits of
//     shared/prediction.py::write_normal_flips (u8 zero probability from
//     the count of clear flips, leb128 length, RAbS blob);
//   TEX_COORD: the orientations bits[k][t] where flags[k][t], written as
//     write_tex_orientations does (u32 count, u8 zero probability from the
//     forward change count, leb128 length, RAbS blob of the reverse delta
//     chain re-reversed: bit i = o[i] == o[i + 1], o[count] = true), then
//     u32 vmin[k], u32 vmax[k].
// offs[3k..3k+2] = (metadata start, payload start, end) in out; -1 in the
// first where skip[k], -2 where this entry leaves the mesh to the
// per-mesh writers (no flips: their 0 / 0 raises there; symbols past
// 2^24; the mesh past cap), which give the same bytes or the canonical
// error. Returns the bytes written; n_bits gets the bits RAbS-coded.
int64_t tdn_chain_payloads(int64_t n, int64_t T, int64_t C,
                            const uint8_t* bits, const uint8_t* flags,
                            const uint32_t* symbols, const uint8_t* skip,
                            const int32_t* vmin, const int32_t* vmax,
                            uint32_t n_mx, uint8_t* out, int64_t cap,
                            int64_t* offs, int64_t* n_bits) {
    const int64_t m = T * C;
    std::vector<uint8_t> row(T > 0 ? T : 1), rabs(2 * T + 16), blob;
    int64_t pos = 0, coded = 0;
    for (int64_t k = 0; k < n; ++k) {
        int64_t* o = offs + 3 * k;
        o[0] = o[1] = o[2] = -1;
        if (skip[k]) continue;
        o[0] = -2;
        const uint8_t* b = bits + k * T;
        int64_t len = 0, n0 = 0;
        float zp;
        if (flags == nullptr) {
            if (T == 0) continue;
            for (int64_t t = 0; t < T; ++t) {
                row[t] = b[t] != 0;
                n0 += row[t] == 0;
            }
            len = T;
            zp = (float)n0 / (float)len * 256.0f + 0.5f;
        } else {
            const uint8_t* f = flags + k * T;
            uint8_t last = 1;
            for (int64_t t = 0; t < T; ++t) {
                if (!f[t]) continue;
                const uint8_t v = b[t] != 0;
                n0 += v != last;
                last = v;
                row[len++] = v;
            }
            for (int64_t i = 0; i < len; ++i)
                row[i] = row[i] == (i + 1 < len ? row[i + 1] : 1);
            zp = (float)n0 / ((float)len + (float)0.001) * 256.0f + 0.5f;
        }
        const int32_t zero_prob = std::max(1, std::min(255, (int32_t)zp));
        const int64_t nb = tdn_rabs_encode(row.data(), len, zero_prob,
                                           kRabsPrecision, kRabsBase,
                                           rabs.data(),
                                           (int64_t)rabs.size());
        int64_t p = pos;
        if (nb < 0 || p + nb + 32 > cap) continue;
        if (flags == nullptr) {
            u32_emit(n_mx, out, &p);
            u32_emit(n_mx / 2, out, &p);
        } else {
            u32_emit((uint32_t)len, out, &p);
        }
        out[p++] = (uint8_t)zero_prob;
        leb128_emit((uint64_t)nb, out, &p);
        std::memcpy(out + p, rabs.data(), (size_t)nb);
        p += nb;
        if (flags != nullptr) {
            u32_emit((uint32_t)vmin[k], out, &p);
            u32_emit((uint32_t)vmax[k], out, &p);
        }
        const int64_t payload = p;
        out[p++] = 1;  // DIRECT_CODED
        const int64_t w = encode_direct_into(symbols + k * m, m, out + p,
                                             cap - p, blob);
        if (w < 0) continue;
        o[0] = pos;
        o[1] = payload;
        o[2] = pos = p + w;
        coded += len;
    }
    *n_bits = coded;
    return pos;
}

}  // extern "C"

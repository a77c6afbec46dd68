// First-occurrence row dedup — twin of the numpy path in
// torchdraco/models/attribute.py (np.unique over a void view of each row's
// bytes, then ranks of the first indices), which sorts with a memcmp a
// comparison. This is one pass over the rows with an open-addressing
// table: a row new to the table gets the next id, so ids come out in
// first-appearance order without a sort.
//
// Equality contract: rows are equal when their bytes are, except that with
// float_bytes = 2, 4 or 8 every element whose bits are the sign bit alone
// (-0.0) is read as +0.0 first, as the numpy twin's key does. Every other
// bit pattern, NaN payloads included, compares as raw bytes.
//
// The table holds (tag, id + 1) a slot, the tag being the hash's high 32
// bits, so a probe compares rows only when 32 hash bits agree; its size is
// the power of two at or above 2n. The slots of a block of rows are
// prefetched before the block is probed: at a million rows the table is
// 16 MB and a probe is otherwise one cache miss.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>

namespace {

constexpr uint64_t kMul = 0x9E3779B97F4A7C15ull;
constexpr int64_t kBlock = 32;

inline uint64_t fmix(uint64_t x) {  // splitmix64's finaliser
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBull;
    x ^= x >> 31;
    return x;
}

// ``x`` with each FB-byte lane that holds -0.0 (the sign bit alone) made
// +0.0; FB = 0 leaves it as it is.
template <int FB>
inline uint64_t zero_signs(uint64_t x) {
    if constexpr (FB == 0) {
        return x;
    } else {
        constexpr int kBits = 8 * FB;
        constexpr uint64_t kLane = FB == 8 ? ~0ull : (1ull << kBits) - 1;
        constexpr uint64_t kSign = 1ull << (kBits - 1);
        for (int k = 0; k < 64; k += kBits)
            if (((x >> k) & kLane) == kSign) x &= ~(kSign << k);
        return x;
    }
}

// The row's bytes as little-endian words, the last zero-padded.
template <int FB>
inline uint64_t hash_row(const uint8_t* p, int64_t w) {
    uint64_t h = (uint64_t)w * kMul;
    int64_t i = 0;
    for (; i + 8 <= w; i += 8) {
        uint64_t x;
        std::memcpy(&x, p + i, 8);
        h = ((h << 23) | (h >> 41)) ^ zero_signs<FB>(x);
        h *= kMul;
    }
    if (i < w) {  // the last 1-7 bytes, in fixed-size loads
        uint64_t x = 0;
        int sh = 0;
        if (w - i >= 4) {
            uint32_t y;
            std::memcpy(&y, p + i, 4);
            x = y;
            i += 4;
            sh = 32;
        }
        if (w - i >= 2) {
            uint16_t y;
            std::memcpy(&y, p + i, 2);
            x |= (uint64_t)y << sh;
            i += 2;
            sh += 16;
        }
        if (w - i >= 1) x |= (uint64_t)p[i] << sh;
        h = ((h << 23) | (h >> 41)) ^ zero_signs<FB>(x);
        h *= kMul;
    }
    return fmix(h);
}

template <int FB>
inline bool rows_equal(const uint8_t* a, const uint8_t* b, int64_t w) {
    if constexpr (FB == 0) {
        return std::memcmp(a, b, (size_t)w) == 0;
    } else {
        using U = std::conditional_t<FB == 2, uint16_t,
                  std::conditional_t<FB == 4, uint32_t, uint64_t>>;
        for (int64_t i = 0; i < w; i += FB) {
            U x, y;
            std::memcpy(&x, a + i, FB);
            std::memcpy(&y, b + i, FB);
            if (zero_signs<FB>(x) != zero_signs<FB>(y)) return false;
        }
        return true;
    }
}

struct Slot {
    uint32_t tag;
    uint32_t id1;  // id + 1; 0: empty
};

template <int FB>
int64_t dedup(const uint8_t* rows, int64_t n, int64_t w, int64_t* first,
              int64_t* inverse) {
    uint64_t cap = 16;
    while (cap < 2 * (uint64_t)n) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<Slot> table(cap, Slot{0, 0});
    uint64_t hashes[kBlock];
    int64_t u = 0;
    for (int64_t b = 0; b < n; b += kBlock) {
        const int64_t e = b + kBlock < n ? b + kBlock : n;
        for (int64_t i = b; i < e; ++i) {
            hashes[i - b] = hash_row<FB>(rows + i * w, w);
            __builtin_prefetch(&table[hashes[i - b] & mask]);
        }
        for (int64_t i = b; i < e; ++i) {
            const uint64_t h = hashes[i - b];
            const uint32_t tag = (uint32_t)(h >> 32);
            for (uint64_t s = h & mask;; s = (s + 1) & mask) {
                Slot& slot = table[s];
                if (slot.id1 == 0) {
                    slot.tag = tag;
                    slot.id1 = (uint32_t)(u + 1);
                    first[u] = i;
                    inverse[i] = u++;
                    break;
                }
                if (slot.tag == tag) {
                    const int64_t id = slot.id1 - 1;
                    if (rows_equal<FB>(rows + first[id] * w, rows + i * w,
                                       w)) {
                        inverse[i] = id;
                        break;
                    }
                }
            }
        }
    }
    return u;
}

}  // namespace

extern "C" {

// rows: (n, w) bytes, C-contiguous. float_bytes: 0 (raw bytes) or the
// element size 2, 4 or 8 of float rows, whose -0.0 elements count as
// +0.0. Writes first (n,) int64 (the first u entries: the ascending
// index of each distinct row's first appearance) and inverse (n,) int64
// (the id, in first-appearance order, of each row's distinct row).
// Returns u, or -1 for inputs it leaves to the numpy twin: no columns,
// n past 2^31, a float row not a whole number of elements.
int64_t tdn_unique_rows(const uint8_t* rows, int64_t n, int64_t w,
                        int32_t float_bytes, int64_t* first,
                        int64_t* inverse) {
    if (w <= 0 || n < 0 || n >= ((int64_t)1 << 31)) return -1;
    if (float_bytes != 0 && float_bytes != 2 && float_bytes != 4
            && float_bytes != 8) return -1;
    if (float_bytes != 0 && w % float_bytes != 0) return -1;
    switch (float_bytes) {
        case 0: return dedup<0>(rows, n, w, first, inverse);
        case 2: return dedup<2>(rows, n, w, first, inverse);
        case 4: return dedup<4>(rows, n, w, first, inverse);
        default: return dedup<8>(rows, n, w, first, inverse);
    }
}

}  // extern "C"

// The rANS step's division by a frequency as a multiplication, shared by
// the encoders K3 (rans_words.cu) and K4 (rans_dense.cu): the producers
// prepare (mult, shift) per symbol, the consumer takes
// q = umulhi(x, mult) >> shift.
//
// Why it is exact. Let x <= f * 2^10 - 1 (K3: always so after
// renormalising, since the loop shifts while x >= (4 * f) << 8 and three
// shifts suffice for x < 2^(P + 10), P <= 20; K4 checks it at every step).
// Let b be the bit length of f (2^(b-1) <= f < 2^b) and f < 2^21, so
// b <= 21. q = umulhi(x, m) >> s is floor(x * m / 2^k) with k = 32 + s.
//   - f no power of two (so b >= 2): k = max(32, 2b + 10) and
//     m = floor(2^k / f) + 1, so m * f = 2^k + e with 0 < e <= f. Then
//       x * m / 2^k = x / f + x * e / (f * 2^k),
//     and the excess x * e / (f * 2^k) < (f * 2^10) * f / (f * 2^k)
//     = f * 2^10 / 2^k <= 2^(b + 10) / 2^(2b + 10) = 2^-b < 1 / f. The
//     fractional part of x / f is at most 1 - 1 / f, so the floor does not
//     move: floor(x * m / 2^k) = floor(x / f). m fits 32 bits: at k = 32,
//     f >= 3 gives m <= 2^32 / 3 + 1; at k = 2b + 10, f > 2^(b-1) gives
//     2^k / f < 2^(b + 11) <= 2^32, so floor(2^k / f) <= 2^32 - 2 (2^k / f
//     is no integer: f is no power of two) and m <= 2^32 - 1. s = k - 32
//     is at most 20.
//   - f a power of two, b >= 2: m = 2^31, s = b - 2: umulhi(x, 2^31) is
//     x >> 1, so q = x >> (b - 1), exact for every x.
//   - f = 1: q = x is no umulhi of a 32-bit m. mult = 0 (so q = 0) and the
//     F_IS_ONE flag beside the shift makes the step x' = x * 2^P + c
//     instead of x + c: the same value, since x - q f = 0.
//   - f = 0 has no reciprocal: mult = 0. K3's callers refuse such input
//     before the launch; K4 flags it and divides as its contract says.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr uint32_t F_IS_ONE = 32u;  // flag beside the 5-bit shift

// (mult, shift | flag) of the division by f, f < 2^21
__device__ __forceinline__ void rans_reciprocal(uint32_t f, uint32_t* mult,
                                                uint32_t* shift) {
  *mult = 0;
  *shift = 0;
  if (f == 1) {
    *shift = F_IS_ONE;
  } else if (f != 0) {
    const uint32_t b = 32u - (uint32_t)__clz((int)f);
    if ((f & (f - 1u)) == 0) {
      *mult = 1u << 31;
      *shift = b - 2u;
    } else {
      const uint32_t k = 2u * b + 10u > 32u ? 2u * b + 10u : 32u;
      *mult = (uint32_t)((1ull << k) / f) + 1u;
      *shift = k - 32u;
    }
  }
}

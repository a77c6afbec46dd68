// K4: the multi-lane rANS encoder in its dense emission form. One lane is
// one symbol stream, coded at a precision shared by every lane.
//
// Replaces tpudraco/ops/pallas_kernels.py rans_scan_pallas (the dense-slot
// branch of rans_lanes.py _rans_scan_lanes). The TPU kernel ran a tile of
// lanes in lockstep in (8, 128) vector registers and carried the states
// across T chunks in a scratch tile; every step writes R = 3 byte slots and
// 3 mask slots, emitted or not, so a later pass can compact them.
//
// The function: over the pre-gathered (freq, cum) of a lane's first
// `length` symbols, renormalise (at most 3 bytes while
// state >= (4 * freq) << 8, the limit taken modulo 2^32), then
// state = ((state / freq) << prec) + state % freq + cum modulo 2^32. The
// r-th renormalisation byte of step t goes to slot 3t + r of the lane and
// its mask slot is set; every other slot is 0. A frequency of 0 takes what
// jnp's `//` and `%` give for an unsigned division by zero, quotient
// 0xFFFFFFFF and remainder 0, so the kernel and the JAX reference agree on
// every input.
//
// Bound on this card: the length of the dependent chain, not bytes (the
// fs/cs rows in and the slot rows out would take the card tens of
// microseconds; a lane is one recurrence of up to T steps).
//
// Design, K3's (rans_words.cu): one block per lane, so 512 lanes are 512
// blocks over all 132 SMs. Thread 0 (the consumer) runs only the state
// chain; warps 1..3 (the producers) work one tile of TILE symbols ahead of
// it and one behind:
//   - ahead: they read the lane's fs/cs rows as they lie, row-major (L, T),
//     with coalesced loads, and write one 16-byte entry per symbol into the
//     next of two tiles in shared memory: the renormalisation limit, cum,
//     the multiplier and shift of the division (rans_reciprocal.cuh) and
//     2^P - freq;
//   - the consumer counts the renormalisation bytes with three independent
//     compares, steps x' = q * (2^P - f) + (x + c), and leaves one word per
//     step in a shared-memory tile: the low three bytes of x before the
//     shift, and the byte count. No branch sits on the chain;
//   - behind: the producers expand the previous tile's words into the
//     lane's 3 * TILE byte slots and mask slots and store both rows
//     coalesced in their final layout and type. Every slot up to T is
//     written, zeros included, so the caller allocates without a memset,
//     transposes nothing and casts nothing.
//
// The guard, and why it is complete. The reciprocal is exact under two
// conditions (proof in rans_reciprocal.cuh): 0 < f < 2^21, and the
// renormalised x is at most f * 2^10 - 1. K3's callers guarantee
// normalized tables and so both; K4 takes any uint32 (f, c), under which
// the state can leave the coder's range and three shifts need not bring it
// under the limit. So an entry whose f is 0 or >= 2^21 is flagged by a
// limit field of 0, and a step is in range only when its renormalised x is
// below its limit field. In range means: the entry is unflagged, where the
// limit field is f << 10 exactly (f < 2^21 leaves it under 2^31, no wrap),
// and x < f << 10: the proof's two conditions and nothing less. The fast
// path's byte count is exact for every uint32 x: (x >> 8r) >= limit is
// x > (limit << 8r) - 1 while limit << 8r fits 32 bits (limit >= 2^10, so
// the subtraction cannot wrap) and false once it does not.
//
// A branch on that compare inside the step sits on the chain (the step
// took 1.6 times as long with it). So the consumer speculates: it codes a
// tile on the fast path alone and only ORs the compares together, beside
// the chain. If any step of the tile was out of range, its words and every
// state after it may be wrong, so the consumer goes back to the state it
// entered the tile with and codes the tile again, step by step: a step in
// range as before, any other through `exact_step`, which redoes it from
// the entry's f with the sequential renormalisation and a true division.
// The first out-of-range step of a tile starts from a state the fast path
// got right, so the OR cannot miss it. Valid streams never code a tile
// twice.

#include <cstdint>
#include <cuda_runtime.h>

#include "rans_reciprocal.cuh"

namespace {

constexpr int TILE = 256;     // symbols per tile
constexpr int THREADS = 128;  // warp 0: consumer; 1-3: producers
constexpr int PRODUCERS = THREADS - 32;
constexpr uint32_t F_FAST_MAX = 1u << 21;  // the reciprocal's range of f

// entry.x = (f << 10) | flag | s, or 0 where the step must take the exact
// path; entry.y = cum, entry.z = m, entry.w = 2^P - f (modulo 2^32, so the
// exact path gets f back as 2^P - entry.w).
__device__ __forceinline__ uint4 dense_entry(uint32_t f, uint32_t c,
                                             uint32_t p) {
  uint32_t mult = 0, shift = 0, head = 0;
  if (f != 0 && f < F_FAST_MAX) {
    rans_reciprocal(f, &mult, &shift);
    head = (f << 10) | shift;
  }
  return make_uint4(head, c, mult, (1u << p) - f);
}

// One step as the contract states it, for any (x, f, c). Returns the new
// state and sets *nb to the count of renormalisation bytes.
__device__ __noinline__ uint32_t exact_step(uint32_t x, uint32_t f,
                                            uint32_t c, uint32_t p,
                                            uint32_t* nb) {
  const uint32_t limit = f << 10;  // (4 * f) << 8 modulo 2^32
  uint32_t n = 0;
  for (int r = 0; r < 3; ++r) {
    if (x >= limit) {
      x >>= 8;
      ++n;
    }
  }
  *nb = n;
  const uint32_t q = f ? x / f : 0xFFFFFFFFu;
  const uint32_t m = f ? x % f : 0u;
  return (q << p) + m + c;
}

// W bytes of a lane's slot rows from a tile of step words. Unit m covers
// slots [W * m, W * m + W) of the tile; slot 3i + r holds byte r of step i
// where r is under the step's byte count. Steps at or past `cnt` are idle.
template <int W>
__device__ __forceinline__ void expand_unit(const uint32_t* wt, int cnt,
                                            int m, uint32_t* bytes,
                                            uint32_t* mask) {
  uint32_t b = 0, k = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int s = W * m + j;
    const int i = s / 3;
    const uint32_t r = (uint32_t)(s - 3 * i);
    const uint32_t w = i < cnt ? wt[i] : 0u;
    const bool on = r < (w >> 24);
    b |= on ? ((w >> (8 * r)) & 0xFFu) << (8 * j) : 0u;
    k |= on ? 1u << (8 * j) : 0u;
  }
  *bytes = b;
  *mask = k;
}

// W = 4: rows of 3T bytes start 4-byte aligned (T % 4 == 0), a thread
// stores a 32-bit word and a warp 128 contiguous bytes. W = 1: any T.
template <typename IT, int W>
__global__ void __launch_bounds__(THREADS) rans_dense_kernel(
    const IT* __restrict__ fs, const IT* __restrict__ cs,
    const int32_t* __restrict__ lengths, int64_t T, uint32_t p,
    uint8_t* __restrict__ bytes, uint8_t* __restrict__ mask,
    uint32_t* __restrict__ states, uint32_t* __restrict__ guard_steps) {
  __shared__ uint4 tiles[2 * TILE];
  __shared__ uint32_t wtiles[2 * TILE];

  const int64_t l = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t len = lengths[l];
  len = len < 0 ? 0 : (len > T ? T : len);
  const IT* frow = fs + l * T;
  const IT* crow = cs + l * T;
  uint8_t* brow = bytes + l * 3 * T;
  uint8_t* mrow = mask + l * 3 * T;
  const int64_t ntiles = (len + TILE - 1) / TILE;

  auto produce = [&](int64_t k, int first, int step) {
    uint4* tile = tiles + (k & 1) * TILE;
    const int64_t t0 = k * TILE;
    for (int i = first; i < TILE && t0 + i < len; i += step)
      tile[i] = dense_entry((uint32_t)frow[t0 + i], (uint32_t)crow[t0 + i],
                            p);
  };
  // slots of steps [t0, t0 + span) from the words of its first cnt steps
  auto expand = [&](const uint32_t* wt, int64_t t0, int span, int cnt,
                    int first, int step) {
    const int units = 3 * span / W;  // W divides 3 * span (T % W == 0)
    for (int m = first; m < units; m += step) {
      uint32_t b, k;
      expand_unit<W>(wt, cnt, m, &b, &k);
      const int64_t at = 3 * t0 + (int64_t)W * m;
      if (W == 4) {
        *(uint32_t*)(brow + at) = b;
        *(uint32_t*)(mrow + at) = k;
      } else {
        brow[at] = (uint8_t)b;
        mrow[at] = (uint8_t)k;
      }
    }
  };

  if (ntiles > 0) produce(0, tid, THREADS);
  __syncthreads();

  uint32_t x = 4u << p;
  uint32_t guarded = 0;
  // iteration k: the consumer codes tile k while the producers fill tile
  // k + 1 and write out the slots of tile k - 1
  for (int64_t k = 0; k <= ntiles; ++k) {
    if (tid == 0) {
      if (k < ntiles) {
        const uint4* tile = tiles + (k & 1) * TILE;
        uint32_t* wt = wtiles + (k & 1) * TILE;
        const int64_t t0 = k * TILE;
        const int cnt = (int)(len - t0 < TILE ? len - t0 : TILE);
        const uint32_t x_in = x;
        bool out_of_range = false;
        uint4 next = tile[0];
#pragma unroll 4
        for (int i = 0; i < cnt; ++i) {
          const uint4 e = next;
          next = tile[i + 1 < TILE ? i + 1 : i];
          // everything up to the compares is independent of x
          const uint32_t lim = e.x & ~0x3FFu;  // f << 10 < 2^31, or 0
          const uint32_t lim0 = lim - 1u;
          const uint32_t lim1 = lim >> 24 ? 0xFFFFFFFFu : (lim << 8) - 1u;
          const uint32_t lim2 = lim >> 16 ? 0xFFFFFFFFu : (lim << 16) - 1u;
          const uint32_t s = e.x & 31u;
          const uint32_t h = (e.x & F_IS_ONE) ? (1u << p) : 1u;
          const uint32_t nb = (uint32_t)(x > lim0) + (uint32_t)(x > lim1)
                              + (uint32_t)(x > lim2);
          const uint32_t xs = x >> (8 * nb);
          out_of_range |= xs >= lim;  // flagged entry (lim == 0) or state
          const uint32_t q = __umulhi(xs, e.z) >> s;
          wt[i] = (x & 0xFFFFFFu) | (nb << 24);
          x = q * e.w + (xs * h + e.y);
        }
        if (out_of_range) {  // again from the tile's entry state, guarded
          x = x_in;
          for (int i = 0; i < cnt; ++i) {
            const uint4 e = tile[i];
            const uint32_t lim = e.x & ~0x3FFu;
            uint32_t nb = 0;
            if (lim != 0)
              nb = (uint32_t)(x >= lim) + (uint32_t)((x >> 8) >= lim)
                   + (uint32_t)((x >> 16) >= lim);
            const uint32_t xs = x >> (8 * nb);
            uint32_t xn;
            if (xs >= lim) {
              xn = exact_step(x, (1u << p) - e.w, e.y, p, &nb);
              ++guarded;
            } else {
              const uint32_t h = (e.x & F_IS_ONE) ? (1u << p) : 1u;
              xn = (__umulhi(xs, e.z) >> (e.x & 31u)) * e.w
                   + (xs * h + e.y);
            }
            wt[i] = (x & 0xFFFFFFu) | (nb << 24);
            x = xn;
          }
        }
      }
    } else if (tid >= 32) {
      if (k + 1 < ntiles) produce(k + 1, tid - 32, PRODUCERS);
      if (k > 0) {
        const int64_t t0 = (k - 1) * TILE;
        const int span = (int)(T - t0 < TILE ? T - t0 : TILE);
        const int cnt = (int)(len - t0 < TILE ? len - t0 : TILE);
        expand(wtiles + ((k - 1) & 1) * TILE, t0, span, cnt, tid - 32,
               PRODUCERS);
      }
    }
    __syncthreads();
  }
  // the steps past the last coded tile are idle: zeros
  for (int64_t t0 = ntiles * TILE; t0 < T; t0 += TILE) {
    const int span = (int)(T - t0 < TILE ? T - t0 : TILE);
    expand(wtiles, t0, span, 0, tid, THREADS);
  }

  if (tid == 0) {
    states[l] = x;
    if (guard_steps) guard_steps[l] = guarded;
  }
}

template <typename IT>
int launch(const void* fs, const void* cs, const void* lengths, int64_t L,
           int64_t T, int32_t prec, void* bytes, void* mask, void* states,
           void* guard_steps, void* stream) {
  auto kernel = T % 4 == 0 ? rans_dense_kernel<IT, 4>
                           : rans_dense_kernel<IT, 1>;
  kernel<<<(unsigned)L, THREADS, 0, (cudaStream_t)stream>>>(
      (const IT*)fs, (const IT*)cs, (const int32_t*)lengths, T,
      (uint32_t)prec, (uint8_t*)bytes, (uint8_t*)mask, (uint32_t*)states,
      (uint32_t*)guard_steps);
  return (int)cudaGetLastError();
}

}  // namespace

// fs/cs (L, T) row-major pre-gathered freq/cum, int32 (wide = 0) or int64
// (wide = 1) elements whose low 32 bits are the uint32 values; lengths (L,)
// int32; bytes/mask (L, 3T) uint8, every slot written (mask as 0/1);
// states (L,) uint32; guard_steps (L,) uint32 or null: each lane's count
// of steps that took the exact path.
extern "C" int tdr_rans_dense(const void* fs, const void* cs, int32_t wide,
                              const void* lengths, int64_t L, int64_t T,
                              int32_t prec, void* bytes, void* mask,
                              void* states, void* guard_steps,
                              void* stream) {
  if (L == 0 || T == 0) return 0;
  return wide ? launch<int64_t>(fs, cs, lengths, L, T, prec, bytes, mask,
                                states, guard_steps, stream)
              : launch<int32_t>(fs, cs, lengths, L, T, prec, bytes, mask,
                                states, guard_steps, stream);
}

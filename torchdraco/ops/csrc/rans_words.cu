// K3: the multi-lane rANS encoder. One lane is one mesh's symbol stream,
// coded on its own table at its own precision.
//
// Replaces tpudraco/ops/pallas_kernels.py rans_words_scan_pallas, together
// with the parts of tpudraco/ops/rans_lanes.py _words_scan_core around it:
// the (freq, cum) pre-gather, the reversed feed, the flush framing and the
// word compaction. The TPU kernel ran all lanes in lockstep as (8, 128)
// vector registers, so it had to emit a word and a flag at every step and
// leave the compaction to a sort over (L, T) slots.
//
// Bound on this card: the length of the dependent chain, not bytes. A lane
// is one recurrence of n steps (12,288 on the encode path), each step
// renormalising (at most 3 bytes while state >= (4 * freq) << 8) and
// stepping state = ((state / freq) << prec) + state % freq + cum. The bytes
// (symbols, tables, words) would take the card tens of microseconds.
//
// Design: one block per lane, so 512 lanes are 512 blocks over all 132 SMs
// and each chain has an SM scheduler nearly to itself. Only the state
// recurrence stays on the chain. Thread 0 (the consumer) runs it; warps
// 1..3 (the producers) run one tile of TILE symbols ahead of it:
//   - they read the lane's symbols in reverse with coalesced loads, look
//     up (freq, cum) in the lane's table rows, which the block stages in
//     shared memory when both rows fit STAGE_MAX_BYTES and reads through
//     L2 otherwise, and prepare the division as a multiplication (below);
//   - they write one 16-byte entry per symbol into the next of two tiles
//     in shared memory, holding everything the step needs that does not
//     depend on the state: the renormalisation limit, cum, the multiplier
//     and shift of the division, and 2^P - freq;
//   - they copy the words the consumer packed in the previous tile from
//     shared memory to the lane's compacted output row, coalesced.
// One __syncthreads per tile hands the tiles over. The consumer loads the
// next entry before it works on this one, counts the renormalisation
// bytes with three independent compares (x >= L, x >= 256 L, x >= 65536 L
// are the loop's three tests, since (x >> 8) >= L iff x >= 256 L), and
// steps x' = q * (2^P - f) + (x + c), which is (q << P) + (x - q f) + c.
// On the chain stay a compare, a shift, a multiply-high, a shift and a
// multiply-add.
//
// The division is q = umulhi(x, m) >> s on a prepared reciprocal:
// rans_reciprocal.cuh has the formula and the proof that it is exact for
// x <= f * 2^10 - 1, which holds here after renormalising (three shifts
// always suffice since x < 2^(P + 10), P <= 20). A frequency of 0 is
// outside the coder's contract (the callers refuse it before the launch);
// here it gets m = 0 and codes garbage, no fault.

#include <cstdint>
#include <cuda_runtime.h>

#include "rans_reciprocal.cuh"

namespace {

constexpr int TILE = 256;                   // symbols per tile
constexpr int WTILE = (3 * TILE) / 4 + 2;   // full words a tile can emit + 1
constexpr int THREADS = 128;                // warp 0: consumer; 1-3: producers
constexpr int PRODUCERS = THREADS - 32;
constexpr int64_t STAGE_MAX_BYTES = 64 * 1024;  // both table rows together

// entry.x = (f << 10) | flag | s: the limit (4 * f) << 8 has its low 10
// bits free. entry.y = cum, entry.z = m, entry.w = 2^P - f.
__device__ __forceinline__ uint4 table_entry(uint32_t f, uint32_t c,
                                             uint32_t p) {
  uint32_t mult, shift;
  rans_reciprocal(f, &mult, &shift);
  return make_uint4((f << 10) | shift, c, mult, (1u << p) - f);
}

__global__ void __launch_bounds__(THREADS) rans_words_kernel(
    const int32_t* __restrict__ sym, const int32_t* __restrict__ dist,
    const int32_t* __restrict__ cums, int64_t S,
    const int32_t* __restrict__ prec, const int32_t* __restrict__ lengths,
    int64_t n, int64_t cap_w, int stage, uint32_t* __restrict__ words,
    uint32_t* __restrict__ meta) {
  extern __shared__ uint4 smem[];
  uint4* tiles = smem;                                   // [2][TILE]
  uint32_t* wtiles = (uint32_t*)(tiles + 2 * TILE);      // [2][WTILE]
  int64_t* wbase = (int64_t*)(wtiles + 2 * WTILE + 2);   // [2], 8-aligned
  int32_t* wcount = (int32_t*)(wbase + 2);               // [2]
  int32_t* rows = wcount + 2;                            // [2][S] if staged

  const int64_t l = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t p = (uint32_t)prec[l];
  const uint32_t l_base = 4u << p;
  int64_t len = lengths[l];
  len = len < 0 ? 0 : (len > n ? n : len);
  const int32_t* srow = sym + l * n;
  const int32_t* drow = dist + l * S;
  const int32_t* crow = cums + l * S;
  uint32_t* wrow = words + l * cap_w;
  if (stage) {
    for (int64_t i = tid; i < S; i += THREADS) {
      rows[i] = drow[i];
      rows[S + i] = crow[i];
    }
    drow = rows;
    crow = rows + S;
    __syncthreads();
  }
  const int64_t ntiles = (len + TILE - 1) / TILE;

  // tile k holds the coded symbols t in [k * TILE, (k + 1) * TILE), read
  // from the row's end (reversed feed)
  auto produce = [&](int64_t k, int first, int step) {
    uint4* tile = tiles + (k & 1) * TILE;
    const int64_t t0 = k * TILE;
    for (int i = first; i < TILE && t0 + i < len; i += step) {
      int32_t s = srow[n - 1 - (t0 + i)];
      s = s < 0 ? 0 : (s >= S ? (int32_t)(S - 1) : s);
      tile[i] = table_entry((uint32_t)drow[s], (uint32_t)crow[s], p);
    }
  };

  if (ntiles > 0) produce(0, tid, THREADS);
  __syncthreads();

  uint32_t x = l_base;
  uint64_t acc = 0;  // pending little-endian bytes, nacc of them
  uint32_t nacc = 0;
  int64_t nw = 0;
  // iteration k: the consumer codes tile k while the producers fill tile
  // k + 1 and write out the words of tile k - 1
  for (int64_t k = 0; k <= ntiles; ++k) {
    if (tid == 0) {
      if (k < ntiles) {
        const uint4* tile = tiles + (k & 1) * TILE;
        uint32_t* wt = wtiles + (k & 1) * WTILE;
        const int64_t t0 = k * TILE;
        const int cnt = (int)(len - t0 < TILE ? len - t0 : TILE);
        int w = 0;
        uint4 next = tile[0];
#pragma unroll 4
        for (int i = 0; i < cnt; ++i) {
          const uint4 e = next;
          next = tile[i + 1 < TILE ? i + 1 : i];
          // everything up to the compares is independent of x
          const uint32_t lim = e.x & ~0x3FFu;  // (4 * f) << 8 <= 2^30
          const uint32_t lim1 = lim >> 24 ? 0xFFFFFFFFu : lim << 8;
          const uint32_t lim2 = lim >> 16 ? 0xFFFFFFFFu : lim << 16;
          const uint32_t s = e.x & 31u;
          const uint32_t h = (e.x & F_IS_ONE) ? (1u << p) : 1u;
          const uint32_t nb = (uint32_t)(x >= lim) + (uint32_t)(x >= lim1)
                              + (uint32_t)(x >= lim2);  // x < 2^30 always
          const uint32_t out = x & ((1u << (8 * nb)) - 1u);
          acc |= (uint64_t)out << (8 * nacc);
          nacc += nb;
          x >>= 8 * nb;
          const uint32_t q = __umulhi(x, e.z) >> s;
          x = q * e.w + (x * h + e.y);
          // <= 3 carried + <= 3 new bytes: at most one full word. Stored
          // every step and kept only when full, so the step has no branch
          const bool full = nacc >= 4;
          wt[w] = (uint32_t)acc;
          w += full;
          acc = full ? acc >> 32 : acc;
          nacc -= full ? 4u : 0u;
        }
        wbase[k & 1] = nw;
        wcount[k & 1] = w;
        nw += w;
      }
    } else if (tid >= 32) {
      if (k + 1 < ntiles) produce(k + 1, tid - 32, PRODUCERS);
      if (k > 0) {
        const uint32_t* wt = wtiles + ((k - 1) & 1) * WTILE;
        const int64_t base = wbase[(k - 1) & 1];
        const int cnt = wcount[(k - 1) & 1];
        for (int i = tid - 32; i < cnt; i += PRODUCERS)
          if (base + i < cap_w) wrow[base + i] = wt[i];
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    const uint32_t st = x - l_base;
    const uint32_t nbytes = st < (1u << 6) ? 1u
                            : st < (1u << 14) ? 2u
                            : st < (1u << 22) ? 3u
                                              : 4u;
    const uint32_t packed = st + ((nbytes - 1) << (6 + 8 * (nbytes - 1)));
    uint32_t* m = meta + l * 5;
    m[0] = (uint32_t)nw;  // may exceed cap_w only on invalid input: the
    m[1] = nacc;          // host checks it before reading the words
    m[2] = (uint32_t)acc;
    m[3] = packed;
    m[4] = nbytes;
  }
}

}  // namespace

// sym (L, n) int32, the lanes' unreversed streams row by row; dist/cums
// (L, S) int32 per-lane tables; prec, lengths (L,) int32; words (L, cap_w),
// zeroed by the caller, and meta (L, 5) uint32 outputs.
extern "C" int tdr_rans_words(const void* sym, const void* dist,
                              const void* cums, int64_t S, const void* prec,
                              const void* lengths, int64_t L, int64_t n,
                              int64_t cap_w, void* words, void* meta,
                              void* stream) {
  if (L == 0) return 0;
  const int stage = 2 * S * (int64_t)sizeof(int32_t) <= STAGE_MAX_BYTES;
  const size_t fixed = 2 * TILE * sizeof(uint4)
                       + (2 * WTILE + 2) * sizeof(uint32_t)
                       + 2 * sizeof(int64_t) + 2 * sizeof(int32_t);
  const size_t smem = fixed + (stage ? 2 * S * sizeof(int32_t) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      rans_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(fixed + STAGE_MAX_BYTES));
  if (err != cudaSuccess) return (int)err;
  rans_words_kernel<<<(unsigned)L, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sym, (const int32_t*)dist, (const int32_t*)cums, S,
      (const int32_t*)prec, (const int32_t*)lengths, n, cap_w, stage,
      (uint32_t*)words, (uint32_t*)meta);
  return (int)cudaGetLastError();
}

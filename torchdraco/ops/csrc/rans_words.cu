// K3: the multi-lane rANS encoder. One lane is one mesh's symbol stream,
// coded on its own table at its own precision.
//
// Replaces tpudraco/ops/pallas_kernels.py rans_words_scan_pallas, together
// with the parts of tpudraco/ops/rans_lanes.py _words_scan_core around it:
// the (freq, cum) pre-gather, the reversed feed, the flush framing and the
// word compaction. The TPU kernel ran all lanes in lockstep as (8, 128)
// vector registers, so it had to emit a word and a flag at every step and
// leave the compaction to a sort over (L, T) slots. Here one thread owns
// one lane and runs its recurrence in uint32_t: for each symbol, read in
// reverse, it looks up (freq, cum) in its own table row, renormalises
// (at most 3 bytes while state >= (4 * freq) << 8), and steps
// state = ((state / freq) << prec) + state % freq + cum. Renormalisation
// bytes pack little-endian into a 64-bit accumulator and each full 32-bit
// word goes straight to the lane's compacted output row, so no sort. At the
// end the thread writes meta = [nwords, nacc, partial word, packed flush
// state, flush byte count], the framing of rans.rs:48-68.
//
// Bound on this card: latency, and occupancy. The recurrence is sequential
// within a lane, so each step waits on a dependent table load and a 32-bit
// division. 512 lanes are 512 threads, 16 warps, which occupy a few of the
// 132 SMs; most of the card idles. Symbols arrive in a (n, L) layout so the
// lanes of a warp read neighbouring addresses at each step. Splitting lanes
// into interleaved sub-streams (PAPERS.md: Recoil) is what would fill the
// card; that changes nothing in the bytes only if the split is undone on
// the host, and is work for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rans_words_kernel(
    const int32_t* __restrict__ sym, const int32_t* __restrict__ dist,
    const int32_t* __restrict__ cums, int64_t S,
    const int32_t* __restrict__ prec, const int32_t* __restrict__ lengths,
    int64_t L, int64_t n, int64_t cap_w, uint32_t* __restrict__ words,
    uint32_t* __restrict__ meta) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const uint32_t p = (uint32_t)prec[l];
  const uint32_t l_base = 4u << p;
  int64_t len = lengths[l];
  len = len < 0 ? 0 : (len > n ? n : len);
  const int32_t* drow = dist + l * S;
  const int32_t* crow = cums + l * S;
  uint32_t* wrow = words + l * cap_w;

  uint32_t x = l_base;
  uint64_t acc = 0;  // pending little-endian bytes, nacc of them
  uint32_t nacc = 0;
  int64_t nw = 0;
  for (int64_t t = 0; t < len; ++t) {
    int32_t s = sym[(n - 1 - t) * L + l];  // reversed feed
    s = s < 0 ? 0 : (s >= S ? (int32_t)(S - 1) : s);
    const uint32_t f = (uint32_t)drow[s];
    const uint32_t c = (uint32_t)crow[s];
    const uint32_t limit = (4u * f) << 8;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (x >= limit) {
        acc |= (uint64_t)(x & 0xFFu) << (8 * nacc);
        ++nacc;
        x >>= 8;
      }
    }
    x = ((x / f) << p) + x % f + c;
    if (nacc >= 4) {  // <= 3 carried + <= 3 new: at most one full word
      if (nw < cap_w) wrow[nw] = (uint32_t)acc;
      ++nw;
      acc >>= 32;
      nacc -= 4;
    }
  }
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

}  // namespace

// sym (n, L) int32, the lanes' unreversed streams column by column;
// dist/cums (L, S) int32 per-lane tables; prec, lengths (L,) int32;
// words (L, cap_w) and meta (L, 5) uint32 outputs.
extern "C" int tdr_rans_words(const void* sym, const void* dist,
                              const void* cums, int64_t S, const void* prec,
                              const void* lengths, int64_t L, int64_t n,
                              int64_t cap_w, void* words, void* meta,
                              void* stream) {
  if (L == 0) return 0;
  const int threads = 64;
  const int64_t blocks = (L + threads - 1) / threads;
  rans_words_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sym, (const int32_t*)dist, (const int32_t*)cums, S,
      (const int32_t*)prec, (const int32_t*)lengths, L, n, cap_w,
      (uint32_t*)words, (uint32_t*)meta);
  return (int)cudaGetLastError();
}

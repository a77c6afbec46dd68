// D1: the multi-lane rANS decoder. One lane is one DirectCoded symbol
// stream, decoded back to front on its own table (or a shared one).
//
// Replaces tpudraco/ops/rans_lanes.py _rans_decode_scan and its packed
// P <= 14 form _rans_decode_scan_packed. Neither is a Pallas kernel: they
// are XLA lax.scan loops that step every lane in lockstep, one symbol per
// step, and look the symbol up in a (lanes, 2^P) slot table. The function:
// read the stream's metadata byte at nbytes - 1 and up to 3 state bytes
// before it (the framing of rans.rs:30-56), then for each symbol refill
// while state < l_base (at most 3 bytes, never past the stream's first
// byte), find the symbol s of r = state & (2^P - 1), and step
// state = (state >> P) * freq[s] + r - cum[s]. The output holds s, or
// `sentinel` past the lane's count.
//
// Bound on this card: the length of the dependent chain (one recurrence of
// up to T steps a lane, 12,288 on the group decode), not bytes. There is no
// slot table: at P = 20 it would be 4 MB a lane, built on the host,
// uploaded, and missed in cache at every step.
//
// Design: one block per lane, so the lanes spread over all 132 SMs. The
// block stages the lane's INCLUSIVE cumulative row inc[s] = f[0] + ... +
// f[s] in shared memory (S x 4 bytes; past ROW_MAX_BYTES the same kernel
// reads the row from global memory). The symbol of r is the first s with
// inc[s] > r; a symbol of frequency 0 has inc[s] == inc[s - 1] and is never
// the first. freq and cum come from the same row: cum = inc[s - 1] (0 for
// s = 0), freq = inc[s] - cum; the caller checked that the table is
// normalized, so these are the table's own. The search:
//   - an index over the top LOG_BUCKETS bits of r (all of r's bits where
//     P is smaller), built once per lane by all threads: idx[b] = the first
//     s with inc[s] > b << shift. For r in bucket b the symbol lies in
//     [idx[b], idx[b + 1]];
//   - idx[b] itself where its inclusive sum exceeds r (first[b] holds that
//     sum and cum, so both loads go by b and run side by side), which is
//     every time for a symbol at least as wide as a bucket; otherwise a
//     binary search of the rest of the range.
// The refill is taken off the chain too: the three stream bytes below the
// consumer's position are loaded as soon as the position is known, a step
// ahead, and the step counts the bytes it needs with three compares.
// Thread 0 (the consumer) runs the recurrence; warps 1..3 (the producers)
// keep the stream's bytes ahead of it in a ring in shared memory, loaded
// in coalesced pieces walking from the stream's end, and copy the symbols
// of the previous tile from shared memory to the (L, T) output in its final
// element size. One __syncthreads per tile of TILE symbols hands over.
//
// The ring: at the start of tile k the consumer is at byte `pos` and the
// ring holds [lo, pos) with lo <= pos - 3 * TILE (or lo == 0). A tile
// consumes at most 3 * TILE bytes, so during tile k the producers load
// [pos - 6 * TILE, lo): after the tile the invariant holds again, and the
// bytes written and read in one tile lie less than RING apart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;     // symbols per tile
constexpr int RING = 2048;    // bytes, a power of two >= 6 * TILE
constexpr int THREADS = 128;  // warp 0: consumer; 1-3: producers
constexpr int PRODUCERS = THREADS - 32;
constexpr int64_t ROW_MAX_BYTES = 160 * 1024;
// 2^11 buckets of 12 bytes keep a block at about 40 KB of shared memory
// beside a 4096-symbol row, so 512 lanes fit an H100 in one wave. Wrapper
// ms there at P=12 / P=20 by this value: 0 (a binary search of the whole
// row) 8.04 / 8.93, 6: 2.12 / 2.46, 9: 1.70 / 1.84, 11: 1.63 / 1.83,
// 12: 2.74 / 3.25 (NVIDIA H100 80GB HBM3, 700 W)
constexpr int32_t LOG_BUCKETS = 11;

// the first s in [lo, hi] with row[s] > v, or hi when there is none
__device__ __forceinline__ uint32_t first_above(const uint32_t* row,
                                                uint32_t lo, uint32_t hi,
                                                uint32_t v) {
  while (lo < hi) {
    const uint32_t mid = (lo + hi) >> 1;
    if (row[mid] > v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// the three stream bytes below `pos`, the first to be consumed on top;
// below the stream's start the ring holds anything, and no step uses it
__device__ __forceinline__ uint32_t below3(const uint8_t* ring, int pos) {
  return ((uint32_t)ring[(pos - 1) & (RING - 1)] << 16)
         | ((uint32_t)ring[(pos - 2) & (RING - 1)] << 8)
         | (uint32_t)ring[(pos - 3) & (RING - 1)];
}

__device__ __forceinline__ void store_symbol(void* out, int esz, int64_t at,
                                             int32_t v) {
  if (esz == 4) ((int32_t*)out)[at] = v;
  else if (esz == 2) ((uint16_t*)out)[at] = (uint16_t)v;
  else ((uint8_t*)out)[at] = (uint8_t)v;
}

template <bool ROW_IN_SMEM>
__global__ void __launch_bounds__(THREADS) rans_decode_kernel(
    const uint8_t* __restrict__ bufs, int64_t cap,
    const int32_t* __restrict__ nbytes, const uint32_t* __restrict__ inc,
    int64_t S, int64_t table_stride, const int32_t* __restrict__ counts,
    int64_t T, uint32_t p, uint32_t log_buckets, int32_t sentinel, int esz,
    void* __restrict__ out) {
  extern __shared__ int64_t smem_i64[];
  const uint32_t nb = 1u << log_buckets;
  int64_t* shared_pos = smem_i64;                       // [2]
  int32_t* otiles = (int32_t*)(shared_pos + 2);         // [2][TILE]
  uint8_t* ring = (uint8_t*)(otiles + 2 * TILE);        // [RING]
  uint2* first = (uint2*)(ring + RING);                 // [nb]
  uint32_t* idx = (uint32_t*)(first + nb);              // [nb + 1]
  uint32_t* srow = idx + nb + 1;                        // [S] if staged

  const int64_t l = blockIdx.x;
  const int tid = threadIdx.x;
  int64_t n = counts[l];
  n = n < 0 ? 0 : (n > T ? T : n);
  const uint8_t* stream = bufs + l * cap;
  const uint32_t* grow = inc + l * table_stride;
  const uint32_t* row = ROW_IN_SMEM ? srow : grow;
  const uint32_t l_base = 4u << p;
  const uint32_t rmask = (1u << p) - 1u;
  const uint32_t shift = p - log_buckets;
  const uint32_t last = (uint32_t)(S - 1);

  uint32_t x = 0;
  int64_t pos = 0;
  if (n > 0) {
    if (ROW_IN_SMEM) {
      for (int64_t i = tid; i < S; i += THREADS) srow[i] = grow[i];
      __syncthreads();
    }
    for (uint32_t b = tid; b <= nb; b += THREADS) {
      const uint32_t s = b == nb ? last : first_above(row, 0, last, b << shift);
      idx[b] = s;
      if (b < nb) first[b] = make_uint2(s ? row[s - 1] : 0u, row[s]);
    }
    if (tid == 0) {
      pos = (int64_t)nbytes[l] - 1;  // the caller checked 1..cap
      const uint32_t meta = stream[pos];
      const uint32_t flag = meta >> 6;
      for (uint32_t k = 0; k < flag; ++k) {
        --pos;
        x = (x << 8) | stream[pos > 0 ? pos : 0];
      }
      x = (x | ((meta & 0x3Fu) << (8 * flag))) + l_base;
      shared_pos[1] = pos;
    }
    __syncthreads();
    pos = shared_pos[1];
    // the ring's first fill: [pos - 6 * TILE, pos)
    const int64_t lo0 = pos > 6 * TILE ? pos - 6 * TILE : 0;
    for (int64_t a = lo0 + tid; a < pos; a += THREADS)
      ring[a & (RING - 1)] = stream[a];
  }
  __syncthreads();
  int64_t lo = pos > 6 * TILE ? pos - 6 * TILE : 0;  // producers' view

  const int64_t ntiles = (T + TILE - 1) / TILE;
  // iteration k: the consumer decodes tile k while the producers extend
  // the ring downwards and write out the symbols of tile k - 1
  for (int64_t k = 0; k <= ntiles; ++k) {
    if (tid == 0) {
      if (k < ntiles) {
        int32_t* ot = otiles + (k & 1) * TILE;
        const int64_t t0 = k * TILE;
        const int cnt = (int)(T - t0 < TILE ? T - t0 : TILE);
        const int live = (int)(n - t0 < 0 ? 0 : (n - t0 < cnt ? n - t0 : cnt));
        int at = (int)pos;  // cap < 2^31: nbytes is an int32
        uint32_t below = below3(ring, at);
        for (int i = 0; i < live; ++i) {
          // the refill loop's three tests at once: x * 256 + byte < l_base
          // iff x < l_base >> 8, whatever the byte
          uint32_t need = (uint32_t)(x < l_base) + (uint32_t)(x < (l_base >> 8))
                          + (uint32_t)(x < (l_base >> 16));
          need = at < (int)need ? (uint32_t)at : need;
          x = (x << (8 * need)) | (below >> (8 * (3 - need)));
          at -= (int)need;
          below = below3(ring, at);  // for the next step, off its chain
          const uint32_t r = x & rmask;
          const uint32_t b = r >> shift;
          uint32_t s = idx[b];   // two loads side by side, both by b
          const uint2 ct = first[b];
          uint32_t c = ct.x, top = ct.y;
          if (top <= r) {  // not the bucket's first symbol: search the rest
            s = first_above(row, s < last ? s + 1 : last, idx[b + 1], r);
            c = row[s - 1];
            top = row[s];
          }
          x = (x >> p) * (top - c) + r - c;
          ot[i] = (int32_t)s;
        }
        for (int i = live; i < cnt; ++i) ot[i] = sentinel;
        pos = at;
        shared_pos[k & 1] = pos;
      }
    } else if (tid >= 32) {
      if (k + 1 < ntiles && lo > 0) {  // pos: the consumer's at tile k's start
        const int64_t want = pos > 6 * TILE ? pos - 6 * TILE : 0;
        for (int64_t a = want + (tid - 32); a < lo; a += PRODUCERS)
          ring[a & (RING - 1)] = stream[a];
        if (want < lo) lo = want;
      }
      if (k > 0) {
        const int32_t* ot = otiles + ((k - 1) & 1) * TILE;
        const int64_t t0 = (k - 1) * TILE;
        const int cnt = (int)(T - t0 < TILE ? T - t0 : TILE);
        for (int i = tid - 32; i < cnt; i += PRODUCERS)
          store_symbol(out, esz, l * T + t0 + i, ot[i]);
      }
    }
    __syncthreads();
    // every thread: the consumer's position now (two slots in turn, so the
    // next tile's write does not race this read)
    if (k < ntiles) pos = shared_pos[k & 1];
  }
}

}  // namespace

// bufs (L, cap) uint8 streams; nbytes, counts (L,) int32; inc uint32 rows
// of S inclusive cumulative frequencies, `table_stride` apart (0: one table
// shared by every lane); out (L, T) elements of `esz` bytes (1, 2 or 4).
extern "C" int tdr_rans_decode(const void* bufs, int64_t cap,
                               const void* nbytes, const void* inc,
                               int64_t S, int64_t table_stride,
                               const void* counts, int64_t L, int64_t T,
                               int32_t prec, int32_t sentinel, int32_t esz,
                               void* out, void* stream) {
  if (L == 0 || T == 0) return 0;
  const int row_in_smem = S * (int64_t)sizeof(uint32_t) <= ROW_MAX_BYTES;
  const int32_t log_buckets = prec < LOG_BUCKETS ? prec : LOG_BUCKETS;
  const size_t nb = (size_t)1 << log_buckets;
  const size_t fixed = 2 * sizeof(int64_t) + 2 * TILE * sizeof(int32_t) + RING
                       + nb * sizeof(uint2) + (nb + 1) * sizeof(uint32_t);
  const size_t smem = fixed + (row_in_smem ? S * sizeof(uint32_t) : 0);
  auto kernel = row_in_smem ? rans_decode_kernel<true>
                            : rans_decode_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(fixed + ROW_MAX_BYTES));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)L, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bufs, cap, (const int32_t*)nbytes,
      (const uint32_t*)inc, S, table_stride, (const int32_t*)counts, T,
      (uint32_t)prec, (uint32_t)log_buckets, sentinel, esz, (void*)out);
  return (int)cudaGetLastError();
}

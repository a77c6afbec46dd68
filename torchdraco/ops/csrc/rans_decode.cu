// D1: the multi-lane rANS decoder. One lane is one DirectCoded symbol
// stream, decoded back to front on its own table (or a shared one).
//
// Replaces tpudraco/ops/rans_lanes.py _rans_decode_scan and its packed
// P <= 14 form _rans_decode_scan_packed. Neither is a Pallas kernel: they
// are XLA lax.scan loops that step every lane in lockstep, one symbol per
// step. Here one thread owns one lane. It reads the stream's metadata byte
// at nbytes - 1 and up to 3 state bytes before it (the framing of
// rans.rs:30-56), then for each symbol refills while state < l_base (at
// most 3 bytes, never past the stream's first byte), looks up the slot of
// r = state & (2^P - 1), and steps state = (state >> P) * freq + r - cum.
// It writes the slot's symbol, or `sentinel` past the lane's count. The
// packed form's table packing and 2-byte refill only shorten the TPU's
// gathers; on every valid stream they give the same symbols as this one.
//
// Bound on this card: latency. Each step is a chain of dependent loads
// (stream byte, slot, freq, cum), and 512 lanes are 16 warps on a 132-SM
// card. The output is (T, L) so a warp's stores land side by side; the
// stream bytes and the slot tables are read per lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rans_decode_kernel(
    const uint8_t* __restrict__ bufs, int64_t cap,
    const int32_t* __restrict__ nbytes, const int32_t* __restrict__ freqs,
    const int32_t* __restrict__ cums, int64_t S, int64_t table_stride,
    const int32_t* __restrict__ slots, int64_t slot_stride,
    const int32_t* __restrict__ counts, int64_t L, int64_t T, uint32_t p,
    int32_t sentinel, int32_t* __restrict__ out) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  int64_t n = counts[l];
  n = n < 0 ? 0 : (n > T ? T : n);
  if (n > 0) {
    const uint8_t* row = bufs + l * cap;
    const int32_t* frow = freqs + l * table_stride;
    const int32_t* crow = cums + l * table_stride;
    const int32_t* srow = slots + l * slot_stride;
    const uint32_t l_base = 4u << p;
    const uint32_t rmask = (1u << p) - 1u;
    int64_t pos = (int64_t)nbytes[l] - 1;  // the caller checked 1..cap
    const uint32_t meta = row[pos];
    const uint32_t flag = meta >> 6;
    uint32_t x = 0;
    for (uint32_t k = 0; k < flag; ++k) {
      --pos;
      x = (x << 8) | row[pos > 0 ? pos : 0];
    }
    x = (x | ((meta & 0x3Fu) << (8 * flag))) + l_base;
    for (int64_t t = 0; t < n; ++t) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (x < l_base && pos > 0) {
          --pos;
          x = x * 256u + row[pos];
        }
      }
      const uint32_t r = x & rmask;
      const int32_t s = srow[r];
      const int64_t sc = s < 0 ? 0 : (s >= S ? S - 1 : s);
      x = (x >> p) * (uint32_t)frow[sc] + r - (uint32_t)crow[sc];
      out[t * L + l] = s;
    }
  }
  for (int64_t t = n; t < T; ++t) out[t * L + l] = sentinel;
}

}  // namespace

// bufs (L, cap) uint8 streams; nbytes, counts (L,) int32; freqs/cums
// int32 rows of S entries and slots int32 rows of 2^prec entries, each row
// `stride` apart (0: one table shared by every lane); out (T, L) int32.
extern "C" int tdr_rans_decode(const void* bufs, int64_t cap,
                               const void* nbytes, const void* freqs,
                               const void* cums, int64_t S,
                               int64_t table_stride, const void* slots,
                               int64_t slot_stride, const void* counts,
                               int64_t L, int64_t T, int32_t prec,
                               int32_t sentinel, void* out, void* stream) {
  if (L == 0) return 0;
  const int threads = 64;
  const int64_t blocks = (L + threads - 1) / threads;
  rans_decode_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)bufs, cap, (const int32_t*)nbytes,
      (const int32_t*)freqs, (const int32_t*)cums, S, table_stride,
      (const int32_t*)slots, slot_stride, (const int32_t*)counts, L, T,
      (uint32_t)prec, sentinel, (int32_t*)out);
  return (int)cudaGetLastError();
}

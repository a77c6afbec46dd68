// K4: the multi-lane rANS encoder in its dense emission form. One lane is
// one symbol stream, coded at a precision shared by every lane.
//
// Replaces tpudraco/ops/pallas_kernels.py rans_scan_pallas (the dense-slot
// branch of rans_lanes.py _rans_scan_lanes). The TPU kernel ran a tile of
// lanes in lockstep in (8, 128) vector registers and carried the states
// across T chunks in a scratch tile; every step writes R = 3 byte slots and
// 3 mask slots, emitted or not, so a later pass can compact them. Here one
// thread owns one lane and runs its recurrence in uint32_t over the
// pre-gathered (freq, cum) of its first `length` symbols: renormalise (at
// most 3 bytes while state >= (4 * freq) << 8), then
// state = ((state / freq) << prec) + state % freq + cum. A renormalisation
// byte goes to slot t * 3 + r of the lane and its mask slot is set; the
// wrapper zeroes both outputs first, so an idle slot is never written and
// no step past `length` runs. A frequency of 0 (a symbol outside the
// table) takes what jnp's `//` and `%` give for an unsigned division by
// zero, quotient 0xFFFFFFFF and remainder 0, so the kernel and the JAX
// reference agree on every input.
//
// Bound on this card: latency. The recurrence is sequential within a lane,
// each step a dependent 32-bit division; 512 lanes are 16 warps on a
// 132-SM card. Inputs arrive as (T, L) and outputs leave as (3T, L), so
// the lanes of a warp touch neighbouring addresses at each step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void rans_dense_kernel(const int32_t* __restrict__ fs,
                                  const int32_t* __restrict__ cs,
                                  const int32_t* __restrict__ lengths,
                                  int64_t L, int64_t T, uint32_t p,
                                  uint8_t* __restrict__ bytes,
                                  uint8_t* __restrict__ mask,
                                  uint32_t* __restrict__ states) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  int64_t len = lengths[l];
  len = len < 0 ? 0 : (len > T ? T : len);
  uint32_t x = 4u << p;
  for (int64_t t = 0; t < len; ++t) {
    const uint32_t f = (uint32_t)fs[t * L + l];
    const uint32_t c = (uint32_t)cs[t * L + l];
    const uint32_t limit = (4u * f) << 8;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (x >= limit) {
        const int64_t slot = (3 * t + r) * L + l;
        bytes[slot] = (uint8_t)(x & 0xFFu);
        mask[slot] = 1;
        x >>= 8;
      }
    }
    const uint32_t q = f ? x / f : 0xFFFFFFFFu;
    const uint32_t m = f ? x % f : 0u;
    x = (q << p) + m + c;
  }
  states[l] = x;
}

}  // namespace

// fs/cs (T, L) int32 pre-gathered freq/cum (uint32 values); lengths (L,)
// int32; bytes/mask (3T, L) uint8, zeroed by the caller; states (L,) uint32.
extern "C" int tdr_rans_dense(const void* fs, const void* cs,
                              const void* lengths, int64_t L, int64_t T,
                              int32_t prec, void* bytes, void* mask,
                              void* states, void* stream) {
  if (L == 0) return 0;
  const int threads = 64;
  const int64_t blocks = (L + threads - 1) / threads;
  rans_dense_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)fs, (const int32_t*)cs, (const int32_t*)lengths, L, T,
      (uint32_t)prec, (uint8_t*)bytes, (uint8_t*)mask, (uint32_t*)states);
  return (int)cudaGetLastError();
}

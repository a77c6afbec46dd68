// K2: per-row symbol histogram (the rANS frequency counts of each mesh).
//
// Replaces tpudraco/ops/pallas_kernels.py histogram_pallas. The TPU has no
// fast scatter, so the Pallas kernel built int8 one-hots of each symbol's
// high and low 7 bits in VMEM and multiplied them on the MXU. Hopper has
// fast atomics in shared memory, so here a block zeroes a bin array in
// shared memory, its threads stride over their slice of a row adding one
// per symbol with atomicAdd, and the block writes the bins out.
// Symbols below 0 or at/above num_bins are DROPPED, never clamped, so a
// too-small bin count shows up downstream as a count deficit.
//
// Bins fit in shared memory up to 2^15 of them (128 KB, dynamic shared
// memory above 48 KB after cudaFuncSetAttribute); a Hopper block may use
// at most 227 KB. Past that (2^16 bins = 256 KB at -qp 15) the same kernel
// adds straight into the zero-initialised output row in global memory. The
// choice is made from the shape by the caller, not on failure.
//
// The grid is (rows, splits). With many rows (the batch path: 512 rows of
// 12288 symbols into 4096 bins) splits is 1: a block owns its row and
// stores its bins. One long row (a single mesh of 1M vertices: 3,145,728
// symbols, or a chunk of the streaming route: 98,304) would run on one of
// the 132 SMs that way, so the caller splits it: each block counts a slice
// in shared memory and adds its nonzero bins into the zeroed output row
// with atomicAdd (global-bins blocks add per symbol, as before).
//
// Bound on this card: atomics. The input is read once; residual symbols
// cluster near zero, so shared-memory atomics contend on a few bins.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void histogram_smem_kernel(const int32_t* __restrict__ sym,
                                      int64_t N, int64_t slice,
                                      int32_t num_bins,
                                      int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  for (int32_t i = threadIdx.x; i < num_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int32_t* row = sym + (int64_t)blockIdx.x * N;
  const int64_t begin = (int64_t)blockIdx.y * slice;
  const int64_t end = begin + slice < N ? begin + slice : N;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int32_t s = row[i];
    if (s >= 0 && s < num_bins) atomicAdd(&bins[s], 1);
  }
  __syncthreads();
  int32_t* o = out + (int64_t)blockIdx.x * num_bins;
  if (gridDim.y == 1) {
    for (int32_t i = threadIdx.x; i < num_bins; i += blockDim.x)
      o[i] = bins[i];
  } else {
    for (int32_t i = threadIdx.x; i < num_bins; i += blockDim.x) {
      const int32_t c = bins[i];
      if (c != 0) atomicAdd(&o[i], c);
    }
  }
}

__global__ void histogram_global_kernel(const int32_t* __restrict__ sym,
                                        int64_t N, int64_t slice,
                                        int32_t num_bins,
                                        int32_t* __restrict__ out) {
  const int32_t* row = sym + (int64_t)blockIdx.x * N;
  int32_t* o = out + (int64_t)blockIdx.x * num_bins;
  const int64_t begin = (int64_t)blockIdx.y * slice;
  const int64_t end = begin + slice < N ? begin + slice : N;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int32_t s = row[i];
    if (s >= 0 && s < num_bins) atomicAdd(&o[s], 1);
  }
}

}  // namespace

// use_smem: 1 = bins in shared memory, 0 = atomics into out. splits: blocks
// a row (1 to 65535). out may be uninitialised only when use_smem == 1 and
// splits == 1; otherwise the caller has zeroed it.
extern "C" int tdr_histogram(const void* sym, int64_t B, int64_t N,
                             int32_t num_bins, void* out, int32_t use_smem,
                             int32_t splits, void* stream) {
  if (B == 0) return 0;
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 512;
  const int64_t slice = (N + splits - 1) / splits;
  const dim3 grid((unsigned)B, (unsigned)splits);
  cudaStream_t s = (cudaStream_t)stream;
  if (use_smem) {
    const size_t bytes = (size_t)num_bins * sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        histogram_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    histogram_smem_kernel<<<grid, threads, bytes, s>>>(
        (const int32_t*)sym, N, slice, num_bins, (int32_t*)out);
  } else {
    histogram_global_kernel<<<grid, threads, 0, s>>>(
        (const int32_t*)sym, N, slice, num_bins, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// K2: per-row symbol histogram (the rANS frequency counts of each mesh).
//
// Replaces tpudraco/ops/pallas_kernels.py histogram_pallas. The TPU has no
// fast scatter, so the Pallas kernel built int8 one-hots of each symbol's
// high and low 7 bits in VMEM and multiplied them on the MXU. Hopper has
// fast atomics in shared memory, so here each block owns one row: it zeroes
// a bin array in shared memory, every thread strides over the row adding
// one per symbol with atomicAdd, and the block writes the row's bins out.
// Symbols below 0 or at/above num_bins are DROPPED, never clamped, so a
// too-small bin count shows up downstream as a count deficit.
//
// Bins fit in shared memory up to 2^15 of them (128 KB, dynamic shared
// memory above 48 KB after cudaFuncSetAttribute); a Hopper block may use
// at most 227 KB. Past that (2^16 bins = 256 KB at -qp 15) the same kernel
// adds straight into the zero-initialised output row in global memory. The
// choice is made from the shape by the caller, not on failure.
//
// Bound on this card: atomics. At the slice shape (512 rows of 12288
// symbols into 4096 bins) the input is 25 MB, read once; residual symbols
// cluster near zero, so shared-memory atomics contend on a few bins. One
// block per row gives 512 blocks for 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void histogram_smem_kernel(const int32_t* __restrict__ sym,
                                      int64_t N, int32_t num_bins,
                                      int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  for (int32_t i = threadIdx.x; i < num_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const int32_t* row = sym + (int64_t)blockIdx.x * N;
  for (int64_t i = threadIdx.x; i < N; i += blockDim.x) {
    const int32_t s = row[i];
    if (s >= 0 && s < num_bins) atomicAdd(&bins[s], 1);
  }
  __syncthreads();
  int32_t* o = out + (int64_t)blockIdx.x * num_bins;
  for (int32_t i = threadIdx.x; i < num_bins; i += blockDim.x) o[i] = bins[i];
}

__global__ void histogram_global_kernel(const int32_t* __restrict__ sym,
                                        int64_t N, int32_t num_bins,
                                        int32_t* __restrict__ out) {
  const int32_t* row = sym + (int64_t)blockIdx.x * N;
  int32_t* o = out + (int64_t)blockIdx.x * num_bins;
  for (int64_t i = threadIdx.x; i < N; i += blockDim.x) {
    const int32_t s = row[i];
    if (s >= 0 && s < num_bins) atomicAdd(&o[s], 1);
  }
}

}  // namespace

// use_smem: 1 = bins in shared memory (out may be uninitialised),
// 0 = atomics into out, which the caller has zeroed.
extern "C" int tdr_histogram(const void* sym, int64_t B, int64_t N,
                             int32_t num_bins, void* out, int32_t use_smem,
                             void* stream) {
  if (B == 0) return 0;
  const int threads = 512;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_smem) {
    const size_t bytes = (size_t)num_bins * sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        histogram_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    histogram_smem_kernel<<<(unsigned)B, threads, bytes, s>>>(
        (const int32_t*)sym, N, num_bins, (int32_t*)out);
  } else {
    histogram_global_kernel<<<(unsigned)B, threads, 0, s>>>(
        (const int32_t*)sym, N, num_bins, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

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
// A block keeps bins [0, smem_bins) in shared memory: every bin up to
// 58,112 of them (227 KB, the most a Hopper block may use; dynamic shared
// memory above 48 KB after cudaFuncSetAttribute). Past that (2^16 bins at
// -qp 15, 2^17 at -qp 16) the wide form keeps the first 58,112 bins in
// shared memory and adds the rest straight into the output row with global
// atomics: zigzagged residuals cluster near 0, so almost every symbol of a
// real mesh lands in shared memory. A block of a split row keeps fewer
// (a quarter of its slice's symbols): it zeroes and flushes every shared
// bin, and 58,112 of them would cost it more than its symbols. The caller
// picks smem_bins from the shape (ops/device.py histogram_smem_bins), not
// on failure. A thread block cluster holding every bin in distributed
// shared memory was timed against this form and lost (PERF.md section 6).
//
// The grid is (rows, splits). With many rows (the batch path: 512 rows of
// 12288 symbols) splits is 1: a block owns its row, zeroes the row's
// global tail [smem_bins, num_bins) itself before it counts, and stores
// its shared bins with 16-byte stores, so the output needs no zeroing
// first (at 2^16 bins that fill was 134 MB). One long row (a single mesh
// of 1M vertices: 3,145,728 symbols, or a chunk of the streaming route:
// 98,304) would run on one of the 132 SMs that way, so the caller splits
// it: each block counts a slice in shared memory and adds its nonzero
// bins into the zeroed output row with atomicAdd.
//
// Bound on this card: bytes, the rows read once and the bins written once;
// residual symbols cluster near zero, so shared-memory atomics contend on
// a few bins.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The counts of bins [0, n) in shared memory into the output row o: with
// 16-byte stores where o is 16-byte aligned (a whole row) and n a multiple
// of 4, or added where the row is split over blocks.
__device__ __forceinline__ void flush_bins(const int32_t* bins, int32_t n,
                                           int32_t* o, bool own) {
  if (!own) {
    for (int32_t i = threadIdx.x; i < n; i += blockDim.x) {
      const int32_t c = bins[i];
      if (c != 0) atomicAdd(&o[i], c);
    }
  } else if (((uintptr_t)o & 15) == 0 && (n & 3) == 0) {
    for (int32_t i = threadIdx.x; i < n / 4; i += blockDim.x)
      ((int4*)o)[i] = ((const int4*)bins)[i];
  } else {
    for (int32_t i = threadIdx.x; i < n; i += blockDim.x) o[i] = bins[i];
  }
}

__global__ void histogram_smem_kernel(const int32_t* __restrict__ sym,
                                      int64_t N, int64_t slice,
                                      int32_t num_bins, int32_t smem_bins,
                                      int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  const bool own = gridDim.y == 1;  // one block a row: it stores its bins
  int32_t* o = out + (int64_t)blockIdx.x * num_bins;
  for (int32_t i = threadIdx.x; i < smem_bins; i += blockDim.x) bins[i] = 0;
  if (own) {  // the row's global tail, zeroed before any symbol lands there
    int32_t* tail = o + smem_bins;
    const int32_t n = num_bins - smem_bins;
    int32_t i0 = 0;
    if (((uintptr_t)tail & 15) == 0) {
      i0 = n & ~3;
      for (int32_t i = threadIdx.x; i < n / 4; i += blockDim.x)
        ((int4*)tail)[i] = make_int4(0, 0, 0, 0);
    }
    for (int32_t i = i0 + threadIdx.x; i < n; i += blockDim.x) tail[i] = 0;
  }
  __syncthreads();
  const int32_t* row = sym + (int64_t)blockIdx.x * N;
  const int64_t begin = (int64_t)blockIdx.y * slice;
  const int64_t end = begin + slice < N ? begin + slice : N;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int32_t s = row[i];
    if (s >= 0 && s < smem_bins) {
      atomicAdd(&bins[s], 1);
    } else if (s >= smem_bins && s < num_bins) {
      atomicAdd(&o[s], 1);
    }
  }
  __syncthreads();
  flush_bins(bins, smem_bins, o, own);
}

}  // namespace

// smem_bins: the bins a block keeps in shared memory (num_bins, or fewer
// for the wide form; the rest take global atomics). splits: blocks a row
// (1 to 65535). out may be uninitialised when splits == 1; otherwise the
// caller has zeroed it.
extern "C" int tdr_histogram(const void* sym, int64_t B, int64_t N,
                             int32_t num_bins, void* out, int32_t smem_bins,
                             int32_t splits, void* stream) {
  if (B == 0) return 0;
  if (splits < 1 || splits > 65535 || smem_bins < 1 || smem_bins > num_bins)
    return (int)cudaErrorInvalidValue;
  const int threads = 512;
  const int64_t slice = (N + splits - 1) / splits;
  const dim3 grid((unsigned)B, (unsigned)splits);
  const size_t bytes = (size_t)smem_bins * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  histogram_smem_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)sym, N, slice, num_bins, smem_bins, (int32_t*)out);
  return (int)cudaGetLastError();
}

// K1: parallelogram prediction fused with the wrapped-difference residual
// and the zigzag, for a batch of meshes that share one topology.
//
// Replaces tpudraco/ops/pallas_kernels.py predict_matmul_pallas (with the
// residual tail of tpudraco/ops/device.py encode_step_pallas_from_q). The
// TPU kernel folded the seven gathers into a dense (2T, V) int8 matrix and
// multiplied it on the MXU in two 7-bit planes, which made it exact only to
// 14 bits and cost T*V bytes of matrix per topology. Here the gathers are
// read directly: a (mesh, traversal step) row reads its
// order/next/prev/opp/fallback indices and masks, gathers C components of
// q, predicts, clips to the mesh's [vmin, vmax] (from the host quantize),
// wraps and zigzags, and writes C int32 symbols. No matrix, no depth cap.
//
// Bound on this card: memory traffic. q is read once (V*C*2 bytes a mesh
// for uint16) and the symbols written once (T*C*4 bytes a mesh); the
// gather arrays are shared by every mesh. At B=512, V=T=4096, C=3 that is
// 12.6 MB in and 25.2 MB out, 11 us at 3.35 TB/s.
//
// Two kernels, chosen by the caller from the shape alone:
//
// predict_rows_kernel (the rule): a block owns one mesh. It brings the
// mesh's q row into shared memory with asynchronous 4-byte copies
// (cp.async; plain loads where the row is not 4-byte aligned) and computes
// the mesh's residual range once. A thread then walks the traversal: it
// reads a step's indices and masks, coalesced, and gathers from shared
// memory, so no gather goes to device memory behind an index load. A warp
// stages its 32 steps' symbols in shared memory and stores them as one
// contiguous run of 16-byte pieces (32-bit where a mesh's rows are not
// 16-byte aligned). The block index is the mesh: no division. The
// component count, 1 to 4, is a template argument, so the component loop
// unrolls. (Blocks of 2 and 4 meshes, which read a step's indices once for
// all of them, were slower on the card: fewer blocks an SM hide less
// latency.)
//
// The rows lie skewed in shared memory: one 32-bit word of padding after
// every 32 words. A traversal walks rings of a mesh, and on a grid 64
// vertices wide the vertices of a warp's 32 steps lie 63, 64 and 1 apart:
// 64 vertices of three uint16 are 96 words, a multiple of the 32 banks, so
// unskewed rows put about 11 lanes of every gather on one bank (counted
// from the topology; the first version of this kernel took 0.047 ms for
// it, no less than the direct gathers it replaced).
//
// predict_gather_kernel: one thread per row gathering from device memory,
// for q rows past the shared-memory budget (huge meshes) and for more than
// 4 components.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS_THREADS = 256;
constexpr int ROWS_WARPS = ROWS_THREADS / 32;

// wrapped_difference.rs:36-99: corrections wrap into
// [min_corr, max_corr]; max_diff = 1 + vmax - vmin >= 1
struct Range {
  int32_t lo, hi, max_diff, max_corr;
};

__device__ __forceinline__ Range mesh_range(int32_t lo, int32_t hi) {
  Range r;
  r.lo = lo;
  r.hi = hi;
  r.max_diff = 1 + hi - lo;
  r.max_corr = r.max_diff / 2;
  return r;
}

__device__ __forceinline__ int32_t residual_symbol(int32_t orig,
                                                   int32_t pred,
                                                   const Range& r) {
  pred = pred < r.lo ? r.lo : (pred > r.hi ? r.hi : pred);
  const int32_t min_corr = -r.max_corr;
  const int32_t max_corr = r.max_corr - ((r.max_diff & 1) == 0);
  const int32_t val = orig - pred;
  const int32_t corr = val > max_corr   ? val - r.max_diff
                       : val < min_corr ? val + r.max_diff
                                        : val;
  return corr >= 0 ? (corr << 1) : (((-(corr + 1)) << 1) + 1);
}

// 4 bytes from device memory to shared memory, without a register between
__device__ __forceinline__ void copy4_async(void* smem, const void* gmem) {
#if defined(__CUDA_ARCH__)
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
#else
  memcpy(smem, gmem, 4);
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Where element e of a row lies in shared memory: one word of padding
// after every 32 words (128 bytes) of the row.
template <typename QT>
__device__ __host__ __forceinline__ int skewed(int e) {
  constexpr int PER_WORD = 4 / (int)sizeof(QT);
  constexpr int PER_LINE = 128 / (int)sizeof(QT);
  return e + (e / PER_LINE) * PER_WORD;
}

// Elements of shared memory a skewed row of row_len elements takes,
// rounded up to 16 bytes.
template <typename QT>
__device__ __host__ __forceinline__ int skewed_row(int row_len) {
  constexpr int PER_16 = 16 / (int)sizeof(QT);
  return (skewed<QT>(row_len) + PER_16) / PER_16 * PER_16;
}

// Dynamic shared memory: [skewed_row(V * C)] QT, then
// [ROWS_WARPS][32 * C] int32 of staged symbols.
template <typename QT, int C>
__global__ void __launch_bounds__(ROWS_THREADS) predict_rows_kernel(
    const QT* __restrict__ q, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ prv,
    const int32_t* __restrict__ opp, const int32_t* __restrict__ fb,
    const uint8_t* __restrict__ can_para, const uint8_t* __restrict__ has_fb,
    const int32_t* __restrict__ vmin, const int32_t* __restrict__ vmax,
    int32_t* __restrict__ out, int64_t V, int64_t T) {
  extern __shared__ uint4 smem[];
  __shared__ Range range;
  constexpr int PER_WORD = 4 / (int)sizeof(QT);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int row_len = (int)(V * C);  // elements of one mesh's q
  const int row_smem = skewed_row<QT>(row_len);
  QT* qb = (QT*)smem;
  int32_t* stage = (int32_t*)(qb + row_smem) + warp * 32 * C;

  const QT* src = q + b * row_len;
  if (((uintptr_t)src & 3) == 0) {
    const int whole = row_len / PER_WORD * PER_WORD;
    for (int e = tid * PER_WORD; e < whole; e += ROWS_THREADS * PER_WORD)
      copy4_async(qb + skewed<QT>(e), src + e);
    if (tid == 0 && whole < row_len) qb[skewed<QT>(whole)] = src[whole];
    copy_async_wait();
  } else {
    for (int e = tid; e < row_len; e += ROWS_THREADS)
      qb[skewed<QT>(e)] = src[e];
  }
  if (tid == 0) range = mesh_range(vmin[b], vmax[b]);
  __syncthreads();
  const Range r = range;

  // a mesh's symbol rows start 16-byte aligned when T * C * 4 divides so
  const bool vec = (T * C) % 4 == 0 && ((uintptr_t)out & 15) == 0;
  for (int t0 = warp * 32; t0 < T; t0 += ROWS_THREADS) {
    const int t = t0 + lane;
    const bool live = t < T;
    const bool para = live && can_para[t] != 0;
    const bool use_fb = live && !para && has_fb[t] != 0;
    // indices are read only where their mask says they are meaningful
    const int io = live ? order[t] * C : 0;
    const int in = para ? nxt[t] * C : 0;
    const int ip = para ? prv[t] * C : 0;
    const int id = para ? opp[t] * C : 0;
    const int iff = use_fb ? fb[t] * C : 0;
    const int n = (int)(T - t0 < 32 ? T - t0 : 32) * C;  // staged symbols
    if (live) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        int32_t pred = 0;
        if (para) {
          pred = (int32_t)qb[skewed<QT>(in + c)]
                 + (int32_t)qb[skewed<QT>(ip + c)]
                 - (int32_t)qb[skewed<QT>(id + c)];
        } else if (use_fb) {
          pred = (int32_t)qb[skewed<QT>(iff + c)];
        }
        stage[lane * C + c] =
            residual_symbol((int32_t)qb[skewed<QT>(io + c)], pred, r);
      }
    }
    __syncwarp();
    int32_t* dst = out + (b * T + t0) * C;
    if (vec) {
      const int n4 = n / 4;
      for (int j = lane; j < n4; j += 32)
        ((uint4*)dst)[j] = ((const uint4*)stage)[j];
      for (int j = 4 * n4 + lane; j < n; j += 32) dst[j] = stage[j];
    } else {
      for (int j = lane; j < n; j += 32) dst[j] = stage[j];
    }
    __syncwarp();
  }
}

template <typename QT>
__global__ void predict_gather_kernel(
    const QT* __restrict__ q, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ prv,
    const int32_t* __restrict__ opp, const int32_t* __restrict__ fb,
    const uint8_t* __restrict__ can_para, const uint8_t* __restrict__ has_fb,
    const int32_t* __restrict__ vmin, const int32_t* __restrict__ vmax,
    int32_t* __restrict__ out, int64_t B, int64_t V, int64_t T, int C) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B * T) return;
  const int64_t b = row / T;
  const int64_t t = row - b * T;
  const QT* qb = q + b * V * C;

  const Range r = mesh_range(vmin[b], vmax[b]);

  const bool para = can_para[t] != 0;
  const bool use_fb = !para && has_fb[t] != 0;
  const int64_t io = (int64_t)order[t] * C;
  // indices are read only where their mask says they are meaningful
  const int64_t in = para ? (int64_t)nxt[t] * C : 0;
  const int64_t ip = para ? (int64_t)prv[t] * C : 0;
  const int64_t id = para ? (int64_t)opp[t] * C : 0;
  const int64_t iff = use_fb ? (int64_t)fb[t] * C : 0;

  int32_t* o = out + row * C;
  for (int c = 0; c < C; ++c) {
    int32_t pred = 0;
    if (para) {
      pred = (int32_t)qb[in + c] + (int32_t)qb[ip + c] - (int32_t)qb[id + c];
    } else if (use_fb) {
      pred = (int32_t)qb[iff + c];
    }
    o[c] = residual_symbol((int32_t)qb[io + c], pred, r);
  }
}

template <typename QT, int C>
int launch_rows(const void* q, const void* const* gathers, const void* vmin,
                const void* vmax, void* out, int64_t B, int64_t V, int64_t T,
                void* stream) {
  const int64_t smem = (int64_t)skewed_row<QT>((int)(V * C)) * sizeof(QT)
                       + (int64_t)ROWS_WARPS * 32 * C * 4;
  auto kernel = predict_rows_kernel<QT, C>;
  if (smem > 48 * 1024) {  // past the default limit of dynamic shared memory
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)B, ROWS_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const QT*)q, (const int32_t*)gathers[0], (const int32_t*)gathers[1],
      (const int32_t*)gathers[2], (const int32_t*)gathers[3],
      (const int32_t*)gathers[4], (const uint8_t*)gathers[5],
      (const uint8_t*)gathers[6], (const int32_t*)vmin, (const int32_t*)vmax,
      (int32_t*)out, V, T);
  return (int)cudaGetLastError();
}

// rows: 1 for predict_rows_kernel, where the caller found that the mesh's
// skewed q row fits shared memory and C is 1 to 4; 0 for
// predict_gather_kernel.
template <typename QT>
int launch(const void* q, const void* order, const void* nxt,
           const void* prv, const void* opp, const void* fb,
           const void* can_para, const void* has_fb, const void* vmin,
           const void* vmax, void* out, int64_t B, int64_t V, int64_t T,
           int32_t C, int32_t rows, void* stream) {
  if (B * T == 0) return 0;
  if (rows) {
    const void* gathers[7] = {order, nxt, prv, opp, fb, can_para, has_fb};
    switch (C) {
      case 1:
        return launch_rows<QT, 1>(q, gathers, vmin, vmax, out, B, V, T,
                                  stream);
      case 2:
        return launch_rows<QT, 2>(q, gathers, vmin, vmax, out, B, V, T,
                                  stream);
      case 3:
        return launch_rows<QT, 3>(q, gathers, vmin, vmax, out, B, V, T,
                                  stream);
      case 4:
        return launch_rows<QT, 4>(q, gathers, vmin, vmax, out, B, V, T,
                                  stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const int threads = 256;
  const int64_t blocks = (B * T + threads - 1) / threads;
  predict_gather_kernel<QT><<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const QT*)q, (const int32_t*)order, (const int32_t*)nxt,
      (const int32_t*)prv, (const int32_t*)opp, (const int32_t*)fb,
      (const uint8_t*)can_para, (const uint8_t*)has_fb,
      (const int32_t*)vmin, (const int32_t*)vmax, (int32_t*)out, B, V, T, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdr_predict_residual_u16(
    const void* q, const void* order, const void* nxt, const void* prv,
    const void* opp, const void* fb, const void* can_para,
    const void* has_fb, const void* vmin, const void* vmax, void* out,
    int64_t B, int64_t V, int64_t T, int32_t C, int32_t rows,
    void* stream) {
  return launch<uint16_t>(q, order, nxt, prv, opp, fb, can_para, has_fb,
                          vmin, vmax, out, B, V, T, C, rows, stream);
}

extern "C" int tdr_predict_residual_i32(
    const void* q, const void* order, const void* nxt, const void* prv,
    const void* opp, const void* fb, const void* can_para,
    const void* has_fb, const void* vmin, const void* vmax, void* out,
    int64_t B, int64_t V, int64_t T, int32_t C, int32_t rows,
    void* stream) {
  return launch<int32_t>(q, order, nxt, prv, opp, fb, can_para, has_fb,
                         vmin, vmax, out, B, V, T, C, rows, stream);
}

extern "C" const char* tdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

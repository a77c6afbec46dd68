// K1: parallelogram prediction fused with the wrapped-difference residual
// and the zigzag, for a batch of meshes that share one topology.
//
// Replaces tpudraco/ops/pallas_kernels.py predict_matmul_pallas (with the
// residual tail of tpudraco/ops/device.py encode_step_pallas_from_q). The
// TPU kernel folded the seven gathers into a dense (2T, V) int8 matrix and
// multiplied it on the MXU in two 7-bit planes, which made it exact only to
// 14 bits and cost T*V bytes of matrix per topology. Here the gathers are
// read directly: one thread per (mesh, traversal step) row reads its
// order/next/prev/opp/fallback indices and masks, gathers C components of
// q, predicts, clips to the mesh's [vmin, vmax] (from the host quantize),
// wraps and zigzags, and writes C int32 symbols. No matrix, no depth cap.
//
// Bound on this card: memory traffic. Per row it reads 5 int32 indices and
// 2 mask bytes (shared by every mesh, so L2-resident), up to 5*C gathered
// values of a mesh's q (V*C*2 bytes = 24 KB at V=4096, u16, so L1/L2
// resident while the mesh's rows run), and writes C*4 bytes. At the slice
// shape (B=512, T=4096, C=3) that is ~25 MB of symbols written plus ~12 MB
// of q read once from HBM: a floor of ~11 us at 3.35 TB/s, which this
// first version does not reach (each row also pays a 64-bit divide and
// dependent gathers). Rows of one mesh are contiguous in the grid, so a
// block works on one mesh's q.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename QT>
__global__ void predict_residual_kernel(
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

  const int32_t lo = vmin[b];
  const int32_t hi = vmax[b];
  // wrapped_difference.rs:36-99: corrections wrap into
  // [min_corr, max_corr]; max_diff = 1 + vmax - vmin >= 1
  const int32_t max_diff = 1 + hi - lo;
  int32_t max_corr = max_diff / 2;
  const int32_t min_corr = -max_corr;
  if ((max_diff & 1) == 0) max_corr -= 1;

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
    pred = pred < lo ? lo : (pred > hi ? hi : pred);
    const int32_t val = (int32_t)qb[io + c] - pred;
    const int32_t corr = val > max_corr   ? val - max_diff
                         : val < min_corr ? val + max_diff
                                          : val;
    o[c] = corr >= 0 ? (corr << 1) : (((-(corr + 1)) << 1) + 1);
  }
}

template <typename QT>
int launch(const void* q, const void* order, const void* nxt,
           const void* prv, const void* opp, const void* fb,
           const void* can_para, const void* has_fb, const void* vmin,
           const void* vmax, void* out, int64_t B, int64_t V, int64_t T,
           int32_t C, void* stream) {
  const int64_t rows = B * T;
  if (rows == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (rows + threads - 1) / threads;
  predict_residual_kernel<QT><<<(unsigned)blocks, threads, 0,
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
    int64_t B, int64_t V, int64_t T, int32_t C, void* stream) {
  return launch<uint16_t>(q, order, nxt, prv, opp, fb, can_para, has_fb,
                          vmin, vmax, out, B, V, T, C, stream);
}

extern "C" int tdr_predict_residual_i32(
    const void* q, const void* order, const void* nxt, const void* prv,
    const void* opp, const void* fb, const void* can_para,
    const void* has_fb, const void* vmin, const void* vmax, void* out,
    int64_t B, int64_t V, int64_t T, int32_t C, void* stream) {
  return launch<int32_t>(q, order, nxt, prv, opp, fb, can_para, has_fb,
                         vmin, vmax, out, B, V, T, C, stream);
}

extern "C" const char* tdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

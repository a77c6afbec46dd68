// C3: the TEX_COORD attribute's device encode chain.
//
// Replaces the XLA program of tpudraco/ops/texcoords.py (uv_encode_chain,
// jitted as _uv_chain_x64 at :191), which XLA fuses into a few kernels.
// Its plain version in the port (ops/texcoords.py _uv_chain_impl) is eager
// torch operations: about 900 launches a call, three quarters of them the
// 32 + 64 fixed rounds of the integer square root over every step, and
// about 768 B of int64 temporaries a vertex. Here two kernels:
// - uv_range_kernel, a block a mesh: the mesh's UV range (the min and max
//   over both components of every unique value), which every step's
//   WrappedDifference needs before it starts; it also clears the mesh's
//   risky flag;
// - uv_step_kernel, a thread a (mesh, traversal step): the TexCoord
//   prediction in 64-bit integers with its guards, draco's integer square
//   root with its loops ending early (while act >= 2; while sqrt * sqrt >
//   value: the fixed rounds of the plain version stop changing the value
//   there), orientation, the fallbacks, the WrappedDifference against the
//   range and zigzag to 32 bits. A risky step sets its mesh's flag (every
//   writer stores 1).
//
// Bound on this card: operations, not bytes. A step is a few hundred
// 64-bit integer operations, and a 64-bit division is a routine of some
// tens of instructions; the square root's Newton steps divide too.
//
// Bit for bit the plain version's arithmetic. torch's int64 products,
// sums and negations wrap mod 2^64, and the plain version lets some of
// them wrap on purpose (the product read as unsigned against 2^62) or
// without effect (rows that the guards send to the host): here every such
// operation is taken in uint64, since signed overflow is undefined in C++.
// Divisions are torch's: floor division (c10::div_floor_integer), and the
// truncating _tdiv built from it on the absolute values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr i64 kI64Max = 0x7FFFFFFFFFFFFFFFLL;
constexpr i64 k2p62 = 1LL << 62;

__device__ __forceinline__ i64 wadd(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wsub(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 wmul(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}
__device__ __forceinline__ i64 wneg(i64 a) { return (i64)(0ULL - (u64)a); }
__device__ __forceinline__ i64 wabs(i64 a) { return a < 0 ? wneg(a) : a; }
__device__ __forceinline__ i64 sgn(i64 a) { return (a > 0) - (a < 0); }
__device__ __forceinline__ i64 imax(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ i64 imin(i64 a, i64 b) { return a < b ? a : b; }

// torch.div(a, b, rounding_mode="floor") on int64; a divisor of -1 negates
// (the one quotient that can overflow wraps, as the product by -1 would)
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  if (b == -1) return wneg(a);
  if ((a < 0) != (b < 0)) {
    const i64 q = a / b;
    return a % b ? q - 1 : q;
  }
  return a / b;
}

// ops/texcoords.py _tdiv: sign(a) * sign(b) * floor(|a| / |b|)
__device__ __forceinline__ i64 tdiv(i64 a, i64 b) {
  return wmul(sgn(a) * sgn(b), floor_div(wabs(a), wabs(b)));
}

// ops/texcoords.py _wrap32: the low 32 bits, sign-extended
__device__ __forceinline__ i64 wrap32(i64 x) {
  return (i64)(int32_t)(uint32_t)(u64)x;
}

// draco's integer square root of 0 <= value < 2^62 (ops/texcoords.py
// _int_sqrt_dev): a power-of-two seed, one averaged Newton step, then
// Newton steps down while the square passes the value
__device__ __forceinline__ i64 int_sqrt(i64 value) {
  if (value <= 0) return 0;
  i64 act = value, s = 1;
  while (act >= 2) {
    s *= 2;
    act >>= 2;
  }
  s = (s + value / s) >> 1;
  while (wmul(s, s) > value) s = (s + value / (s > 0 ? s : 1)) >> 1;
  return s;
}

constexpr int kRangeThreads = 1024;

__global__ void uv_range_kernel(const int32_t* __restrict__ q_uv, int64_t n,
                                int32_t* __restrict__ vmin,
                                int32_t* __restrict__ vmax,
                                bool* __restrict__ risky) {
  __shared__ int32_t lo_s[kRangeThreads], hi_s[kRangeThreads];
  const int32_t* row = q_uv + (int64_t)blockIdx.x * n;
  int32_t lo = INT32_MAX, hi = INT32_MIN;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t v = row[i];
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
  }
  lo_s[threadIdx.x] = lo;
  hi_s[threadIdx.x] = hi;
  __syncthreads();
  for (unsigned s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const int32_t a = lo_s[threadIdx.x + s], b = hi_s[threadIdx.x + s];
      if (a < lo_s[threadIdx.x]) lo_s[threadIdx.x] = a;
      if (b > hi_s[threadIdx.x]) hi_s[threadIdx.x] = b;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    vmin[blockIdx.x] = lo_s[0];
    vmax[blockIdx.x] = hi_s[0];
    risky[blockIdx.x] = false;
  }
}

__global__ void uv_step_kernel(
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ q_uv,
    const int64_t* __restrict__ uo_pos, const int64_t* __restrict__ uo_uv,
    const int64_t* __restrict__ cpt, const int64_t* __restrict__ npt,
    const int64_t* __restrict__ ppt, const int64_t* __restrict__ last_pt,
    const bool* __restrict__ vis_n, const bool* __restrict__ vis_p,
    const bool* __restrict__ ok_n, const bool* __restrict__ ok_p,
    const bool* __restrict__ ok_c, const int32_t* __restrict__ vmin,
    const int32_t* __restrict__ vmax, int64_t B, int64_t Vp, int64_t Vu,
    int64_t T, int32_t* __restrict__ sym, bool* __restrict__ orient,
    bool* __restrict__ geo_v, bool* __restrict__ risky) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * T) return;
  const int64_t b = i / T, t = i - b * T;
  const int32_t* qp = q_pos + b * Vp * 3;
  const int32_t* qu = q_uv + b * Vu * 2;
  const int32_t* un = qu + 2 * uo_uv[npt[t]];
  const int32_t* up = qu + 2 * uo_uv[ppt[t]];
  const int32_t* uc = qu + 2 * uo_uv[cpt[t]];
  const i64 nuv[2] = {un[0], un[1]}, puv[2] = {up[0], up[1]},
            cuv[2] = {uc[0], uc[1]};
  i64 cpos[3] = {0, 0, 0}, npos[3] = {0, 0, 0}, ppos[3] = {0, 0, 0};
  if (ok_c[t]) {
    const int32_t* v = qp + 3 * uo_pos[cpt[t]];
    for (int k = 0; k < 3; ++k) cpos[k] = v[k];
  }
  if (ok_n[t]) {
    const int32_t* v = qp + 3 * uo_pos[npt[t]];
    for (int k = 0; k < 3; ++k) npos[k] = v[k];
  }
  if (ok_p[t]) {
    const int32_t* v = qp + 3 * uo_pos[ppt[t]];
    for (int k = 0; k < 3; ++k) ppos[k] = v[k];
  }

  const bool vn = vis_n[t];
  const bool geo_try = vn && vis_p[t];
  const bool eq = nuv[0] == puv[0] && nuv[1] == puv[1];
  i64 pn[3], cn[3];
  for (int k = 0; k < 3; ++k) {
    pn[k] = ppos[k] - npos[k];
    cn[k] = cpos[k] - npos[k];
  }
  i64 pn_norm2 = 0, cn_dot_pn = 0, pn_am = 0;
  for (int k = 0; k < 3; ++k) {
    pn_norm2 = wadd(pn_norm2, wmul(pn[k], pn[k]));
    cn_dot_pn = wadd(cn_dot_pn, wmul(pn[k], cn[k]));
    pn_am = imax(pn_am, wabs(pn[k]));
  }
  const i64 pn_uv[2] = {puv[0] - nuv[0], puv[1] - nuv[1]};
  const bool nz = pn_norm2 != 0;
  const bool wide = pn_am >= (1LL << 20);
  const i64 pn_norm2_s = nz ? pn_norm2 : 1;
  const bool g1 = imax(wabs(nuv[0]), wabs(nuv[1]))
                  > floor_div(kI64Max, pn_norm2_s);
  const i64 pn_uv_am = imax(wabs(pn_uv[0]), wabs(pn_uv[1]));
  const bool g2 = pn_uv_am != 0
                  && wabs(cn_dot_pn) > floor_div(kI64Max, pn_uv_am);
  const bool g3 = wabs(cn_dot_pn)
                  > floor_div(kI64Max, pn_am != 0 ? pn_am : 1);
  const bool geo = geo_try && !eq && nz && !(g1 || g2 || g3);

  i64 x_uv[2], cx_norm2 = 0;
  for (int k = 0; k < 2; ++k)
    x_uv[k] = wadd(wmul(nuv[k], pn_norm2_s), wmul(pn_uv[k], cn_dot_pn));
  for (int k = 0; k < 3; ++k) {
    const i64 x_pos = wadd(npos[k], tdiv(wmul(pn[k], cn_dot_pn), pn_norm2_s));
    const i64 cx = wsub(cpos[k], x_pos);
    cx_norm2 = wadd(cx_norm2, wmul(cx, cx));
  }
  // the host's uint64 product, >= 2^62 read as unsigned
  const i64 prod = wmul(cx_norm2, pn_norm2);
  bool rk = geo && (prod < 0 || prod >= k2p62);
  const i64 norm_sq = int_sqrt((rk || !geo) ? 0 : prod);
  rk = rk || (geo && wmul(imax(pn_uv_am, 1), norm_sq) >= k2p62);
  rk = rk || (geo && imax(wabs(x_uv[0]), wabs(x_uv[1])) >= k2p62);
  rk = rk || (geo_try && !eq && wide);
  const bool gv = geo && !rk;

  const i64 cx_uv[2] = {wmul(pn_uv[1], norm_sq), wmul(wneg(pn_uv[0]), norm_sq)};
  i64 pred0[2], pred1[2], d0 = 0, d1 = 0;
  for (int k = 0; k < 2; ++k) {
    pred0[k] = tdiv(wadd(x_uv[k], cx_uv[k]), pn_norm2_s);
    pred1[k] = tdiv(wsub(x_uv[k], cx_uv[k]), pn_norm2_s);
    const i64 e0 = wsub(cuv[k], pred0[k]), e1 = wsub(cuv[k], pred1[k]);
    d0 = wadd(d0, wmul(e0, e0));
    d1 = wadd(d1, wmul(e1, e1));
  }
  const bool ori = d0 < d1;

  // WrappedDifference against the mesh's range, then zigzag
  const i64 lo = vmin[b], hi = vmax[b];
  const i64 max_diff = 1 + hi - lo;
  i64 max_corr = floor_div(max_diff, 2);
  const i64 min_corr = -max_corr;
  if ((max_diff & 1) == 0) max_corr -= 1;
  for (int k = 0; k < 2; ++k) {
    i64 p;
    if (gv) {
      p = wrap32(ori ? pred0[k] : pred1[k]);
    } else if (vn) {
      p = nuv[k];
    } else if (t == 0) {
      p = 0;
    } else {
      p = qu[2 * uo_uv[last_pt[t]] + k];
    }
    p = imin(imax(p, lo), hi);
    const i64 val = cuv[k] - p;
    const i64 corr = val > max_corr ? val - max_diff
                     : val < min_corr ? val + max_diff : val;
    const u64 z = corr >= 0 ? (u64)corr << 1 : ((u64)(-(corr + 1)) << 1) + 1;
    sym[2 * i + k] = (int32_t)(uint32_t)z;
  }
  orient[i] = ori;
  geo_v[i] = gv;
  if (rk) risky[b] = true;
}

constexpr int kStepThreads = 256;

}  // namespace

// C3: q_pos (B, Vp, 3) and q_uv (B, Vu, 2) int32; uo_pos, uo_uv int64
// point -> unique-value maps; cpt, npt, ppt, last_pt (T,) int64 points;
// vis_n, vis_p, ok_n, ok_p, ok_c (T,) bool (shared/prediction.py
// collect_uv_gathers). Out: sym (B, T, 2) int32 (the wire's uint32 bits),
// vmin and vmax (B,) int32, orient and geo_v (B, T) bool, risky (B,) bool.
// Vu >= 1. Two kernels: the range, then the steps.
extern "C" int tdr_uv_encode(const void* q_pos, const void* q_uv,
                             const void* uo_pos, const void* uo_uv,
                             const void* cpt, const void* npt,
                             const void* ppt, const void* last_pt,
                             const void* vis_n, const void* vis_p,
                             const void* ok_n, const void* ok_p,
                             const void* ok_c, int64_t B, int64_t Vp,
                             int64_t Vu, int64_t T, void* sym, void* vmin,
                             void* vmax, void* orient, void* geo_v,
                             void* risky, void* stream) {
  if (B == 0) return 0;
  if (Vu < 1 || B > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  uv_range_kernel<<<(unsigned)B, kRangeThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q_uv, Vu * 2, (int32_t*)vmin, (int32_t*)vmax,
      (bool*)risky);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || T == 0) return (int)err;
  uv_step_kernel<<<(unsigned)((B * T + kStepThreads - 1) / kStepThreads),
                   kStepThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q_pos, (const int32_t*)q_uv, (const int64_t*)uo_pos,
      (const int64_t*)uo_uv, (const int64_t*)cpt, (const int64_t*)npt,
      (const int64_t*)ppt, (const int64_t*)last_pt, (const bool*)vis_n,
      (const bool*)vis_p, (const bool*)ok_n, (const bool*)ok_p,
      (const bool*)ok_c, (const int32_t*)vmin, (const int32_t*)vmax, B, Vp,
      Vu, T, (int32_t*)sym, (bool*)orient, (bool*)geo_v, (bool*)risky);
  return (int)cudaGetLastError();
}

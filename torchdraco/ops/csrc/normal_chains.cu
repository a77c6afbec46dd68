// C1 and C2: the NORMAL attribute's device chains, encode and decode.
//
// Replace the XLA programs of tpudraco/ops/normals.py (normal_encode_chain,
// jitted at :259-260, and normal_decode_chain, :292), which XLA fuses into
// a few kernels. Their plain versions in the port (ops/normals.py
// _normal_encode_chain_impl, _normal_decode_chain_impl) are eager torch
// operations: 300-360 launches a call, and about 192 B of int64
// temporaries for each (mesh, step, ring slot). Here one thread takes one
// (mesh, traversal step) and keeps the ring sum, the octahedral
// transforms, the flip selection and the OctahedralOrthogonal transform in
// registers: the kernel reads its inputs and writes its outputs, nothing
// else. A warp takes 32 consecutive steps of one mesh, so the ring tables
// (shared by every mesh of the batch) stay in L2 and a mesh's positions in
// L1.
//
// Bound on this card: the bytes of the inputs and outputs (positions,
// normals, ring tables, symbols) at the batch shapes; the ring loop skips
// masked slots, so a fan vertex of valence 80 costs only its own thread 80
// iterations.
//
// Bit for bit the plain version's arithmetic:
// - each cross product wraps to int32 (the host's int32 products): its low
//   32 bits are those of uint32 products, so it is taken in uint32; the
//   ring sum is kept unwrapped in int64 for the 2^29 clamp, truncating
//   division by floor(abs_sum / 2^29), then wrapped to int32;
// - every float step is one IEEE operation, rounded to nearest
//   (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn: never contracted into an
//   FMA, whatever -fmad says); a quotient of zero is zero itself, for any
//   divisor (ops/normals.py _f32_div); int32 -> float32 rounds to nearest
//   even and the quantize truncates toward zero (cvt.rzi), as torch's
//   casts do;
// - the remainder of the decode takes the divisor's sign (torch.remainder),
//   and a first-match search gives 0 where nothing matches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float f32_div(float a, float b) {
  return a == 0.0f ? a : __fdiv_rn(a, b);
}

// Octahedral coordinates of a float (x, y, z), not normalized
// (ops/normals.py oct_transform_device on float input).
__device__ __forceinline__ void oct_coords(float x, float y, float z,
                                           float& ou, float& ov) {
  const float abs_sum = __fadd_rn(__fadd_rn(fabsf(x), fabsf(y)), fabsf(z));
  const float u = f32_div(y, abs_sum);
  const float w = f32_div(z, abs_sum);
  if (x < 0.0f) {
    ou = u < 0.0f ? __fsub_rn(fabsf(w), 1.0f) : __fsub_rn(1.0f, fabsf(w));
    ov = w < 0.0f ? __fsub_rn(fabsf(u), 1.0f) : __fsub_rn(1.0f, fabsf(u));
  } else {
    ou = u;
    ov = w;
  }
}

// (oct + 1) * scale, truncated toward zero (oct_quantize_device).
__device__ __forceinline__ int32_t quantize(float o, float scale) {
  return __float2int_rz(__fmul_rn(__fadd_rn(o, 1.0f), scale));
}

// The faithful edge fix-ups (into_faithful_device) at max mx.
__device__ __forceinline__ void into_faithful(int32_t& u, int32_t& v,
                                              int32_t mx) {
  const int32_t half = mx / 2;
  int32_t x = u, y = v;
  if ((u == 0 && v == 0) || (u == mx && v == 0) || (u == 0 && v == mx)) {
    x = mx;
    y = mx;
  } else if (u == 0 && v > half) {
    y = half - (v - half);
  } else if (u == mx && v < half) {
    y = half + (half - v);
  } else if (v == mx && u < half) {
    x = half + (half - u);
  } else if (v == 0 && u > half) {
    x = half - (u - half);
  }
  u = x;
  v = y;
}

// The involutive diamond inversion on centred coords (invert_diamond_device).
__device__ __forceinline__ void invert_diamond(int32_t& s, int32_t& t,
                                               int32_t center) {
  int32_t sign_s, sign_t;
  if (s >= 0 && t >= 0) {
    sign_s = 1;
    sign_t = 1;
  } else {
    const bool both_nonpos = s <= 0 && t <= 0;
    sign_s = (both_nonpos || s <= 0) ? -1 : 1;
    sign_t = (both_nonpos || t <= 0) ? -1 : 1;
  }
  const int32_t cs = sign_s * center, ct = sign_t * center;
  const int32_t s2 = 2 * s - cs, t2 = 2 * t - ct;
  const bool rotate = sign_s * sign_t >= 0;
  const int32_t ns = rotate ? -t2 : t2, nt = rotate ? -s2 : s2;
  // (ns + cs) and (nt + ct) are even: the arithmetic shift halves exactly
  s = (ns + cs) >> 1;
  t = (nt + ct) >> 1;
}

// Its exact preimage: the first of five candidates that maps back to w,
// the first candidate where none does (invert_diamond_inverse_device).
__device__ __forceinline__ void invert_diamond_inverse(int32_t& w0,
                                                       int32_t& w1,
                                                       int32_t c) {
  int32_t cand[5][2] = {{w0, w1},
                        {c - w1, c - w0},
                        {-w1 - c, -w0 - c},
                        {w1 + c, w0 - c},
                        {w1 - c, w0 + c}};
  invert_diamond(cand[0][0], cand[0][1], c);
  int k = 0;
  for (int j = 0; j < 5; ++j) {
    int32_t a = cand[j][0], b = cand[j][1];
    invert_diamond(a, b, c);
    if (a == w0 && b == w1) {
      k = j;
      break;
    }
  }
  w0 = cand[k][0];
  w1 = cand[k][1];
}

// The ring-sum prediction of one step (ops/normals.py _ring_predict): the
// faithful oct-quantized prediction (p0, p1), (0, 0) for an empty or
// zero-sum ring. q is the mesh's (V, 3) row; the step's ring slots are
// nxt/prv/msk[0, R); rows go through remap where it is given (the
// encoder's point -> unique value map).
__device__ __forceinline__ void ring_predict(
    const int32_t* __restrict__ q, int64_t tip,
    const int64_t* __restrict__ nxt, const int64_t* __restrict__ prv,
    const bool* __restrict__ msk, int32_t R,
    const int64_t* __restrict__ remap, int32_t mx, float scale, int32_t& p0,
    int32_t& p1) {
  const uint32_t tx = q[3 * tip], ty = q[3 * tip + 1], tz = q[3 * tip + 2];
  int64_t s0 = 0, s1 = 0, s2 = 0;
  for (int32_t r = 0; r < R; ++r) {
    if (!msk[r]) continue;
    int64_t in = nxt[r], ip = prv[r];
    if (remap != nullptr) {
      in = remap[in];
      ip = remap[ip];
    }
    const int32_t* a = q + 3 * in;
    const int32_t* b = q + 3 * ip;
    const uint32_t n0 = (uint32_t)a[0] - tx, n1 = (uint32_t)a[1] - ty,
                   n2 = (uint32_t)a[2] - tz;
    const uint32_t m0 = (uint32_t)b[0] - tx, m1 = (uint32_t)b[1] - ty,
                   m2 = (uint32_t)b[2] - tz;
    s0 += (int32_t)(n1 * m2 - n2 * m1);
    s1 += (int32_t)(n2 * m0 - n0 * m2);
    s2 += (int32_t)(n0 * m1 - n1 * m0);
  }
  const int64_t upper = (int64_t)1 << 29;
  const int64_t abs_sum = (s0 < 0 ? -s0 : s0) + (s1 < 0 ? -s1 : s1)
                          + (s2 < 0 ? -s2 : s2);
  if (abs_sum > upper) {
    const int64_t qd = abs_sum / upper;
    s0 /= qd;
    s1 /= qd;
    s2 /= qd;
  }
  const int32_t t0 = (int32_t)(uint32_t)s0, t1 = (int32_t)(uint32_t)s1,
                t2 = (int32_t)(uint32_t)s2;
  if (t0 == 0 && t1 == 0 && t2 == 0) {
    p0 = 0;
    p1 = 0;
    return;
  }
  // integer input: normalized first, each square rounded, summed from the
  // left
  const float fx = __int2float_rn(t0), fy = __int2float_rn(t1),
              fz = __int2float_rn(t2);
  const float nsq = __fadd_rn(__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)),
                              __fmul_rn(fz, fz));
  const float norm = __fsqrt_rn(nsq);
  float ou, ov;
  oct_coords(f32_div(fx, norm), f32_div(fy, norm), f32_div(fz, norm), ou, ov);
  p0 = quantize(ou, scale);
  p1 = quantize(ov, scale);
  into_faithful(p0, p1, mx);
}

__global__ void normal_encode_kernel(
    const int32_t* __restrict__ q_pos, const float* __restrict__ normals,
    const int64_t* __restrict__ tip_pt, const int64_t* __restrict__ next_pt,
    const int64_t* __restrict__ prev_pt, const bool* __restrict__ mask,
    const int64_t* __restrict__ uo_pos, const int64_t* __restrict__ uo_nrm,
    int64_t B, int64_t Vp, int64_t Vn, int64_t T, int32_t R, int32_t bits,
    int32_t* __restrict__ sym, bool* __restrict__ flips) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * T) return;
  const int64_t b = i / T, t = i - b * T;
  const int32_t mx = (1 << bits) - 1, one = mx / 2;
  const float scale = (float)((1 << (bits - 1)) - 1);
  const int64_t tp = tip_pt[t];
  int32_t p0, p1;
  ring_predict(q_pos + b * Vp * 3, uo_pos[tp], next_pt + t * R,
               prev_pt + t * R, mask + t * R, R, uo_pos, mx, scale, p0, p1);
  // the step's own normal, oct-quantized with the fix-ups
  const float* n = normals + (b * Vn + uo_nrm[tp]) * 3;
  float ou, ov;
  oct_coords(n[0], n[1], n[2], ou, ov);
  int32_t o0 = quantize(ou, scale), o1 = quantize(ov, scale);
  into_faithful(o0, o1, mx);
  // flip selection: exact int64 squared distances
  const int64_t a0 = (int64_t)(p0 - o0), a1 = (int64_t)(p1 - o1);
  const int64_t c0 = (int64_t)(-p0 - o0), c1 = (int64_t)(-p1 - o1);
  const bool flip_pred = a0 * a0 + a1 * a1 > c0 * c0 + c1 * c1;
  if (flip_pred) {
    p0 = -p0;
    p1 = -p1;
  }
  // the OctahedralOrthogonal squeeze
  int32_t oo0 = o0 - one, oo1 = o1 - one, pp0 = p0 - one, pp1 = p1 - one;
  if (abs(pp0) + abs(pp1) > one) {
    invert_diamond(pp0, pp1, one);
    invert_diamond(oo0, oo1, one);
  }
  if (pp0 != 0 || pp1 != 0) {
    for (int k = 0; k < 4; ++k) {
      if (pp0 >= 0 || pp1 > 0) {
        const int32_t x = pp0;
        pp0 = -pp1;
        pp1 = x;
        const int32_t y = oo0;
        oo0 = -oo1;
        oo1 = y;
      }
    }
  }
  int32_t d0 = oo0 - pp0, d1 = oo1 - pp1;
  if (d0 < 0) d0 += mx;
  if (d1 < 0) d1 += mx;
  sym[2 * i] = d0;
  sym[2 * i + 1] = d1;
  flips[i] = flip_pred;
}

__global__ void normal_decode_kernel(
    const int32_t* __restrict__ q_pos, const int32_t* __restrict__ symbols,
    const bool* __restrict__ flips, const int64_t* __restrict__ tip_i,
    const int64_t* __restrict__ next_i, const int64_t* __restrict__ prev_i,
    const bool* __restrict__ mask, int64_t B, int64_t Vp, int64_t T,
    int32_t R, int32_t bits, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * T) return;
  const int64_t b = i / T, t = i - b * T;
  const int32_t mx = (1 << bits) - 1, one = mx / 2;
  const float scale = (float)((1 << (bits - 1)) - 1);
  int32_t p0, p1;
  ring_predict(q_pos + b * Vp * 3, tip_i[t], next_i + t * R, prev_i + t * R,
               mask + t * R, R, nullptr, mx, scale, p0, p1);
  if (flips[i]) {
    p0 = -p0;
    p1 = -p1;
  }
  int32_t pp0 = p0 - one, pp1 = p1 - one;
  const bool flip = abs(pp0) + abs(pp1) > one;
  if (flip) invert_diamond(pp0, pp1, one);
  // the first of four quarter turns that puts p in the third quadrant
  // (0 where p is zero or none does), and p turned that far
  int r = 0;
  if (pp0 != 0 || pp1 != 0) {
    int32_t x = pp0, y = pp1;
    for (int k = 0; k < 4; ++k) {
      if (x < 0 && y <= 0) {
        r = k;
        break;
      }
      const int32_t nx = -y;
      y = x;
      x = nx;
    }
  }
  for (int k = 0; k < r; ++k) {
    const int32_t nx = -pp1;
    pp1 = pp0;
    pp0 = nx;
  }
  // the remainder takes the divisor's sign, as torch.remainder does
  int32_t o0 = (pp0 + symbols[2 * i] + one) % mx;
  int32_t o1 = (pp1 + symbols[2 * i + 1] + one) % mx;
  if (o0 < 0) o0 += mx;
  if (o1 < 0) o1 += mx;
  o0 -= one;
  o1 -= one;
  for (int k = 0; k < r; ++k) {  // turned back: (x, y) -> (y, -x)
    const int32_t nx = o1;
    o1 = -o0;
    o0 = nx;
  }
  if (flip) invert_diamond_inverse(o0, o1, one);
  out[2 * i] = o0 + one;
  out[2 * i + 1] = o1 + one;
}

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// C1: q_pos (B, Vp, 3) int32, normals (B, Vn, 3) float32, tip_pt (T,) and
// next_pt / prev_pt (T, R) int64 point indices, mask (T, R) bool, uo_pos /
// uo_nrm int64 point -> unique-value maps. Out: sym (B, T, 2) int32, flips
// (B, T) bool. 1 <= bits <= 16.
extern "C" int tdr_normal_encode(const void* q_pos, const void* normals,
                                 const void* tip_pt, const void* next_pt,
                                 const void* prev_pt, const void* mask,
                                 const void* uo_pos, const void* uo_nrm,
                                 int64_t B, int64_t Vp, int64_t Vn, int64_t T,
                                 int32_t R, int32_t bits, void* sym,
                                 void* flips, void* stream) {
  if (B * T == 0) return 0;
  if (bits < 1 || bits > 16 || R < 0) return (int)cudaErrorInvalidValue;
  normal_encode_kernel<<<blocks_for(B * T), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)q_pos, (const float*)normals, (const int64_t*)tip_pt,
      (const int64_t*)next_pt, (const int64_t*)prev_pt, (const bool*)mask,
      (const int64_t*)uo_pos, (const int64_t*)uo_nrm, B, Vp, Vn, T, R, bits,
      (int32_t*)sym, (bool*)flips);
  return (int)cudaGetLastError();
}

// C2: q_pos (B, Vp, 3) int32 decoded positions by vertex, symbols (B, T, 2)
// int32, flips (B, T) bool, tip_i (T,) and next_i / prev_i (T, R) int64
// vertex rows, mask (T, R) bool. Out: (B, T, 2) int32 oct values.
extern "C" int tdr_normal_decode(const void* q_pos, const void* symbols,
                                 const void* flips, const void* tip_i,
                                 const void* next_i, const void* prev_i,
                                 const void* mask, int64_t B, int64_t Vp,
                                 int64_t T, int32_t R, int32_t bits,
                                 void* out, void* stream) {
  if (B * T == 0) return 0;
  if (bits < 1 || bits > 16 || R < 0) return (int)cudaErrorInvalidValue;
  normal_decode_kernel<<<blocks_for(B * T), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)q_pos, (const int32_t*)symbols, (const bool*)flips,
      (const int64_t*)tip_i, (const int64_t*)next_i, (const int64_t*)prev_i,
      (const bool*)mask, B, Vp, T, R, bits, (int32_t*)out);
  return (int)cudaGetLastError();
}

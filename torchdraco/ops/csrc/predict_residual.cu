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
// q comes in the layout it crossed the link in (parallel/batch.py
// upload_layout): uint8 (at most 8 bits), the 12-bit pack (at most 12),
// uint16 (at most 16) or int32. The pack is native.pack12's: value i of a
// mesh's row is lo[i] | ((hb[i >> 1] >> ((i & 1) * 4)) & 0xF) << 8, with
// lo (B, V*C) bytes and hb (B, ceil(V*C / 2)) bytes, the nibbles paired
// within a row (an odd row's last nibble pairs with zero). Each layout is
// a source type (Plain<QT>, Pack12) that the kernels take as a template
// argument; the pack is undone where a value is read, so no unpacked copy
// of q is written to device memory.
//
// Three kernels, chosen by the caller from the shape alone:
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
// The 12-bit pack is unpacked while the row is staged: a thread reads 4
// bytes of lo and 2 of hb (coalesced) and writes 4 uint16 values of the
// skewed row, so the gather phase reads the same uint16 row as for the
// uint16 layout. uint8 rows are staged as they are, 4 values a copy.
//
// predict_tiled_kernel (q rows past the budget: meshes of more than
// about 18K vertices at uint16, C = 3): the traversal is cut into tiles
// of `tile` steps (2,048 on the main path), and a block owns one (mesh,
// tile). Gathering from device memory, a step reads 4 scattered vertices
// (order, and next / prev / opp or the fallback), at least one 32-byte
// L2 sector each (two with the pack, whose lo and hb are separate reads):
// that form is bound by L2 sectors, not by q's bytes. A tile of steps
// touches few distinct vertices (1.04-1.43 a step on grids of 64^2 to
// 512^2, counted from the topology), so per topology the host side
// builds tile tables (ops/device.py predict_tiles): each tile's sorted
// distinct vertex ids (verts, delimited by off) and each step's five
// indices as int16 positions in its tile's list (local, (5, T), -1 where
// the step's masks leave the index unread). The block copies its tile's
// local indices into shared memory with 16-byte asynchronous copies
// (10 bytes a step, where the direct gather read 22 of indices and
// masks) while it stages the tile's vertices from q, a slot of four
// staged elements a vertex (the pack unpacked while staging, so hb is
// read once), in sorted order, so that neighbouring threads share
// sectors. Then it walks the tile's steps, a thread a step, reading
// shared memory only, with the rows kernel's residual, wrap and zigzag.
//
// predict_gather_kernel: one thread per row gathering from device memory,
// for more than 4 components; it unpacks the 12-bit layout at each read.

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

// 16 bytes from device memory to shared memory, around L1
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
#if defined(__CUDA_ARCH__)
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
#else
  memcpy(smem, gmem, 16);
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

// A q layout: Smem is the type of a staged row's elements, at() reads
// value i of mesh b's row of row_len values from device memory.
template <typename QT>
struct Plain {
  using Smem = QT;
  const QT* q;
  __device__ __forceinline__ int32_t at(int64_t b, int64_t row_len,
                                        int64_t i) const {
    return (int32_t)q[b * row_len + i];
  }
};

struct Pack12 {
  using Smem = uint16_t;
  const uint8_t* lo;
  const uint8_t* hb;
  __device__ __forceinline__ int32_t at(int64_t b, int64_t row_len,
                                        int64_t i) const {
    const uint8_t h = hb[b * ((row_len + 1) >> 1) + (i >> 1)];
    return (int32_t)lo[b * row_len + i]
           | (int32_t)((h >> ((i & 1) * 4)) & 0xF) << 8;
  }
};

// Mesh b's row into the skewed shared row qb, by all ROWS_THREADS threads:
// 4-byte asynchronous copies where the row starts 4-byte aligned, the
// last row_len % (4 / sizeof(QT)) values by plain stores.
template <typename QT>
__device__ __forceinline__ void stage_row(const Plain<QT>& src, QT* qb,
                                          int64_t b, int row_len,
                                          int tid) {
  constexpr int PER_WORD = 4 / (int)sizeof(QT);
  const QT* q = src.q + b * row_len;
  int whole = 0;
  if (((uintptr_t)q & 3) == 0) {
    whole = row_len / PER_WORD * PER_WORD;
    for (int e = tid * PER_WORD; e < whole; e += ROWS_THREADS * PER_WORD)
      copy4_async(qb + skewed<QT>(e), q + e);
  }
  for (int e = whole + tid; e < row_len; e += ROWS_THREADS)
    qb[skewed<QT>(e)] = q[e];
  copy_async_wait();
}

// The 12-bit pack into a uint16 row: where lo starts 4-byte aligned and
// hb 2-byte aligned, a thread unpacks 4 values from one 4-byte load of lo
// and one 2-byte load of hb (nibbles of values e .. e + 3 in bits 0-15,
// low first) and stores them as two words (the 4 values share a line of
// the skewed row, e being a multiple of 4); the rest value by value.
__device__ __forceinline__ void stage_row(const Pack12& src, uint16_t* qb,
                                          int64_t b, int row_len, int tid) {
  const uint8_t* lo = src.lo + b * row_len;
  const uint8_t* hb = src.hb + b * ((row_len + 1) >> 1);
  int whole = 0;
  if (((uintptr_t)lo & 3) == 0 && ((uintptr_t)hb & 1) == 0) {
    whole = row_len / 4 * 4;
    for (int e = tid * 4; e < whole; e += ROWS_THREADS * 4) {
      const uint32_t l = *(const uint32_t*)(lo + e);
      const uint32_t h = *(const uint16_t*)(hb + (e >> 1));
      uint32_t* dst = (uint32_t*)(qb + skewed<uint16_t>(e));
      dst[0] = (l & 0xFFu) | ((h & 0xFu) << 8) | ((l & 0xFF00u) << 8)
               | ((h & 0xF0u) << 20);
      dst[1] = ((l >> 16) & 0xFFu) | ((h & 0xF00u)) | ((l >> 24) << 16)
               | ((h & 0xF000u) << 12);
    }
  }
  for (int e = whole + tid; e < row_len; e += ROWS_THREADS) {
    const uint8_t h = hb[e >> 1];
    qb[skewed<uint16_t>(e)] =
        (uint16_t)(lo[e] | (((h >> ((e & 1) * 4)) & 0xF) << 8));
  }
}

// Dynamic shared memory: [skewed_row(V * C)] Src::Smem, then
// [ROWS_WARPS][32 * C] int32 of staged symbols.
template <typename Src, int C>
__global__ void __launch_bounds__(ROWS_THREADS) predict_rows_kernel(
    Src src, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ prv,
    const int32_t* __restrict__ opp, const int32_t* __restrict__ fb,
    const uint8_t* __restrict__ can_para, const uint8_t* __restrict__ has_fb,
    const int32_t* __restrict__ vmin, const int32_t* __restrict__ vmax,
    int32_t* __restrict__ out, int64_t V, int64_t T) {
  using QT = typename Src::Smem;
  extern __shared__ uint4 smem[];
  __shared__ Range range;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int row_len = (int)(V * C);  // values of one mesh's q
  const int row_smem = skewed_row<QT>(row_len);
  QT* qb = (QT*)smem;
  int32_t* stage = (int32_t*)(qb + row_smem) + warp * 32 * C;

  stage_row(src, qb, b, row_len, tid);
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

// The tiled kernel stages a vertex's C values (C <= 4) as one slot of
// four staged elements, read back by one vector load: 4 bytes for uint8,
// 8 for uint16 and the unpacked 12-bit pack, 16 for int32. A step's five
// gathers are then five shared-memory loads, where three components of
// uint16 in a skewed row took fifteen loads and their index arithmetic:
// the walk over the steps issues instructions, it does not wait on
// memory (variants timed on the card: the walk cost more than the
// staging).
template <typename QT>
struct Slot;
template <>
struct Slot<uint8_t> {
  using V = uint32_t;
  __device__ __forceinline__ static V pack(const int32_t* v) {
    return (uint32_t)(v[0] & 0xFF) | (uint32_t)(v[1] & 0xFF) << 8
           | (uint32_t)(v[2] & 0xFF) << 16 | (uint32_t)v[3] << 24;
  }
  __device__ __forceinline__ static int32_t at(V s, int c) {
    return (int32_t)((s >> (8 * c)) & 0xFFu);
  }
};
template <>
struct Slot<uint16_t> {
  using V = uint2;
  __device__ __forceinline__ static V pack(const int32_t* v) {
    return make_uint2((uint32_t)(v[0] & 0xFFFF) | (uint32_t)v[1] << 16,
                      (uint32_t)(v[2] & 0xFFFF) | (uint32_t)v[3] << 16);
  }
  __device__ __forceinline__ static int32_t at(V s, int c) {
    const uint32_t w = c < 2 ? s.x : s.y;
    return (int32_t)((w >> (16 * (c & 1))) & 0xFFFFu);
  }
};
template <>
struct Slot<int32_t> {
  using V = int4;
  __device__ __forceinline__ static V pack(const int32_t* v) {
    return make_int4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static int32_t at(V s, int c) {
    return c == 0 ? s.x : c == 1 ? s.y : c == 2 ? s.z : s.w;
  }
};

// The tile's nv vertices of mesh b into their slots, by all ROWS_THREADS
// threads, a thread a vertex: each thread loads the C values of UNROLL
// vertices before it stores their slots, so that its loads are in flight
// together.
template <int C, typename Src>
__device__ __forceinline__ void stage_slots(
    const Src& src, typename Slot<typename Src::Smem>::V* slots,
    const int32_t* __restrict__ verts, int nv, int64_t b, int64_t row_len,
    int tid) {
  using S = Slot<typename Src::Smem>;
  constexpr int UNROLL = 4;
  for (int v0 = tid; v0 < nv; v0 += ROWS_THREADS * UNROLL) {
    int32_t val[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * ROWS_THREADS;
      const int64_t base = v < nv ? (int64_t)verts[v] * C : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        val[u][c] = c < C && v < nv ? src.at(b, row_len, base + c) : 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * ROWS_THREADS;
      if (v < nv) slots[v] = S::pack(val[u]);
    }
  }
}

// Steps [s0, s0 + len) of the five rows of local indices into lt, five
// rows of `tile`: 16-byte asynchronous copies where every row starts
// 16-byte aligned (T a multiple of 8), the rest one by one. The caller
// waits for the copies.
__device__ __forceinline__ void stage_local(const int16_t* __restrict__ local,
                                            int16_t* lt, int64_t T,
                                            int64_t s0, int len, int tile,
                                            int tid) {
  int whole = 0;
  if (T % 8 == 0 && ((uintptr_t)local & 15) == 0) {
    whole = len / 8 * 8;
    const int per = whole / 8;  // 16-byte pieces a row
    for (int i = tid; i < 5 * per; i += ROWS_THREADS) {
      const int k = i / per;
      const int j = (i - k * per) * 8;
      copy16_async(lt + k * tile + j, local + k * T + s0 + j);
    }
  }
  const int rest = len - whole;
  for (int i = tid; i < 5 * rest; i += ROWS_THREADS) {
    const int k = i / rest;
    const int j = whole + i - k * rest;
    lt[k * tile + j] = local[k * T + s0 + j];
  }
}

// Dynamic shared memory: [5][tile] int16 of the tile's local indices,
// then [max_verts] slots of its vertices. Block i owns mesh i / n_tiles
// and tile i % n_tiles; max_verts is the largest tile's vertex count,
// which sizes the slots. The local indices are copied asynchronously
// while the vertices are staged, so that the walk over the steps reads
// shared memory only. A thread writes its step's C symbols itself: the
// rows kernel's warp-staged 16-byte stores made the walk slower here
// (variants timed on the card). Four blocks an SM: the walk then fits 64
// registers without spilling.
template <typename Src, int C>
__global__ void __launch_bounds__(ROWS_THREADS, 4) predict_tiled_kernel(
    Src src, const int32_t* __restrict__ verts,
    const int32_t* __restrict__ off, const int16_t* __restrict__ local,
    const int32_t* __restrict__ vmin, const int32_t* __restrict__ vmax,
    int32_t* __restrict__ out, int64_t V, int64_t T, int32_t tile,
    int32_t n_tiles, int32_t max_verts) {
  using S = Slot<typename Src::Smem>;
  using SV = typename S::V;
  extern __shared__ uint4 smem[];

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / n_tiles;
  const int k = (int)(blockIdx.x - b * n_tiles);
  int16_t* lt = (int16_t*)smem;
  SV* slots = (SV*)(lt + 5 * tile);  // 5 * tile * 2 bytes: 16-byte aligned

  const int64_t s0 = (int64_t)k * tile;
  const int64_t s1 = s0 + tile < T ? s0 + tile : T;
  stage_local(local, lt, T, s0, (int)(s1 - s0), tile, tid);
  const int v0 = off[k];
  stage_slots<C>(src, slots, verts + v0, off[k + 1] - v0, b, V * C, tid);
  copy_async_wait();
  const Range r = mesh_range(vmin[b], vmax[b]);
  __syncthreads();
#pragma unroll 1
  for (int64_t t = s0 + tid; t < s1; t += ROWS_THREADS) {
    const int i = (int)(t - s0);  // the step within the tile
    // -1 marks an index the step's masks leave unread
    const int ln = lt[tile + i];
    const bool para = ln >= 0;
    const int lf = para ? -1 : lt[4 * tile + i];
    const SV o = slots[lt[i]];
    SV pa{}, pb{}, pd{};
    if (para) {
      pa = slots[ln];
      pb = slots[lt[2 * tile + i]];
      pd = slots[lt[3 * tile + i]];
    } else if (lf >= 0) {
      pa = slots[lf];
    }
    int32_t* dst = out + (b * T + t) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int32_t pred = para ? S::at(pa, c) + S::at(pb, c) - S::at(pd, c)
                                : (lf >= 0 ? S::at(pa, c) : 0);
      dst[c] = residual_symbol(S::at(o, c), pred, r);
    }
  }
}

template <typename Src>
__global__ void predict_gather_kernel(
    Src src, const int32_t* __restrict__ order,
    const int32_t* __restrict__ nxt, const int32_t* __restrict__ prv,
    const int32_t* __restrict__ opp, const int32_t* __restrict__ fb,
    const uint8_t* __restrict__ can_para, const uint8_t* __restrict__ has_fb,
    const int32_t* __restrict__ vmin, const int32_t* __restrict__ vmax,
    int32_t* __restrict__ out, int64_t B, int64_t V, int64_t T, int C) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B * T) return;
  const int64_t b = row / T;
  const int64_t t = row - b * T;
  const int64_t row_len = V * C;

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
      pred = src.at(b, row_len, in + c) + src.at(b, row_len, ip + c)
             - src.at(b, row_len, id + c);
    } else if (use_fb) {
      pred = src.at(b, row_len, iff + c);
    }
    o[c] = residual_symbol(src.at(b, row_len, io + c), pred, r);
  }
}

template <typename Src, int C>
int launch_rows(Src src, const void* const* gathers, const void* vmin,
                const void* vmax, void* out, int64_t B, int64_t V, int64_t T,
                void* stream) {
  using QT = typename Src::Smem;
  const int64_t smem = (int64_t)skewed_row<QT>((int)(V * C)) * sizeof(QT)
                       + (int64_t)ROWS_WARPS * 32 * C * 4;
  auto kernel = predict_rows_kernel<Src, C>;
  if (smem > 48 * 1024) {  // past the default limit of dynamic shared memory
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)B, ROWS_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      src, (const int32_t*)gathers[0], (const int32_t*)gathers[1],
      (const int32_t*)gathers[2], (const int32_t*)gathers[3],
      (const int32_t*)gathers[4], (const uint8_t*)gathers[5],
      (const uint8_t*)gathers[6], (const int32_t*)vmin, (const int32_t*)vmax,
      (int32_t*)out, V, T);
  return (int)cudaGetLastError();
}

// rows: 1 for predict_rows_kernel, where the caller found that the mesh's
// skewed q row fits shared memory and C is 1 to 4; 0 for
// predict_gather_kernel.
template <typename Src>
int launch(Src src, const void* order, const void* nxt, const void* prv,
           const void* opp, const void* fb, const void* can_para,
           const void* has_fb, const void* vmin, const void* vmax, void* out,
           int64_t B, int64_t V, int64_t T, int32_t C, int32_t rows,
           void* stream) {
  if (B * T == 0) return 0;
  if (rows) {
    const void* gathers[7] = {order, nxt, prv, opp, fb, can_para, has_fb};
    switch (C) {
      case 1:
        return launch_rows<Src, 1>(src, gathers, vmin, vmax, out, B, V, T,
                                   stream);
      case 2:
        return launch_rows<Src, 2>(src, gathers, vmin, vmax, out, B, V, T,
                                   stream);
      case 3:
        return launch_rows<Src, 3>(src, gathers, vmin, vmax, out, B, V, T,
                                   stream);
      case 4:
        return launch_rows<Src, 4>(src, gathers, vmin, vmax, out, B, V, T,
                                   stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const int threads = 256;
  const int64_t blocks = (B * T + threads - 1) / threads;
  predict_gather_kernel<Src><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      src, (const int32_t*)order, (const int32_t*)nxt, (const int32_t*)prv,
      (const int32_t*)opp, (const int32_t*)fb, (const uint8_t*)can_para,
      (const uint8_t*)has_fb, (const int32_t*)vmin, (const int32_t*)vmax,
      (int32_t*)out, B, V, T, C);
  return (int)cudaGetLastError();
}

template <typename Src, int C>
int launch_tiled_c(Src src, const void* verts, const void* off,
                   const void* local, const void* vmin, const void* vmax,
                   void* out, int64_t B, int64_t V, int64_t T, int32_t tile,
                   int32_t n_tiles, int32_t max_verts, void* stream) {
  using SV = typename Slot<typename Src::Smem>::V;
  const int64_t smem = (int64_t)tile * 5 * 2 + (int64_t)max_verts * sizeof(SV);
  auto kernel = predict_tiled_kernel<Src, C>;
  if (smem > 48 * 1024) {  // past the default limit of dynamic shared memory
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = B * n_tiles;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, ROWS_THREADS, (size_t)smem,
           (cudaStream_t)stream>>>(
      src, (const int32_t*)verts, (const int32_t*)off,
      (const int16_t*)local, (const int32_t*)vmin, (const int32_t*)vmax,
      (int32_t*)out, V, T, tile, n_tiles, max_verts);
  return (int)cudaGetLastError();
}

// The tiled kernel for C of 1 to 4; tile is a multiple of 32.
template <typename Src>
int launch_tiled(Src src, const void* verts, const void* off,
                 const void* local, const void* vmin, const void* vmax,
                 void* out, int64_t B, int64_t V, int64_t T, int32_t C,
                 int32_t tile, int32_t n_tiles, int32_t max_verts,
                 void* stream) {
  if (B * T == 0) return 0;
  if (tile <= 0 || tile % 32 != 0) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1:
      return launch_tiled_c<Src, 1>(src, verts, off, local, vmin, vmax, out,
                                    B, V, T, tile, n_tiles, max_verts,
                                    stream);
    case 2:
      return launch_tiled_c<Src, 2>(src, verts, off, local, vmin, vmax, out,
                                    B, V, T, tile, n_tiles, max_verts,
                                    stream);
    case 3:
      return launch_tiled_c<Src, 3>(src, verts, off, local, vmin, vmax, out,
                                    B, V, T, tile, n_tiles, max_verts,
                                    stream);
    case 4:
      return launch_tiled_c<Src, 4>(src, verts, off, local, vmin, vmax, out,
                                    B, V, T, tile, n_tiles, max_verts,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define TDR_PREDICT_PLAIN(NAME, QT)                                          \
  extern "C" int NAME(const void* q, const void* order, const void* nxt,     \
                      const void* prv, const void* opp, const void* fb,      \
                      const void* can_para, const void* has_fb,              \
                      const void* vmin, const void* vmax, void* out,         \
                      int64_t B, int64_t V, int64_t T, int32_t C,            \
                      int32_t rows, void* stream) {                          \
    return launch(Plain<QT>{(const QT*)q}, order, nxt, prv, opp, fb,         \
                  can_para, has_fb, vmin, vmax, out, B, V, T, C, rows,       \
                  stream);                                                   \
  }

TDR_PREDICT_PLAIN(tdr_predict_residual_u8, uint8_t)
TDR_PREDICT_PLAIN(tdr_predict_residual_u16, uint16_t)
TDR_PREDICT_PLAIN(tdr_predict_residual_i32, int32_t)

// the 12-bit pack: lo (B, V * C) and hb (B, ceil(V * C / 2)) bytes
extern "C" int tdr_predict_residual_p12(
    const void* lo, const void* hb, const void* order, const void* nxt,
    const void* prv, const void* opp, const void* fb, const void* can_para,
    const void* has_fb, const void* vmin, const void* vmax, void* out,
    int64_t B, int64_t V, int64_t T, int32_t C, int32_t rows,
    void* stream) {
  return launch(Pack12{(const uint8_t*)lo, (const uint8_t*)hb}, order, nxt,
                prv, opp, fb, can_para, has_fb, vmin, vmax, out, B, V, T, C,
                rows, stream);
}

// The tiled kernel on the tables of ops/device.py predict_tiles: verts
// (int32), off (n_tiles + 1 int32), local ((5, T) int16).
#define TDR_PREDICT_TILED_PLAIN(NAME, QT)                                    \
  extern "C" int NAME(const void* q, const void* verts, const void* off,     \
                      const void* local, const void* vmin, const void* vmax, \
                      void* out, int64_t B, int64_t V, int64_t T, int32_t C, \
                      int32_t tile, int32_t n_tiles, int32_t max_verts,      \
                      void* stream) {                                        \
    return launch_tiled(Plain<QT>{(const QT*)q}, verts, off, local, vmin,    \
                        vmax, out, B, V, T, C, tile, n_tiles, max_verts,     \
                        stream);                                             \
  }

TDR_PREDICT_TILED_PLAIN(tdr_predict_tiled_u8, uint8_t)
TDR_PREDICT_TILED_PLAIN(tdr_predict_tiled_u16, uint16_t)
TDR_PREDICT_TILED_PLAIN(tdr_predict_tiled_i32, int32_t)

extern "C" int tdr_predict_tiled_p12(
    const void* lo, const void* hb, const void* verts, const void* off,
    const void* local, const void* vmin, const void* vmax, void* out,
    int64_t B, int64_t V, int64_t T, int32_t C, int32_t tile,
    int32_t n_tiles, int32_t max_verts, void* stream) {
  return launch_tiled(Pack12{(const uint8_t*)lo, (const uint8_t*)hb}, verts,
                      off, local, vmin, vmax, out, B, V, T, C, tile,
                      n_tiles, max_verts, stream);
}

extern "C" const char* tdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

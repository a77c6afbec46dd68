// Fused batch position quantizer — bit-exact twin of
// torchdraco/parallel/batch.py::quantize_positions_host (which mirrors the
// canonical per-mesh formula in encode/portabilization.py, itself a
// transliteration of draco-oxide/src/encode/attribute/portabilization/
// quantization_coordinate_wise.rs).
//
// The numpy form makes ~10 full passes over the batch (min, max, sub,
// div, mul, add, two astypes, and the q min/max reductions) — about 12x
// the batch in memory traffic. This kernel does the
// same arithmetic in exactly two passes (min/max scan, then
// quantize+store) and emits the uint16 upload buffer directly.
//
// Bit-exactness contract: every float op below is the same IEEE f32 op,
// in the same order, as the numpy expression — (v - min) / delta * scale
// + 0.5, truncated toward zero. The build compiles with
// -ffp-contract=off so the mul+add cannot contract into an FMA, which
// would diverge from numpy. x86 SSE2 f32 arithmetic is correctly rounded, like numpy's.

#include <cstdint>
#include <limits>

namespace {

// Inner quantize pass over one mesh, specialized on whether the
// degenerate (delta == 0) branch divides. Matches the numpy path: the
// degenerate case keeps the un-divided diff, then multiplies by scale
// and adds 0.5 like every other row (batch.py:1201-1209).
template <bool kDivide>
inline void quantize_rows(const float* base, int64_t n, int64_t C,
                          const float* mins, float delta, float scale,
                          uint16_t* q, int32_t* vmin, int32_t* vmax) {
    int32_t mn = std::numeric_limits<int32_t>::max();
    int32_t mx = std::numeric_limits<int32_t>::min();
    if (C == 3) {  // positions: fixed-width inner loop vectorizes
        const float m0 = mins[0], m1 = mins[1], m2 = mins[2];
        for (int64_t v = 0; v < n; ++v) {
            const float* row = base + v * 3;
            float w0 = row[0] - m0, w1 = row[1] - m1, w2 = row[2] - m2;
            if (kDivide) { w0 /= delta; w1 /= delta; w2 /= delta; }
            w0 = w0 * scale + 0.5f;
            w1 = w1 * scale + 0.5f;
            w2 = w2 * scale + 0.5f;
            const int32_t t0 = (int32_t)w0, t1 = (int32_t)w1,
                          t2 = (int32_t)w2;
            q[v * 3 + 0] = (uint16_t)t0;
            q[v * 3 + 1] = (uint16_t)t1;
            q[v * 3 + 2] = (uint16_t)t2;
            int32_t lo = t0 < t1 ? t0 : t1; lo = lo < t2 ? lo : t2;
            int32_t hi = t0 > t1 ? t0 : t1; hi = hi > t2 ? hi : t2;
            if (lo < mn) mn = lo;
            if (hi > mx) mx = hi;
        }
    } else {
        for (int64_t v = 0; v < n; ++v) {
            for (int64_t c = 0; c < C; ++c) {
                float w = base[v * C + c] - mins[c];
                if (kDivide) w /= delta;
                w = w * scale + 0.5f;
                const int32_t t = (int32_t)w;
                q[v * C + c] = (uint16_t)t;
                if (t < mn) mn = t;
                if (t > mx) mx = t;
            }
        }
    }
    *vmin = mn;
    *vmax = mx;
}

}  // namespace

extern "C" {

// vals: (B, V, C) float32, C <= 16. Outputs: q (B, V, C) uint16,
// mins (B, C) float32, delta (B,) float32, vmin/vmax (B,) int32.
// Returns 0, or 1 if any mesh holds a non-finite value (caller re-runs
// the numpy twin for the canonical per-mesh error message).
int32_t tdn_quantize_batch(const float* vals, int64_t B, int64_t V,
                            int64_t C, int32_t bits, uint16_t* q_out,
                            float* mins_out, float* delta_out,
                            int32_t* vmin_out, int32_t* vmax_out) {
    if (C <= 0 || C > 16 || bits <= 0 || bits > 16) return 2;
    const float scale = (float)((1u << bits) - 1);
    bool all_finite = true;
    for (int64_t b = 0; b < B; ++b) {
        const float* base = vals + b * V * C;
        // numpy seeds the reduction with the data then clamps against
        // 0.0; seeding AT 0.0 gives the identical min(colmin, 0) /
        // max(colmax, 0) in one pass
        float mn[16], mx[16];
        for (int64_t c = 0; c < C; ++c) { mn[c] = 0.0f; mx[c] = 0.0f; }
        if (C == 3) {
            float mn0 = 0.f, mn1 = 0.f, mn2 = 0.f;
            float mx0 = 0.f, mx1 = 0.f, mx2 = 0.f;
            float fin = 0.0f;  // stays 0 iff every (x - x) == 0
            for (int64_t v = 0; v < V; ++v) {
                const float x0 = base[v * 3 + 0];
                const float x1 = base[v * 3 + 1];
                const float x2 = base[v * 3 + 2];
                fin += (x0 - x0) + (x1 - x1) + (x2 - x2);
                mn0 = x0 < mn0 ? x0 : mn0; mx0 = x0 > mx0 ? x0 : mx0;
                mn1 = x1 < mn1 ? x1 : mn1; mx1 = x1 > mx1 ? x1 : mx1;
                mn2 = x2 < mn2 ? x2 : mn2; mx2 = x2 > mx2 ? x2 : mx2;
            }
            if (!(fin == 0.0f)) { all_finite = false; }
            mn[0] = mn0; mn[1] = mn1; mn[2] = mn2;
            mx[0] = mx0; mx[1] = mx1; mx[2] = mx2;
        } else {
            float fin = 0.0f;
            for (int64_t v = 0; v < V; ++v) {
                for (int64_t c = 0; c < C; ++c) {
                    const float x = base[v * C + c];
                    fin += x - x;
                    if (x < mn[c]) mn[c] = x;
                    if (x > mx[c]) mx[c] = x;
                }
            }
            if (!(fin == 0.0f)) { all_finite = false; }
        }
        if (!all_finite) return 1;
        float delta = 0.0f;
        for (int64_t c = 0; c < C; ++c) {
            const float diff = mx[c] - mn[c];
            if (diff > delta) delta = diff;
        }
        for (int64_t c = 0; c < C; ++c) mins_out[b * C + c] = mn[c];
        delta_out[b] = delta;
        uint16_t* qb = q_out + b * V * C;
        if (delta != 0.0f) {
            quantize_rows<true>(base, V, C, mn, delta, scale, qb,
                                &vmin_out[b], &vmax_out[b]);
        } else {
            quantize_rows<false>(base, V, C, mn, delta, scale, qb,
                                 &vmin_out[b], &vmax_out[b]);
        }
    }
    return 0;
}

// 12-bit upload pack: split each uint16 value (< 4096) into a low byte
// and a 4-bit high nibble; nibbles pack in pairs (even index -> low
// nibble). The device reads the pack directly (K1,
// ops/csrc/predict_residual.cu) or unpacks it with two shifts and an OR
// (ops/device.py unpack12_kernel), so the H2D transfer carries 1.5
// bytes/value instead of 2. One linear pass;
// n may be odd (the final nibble pairs with zero).
void tdn_pack12(const uint16_t* q, int64_t n, uint8_t* lo, uint8_t* hb) {
    const int64_t pairs = n / 2;
    for (int64_t i = 0; i < pairs; ++i) {
        const uint16_t a = q[2 * i], b = q[2 * i + 1];
        lo[2 * i] = (uint8_t)a;
        lo[2 * i + 1] = (uint8_t)b;
        hb[i] = (uint8_t)((a >> 8) | ((b >> 8) << 4));
    }
    if (n & 1) {
        const uint16_t a = q[n - 1];
        lo[n - 1] = (uint8_t)a;
        hb[pairs] = (uint8_t)(a >> 8);
    }
}

}  // extern "C"

extern "C" {

// Fused host prediction step for the dominant attribute chain:
// parallelogram predict -> wrapped-difference residual -> zigzag, one
// pass over the traversal. Twin of encode/attribute.py::
// _vectorized_predict (cached-gather branch) + transforms.py::
// WrappedDifferenceTransform.squeeze — pure int64 arithmetic, identical
// by construction (equality pinned by tests; the numpy twin remains the
// VECTORIZED_PREDICTIONS off-switch path).
// vals: (V, C) int32 portabilized values; gathers: (T,) int32 value
// indices; flags: (T,) uint8. Outputs zigzagged symbols (T, C) uint64
// and the wrapped-difference vmin/vmax metadata.
int32_t tdn_predict_wrapped_zigzag(
    const int32_t* vals, int64_t V, int64_t C,
    const int32_t* origs_idx, const int32_t* nx, const int32_t* pv,
    const int32_t* op, const int32_t* fb, const uint8_t* can_para,
    const uint8_t* has_fb, int64_t T, uint64_t* sym_out,
    int32_t* vmin_out, int32_t* vmax_out) {
    if (T <= 0 || C <= 0 || C > 16) return 2;
    // pass 1: vmin/vmax over the traversal's original values
    int64_t vmin = vals[(int64_t)origs_idx[0] * C];
    int64_t vmax = vmin;
    for (int64_t t = 0; t < T; ++t) {
        const int32_t* o = vals + (int64_t)origs_idx[t] * C;
        for (int64_t c = 0; c < C; ++c) {
            const int64_t x = o[c];
            if (x < vmin) vmin = x;
            if (x > vmax) vmax = x;
        }
    }
    const int64_t max_diff = 1 + vmax - vmin;
    int64_t max_corr = max_diff / 2;
    const int64_t min_corr = -max_corr;
    if ((max_diff & 1) == 0) max_corr -= 1;
    // pass 2: predict + clamp + wrap + zigzag
    for (int64_t t = 0; t < T; ++t) {
        const int32_t* o = vals + (int64_t)origs_idx[t] * C;
        const int32_t* a = vals + (int64_t)nx[t] * C;
        const int32_t* b = vals + (int64_t)pv[t] * C;
        const int32_t* d = vals + (int64_t)op[t] * C;
        const int32_t* f = vals + (int64_t)fb[t] * C;
        const bool cp = can_para[t] != 0;
        const bool hf = has_fb[t] != 0;
        uint64_t* out = sym_out + t * C;
        for (int64_t c = 0; c < C; ++c) {
            int64_t pred = cp ? ((int64_t)a[c] + b[c] - d[c])
                              : (hf ? (int64_t)f[c] : 0);
            if (pred < vmin) pred = vmin;
            if (pred > vmax) pred = vmax;
            int64_t corr = (int64_t)o[c] - pred;
            if (corr > max_corr) corr -= max_diff;
            else if (corr < min_corr) corr += max_diff;
            out[c] = corr >= 0 ? (uint64_t)(corr << 1)
                               : (uint64_t)(((-(corr + 1)) << 1) + 1);
        }
    }
    *vmin_out = (int32_t)vmin;
    *vmax_out = (int32_t)vmax;
    return 0;
}

}  // extern "C"

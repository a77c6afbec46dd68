"""The fused encode step on tensors: parallelogram predict, wrapped
difference, zigzag and histogram, batched over meshes sharing a topology.

Counterpart of ``tpudraco/ops/device.py``. The plain functions
(``zigzag_kernel`` ... ``encode_step_from_q``) are integer PyTorch twins of
the JAX functions of the same names; they are the spec for the two CUDA
kernels below and the path a CPU tensor takes:

- ``predict_residual`` (K1, ``csrc/predict_residual.cu``) replaces the
  Pallas ``predict_matmul_pallas`` plus the residual tail of
  ``encode_step_pallas_from_q``;
- ``histogram`` (K2, ``csrc/histogram.cu``) replaces ``histogram_pallas``.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel or raises. Each counts its launches in ``n_launches``.
Symbols are int32 here (the JAX package returns the same values as uint32;
torch has no arithmetic on uint32).
"""

from __future__ import annotations

import torch

from . import _build

# the largest bin count whose int32 bins fit a Hopper block's 227 KB of
# dynamic shared memory (232,448 bytes); above it K2 adds into global memory
HIST_SMEM_MAX_BINS = 232448 // 4
# K1's shared-memory kernel keeps a mesh's q row and a staging tile of
# symbols in dynamic shared memory. Up to this many bytes a block, two
# blocks fit an SM's 227 KB; a mesh past it takes the direct-gather kernel
PREDICT_SMEM_MAX_BYTES = 112 * 1024


def zigzag_kernel(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int32)
    return torch.where(v >= 0, v << 1, ((-(v + 1)) << 1) + 1)


def parallelogram_predict_kernel(values, gather_next, gather_prev,
                                 gather_opp, gather_fallback,
                                 can_parallelogram, has_fallback):
    """pred = a + b - diagonal where the parallelogram is available, else
    the fallback value, else 0 (mesh_parallelogram_prediction.rs:186-237),
    as pure gathers over a host-precomputed traversal. values (B, V, C)."""
    v = values.to(torch.int32)
    a = v[:, gather_next.long()]
    b = v[:, gather_prev.long()]
    d = v[:, gather_opp.long()]
    fb = v[:, gather_fallback.long()]
    fallback = torch.where(has_fallback[:, None], fb, torch.zeros_like(fb))
    return torch.where(can_parallelogram[:, None], a + b - d, fallback)


def _wrapped_zigzag(origs, preds, vmin, vmax):
    """Clip to [vmin, vmax], wrap into the correction range
    (wrapped_difference.rs:36-99) and zigzag; vmin/vmax (B,)."""
    lo = vmin.to(torch.int32)[:, None, None]
    hi = vmax.to(torch.int32)[:, None, None]
    max_diff = 1 + hi - lo
    max_corr = max_diff // 2
    min_corr = -max_corr
    max_corr = torch.where((max_diff & 1) == 0, max_corr - 1, max_corr)
    p = torch.minimum(torch.maximum(preds.to(torch.int32), lo), hi)
    val = origs.to(torch.int32) - p
    corr = torch.where(val > max_corr, val - max_diff,
                       torch.where(val < min_corr, val + max_diff, val))
    return zigzag_kernel(corr)


def wrapped_difference_kernel(origs, preds, range_source=None):
    """Wrapped-difference residual, batched. Returns (zigzagged corrections
    int32, vmin, vmax); the range reduces over ``range_source`` when given
    (the pre-gather values: the traversal is a permutation of them)."""
    r = (origs if range_source is None else range_source).to(torch.int32)
    vmax = r.amax(dim=(-2, -1))
    vmin = r.amin(dim=(-2, -1))
    return _wrapped_zigzag(origs, preds, vmin, vmax), vmin, vmax


def bincount_kernel(symbols: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Per-row frequency counts of (B, N) symbols. Out-of-range symbols are
    DROPPED (not clamped), so a too-small bin count surfaces as
    counts.sum() != N downstream."""
    s = symbols.to(torch.int64)
    B = s.shape[0]
    keep = (s >= 0) & (s < num_bins)
    rows = torch.arange(B, device=s.device)[:, None].expand_as(s)
    flat = (rows * num_bins + s)[keep]
    counts = torch.bincount(flat, minlength=B * num_bins)
    return counts.view(B, num_bins).to(torch.int32)


def default_hist_bins(bits: int) -> int:
    """Quantized values span [0, 2^bits - 1], so max_diff <= 2^bits and the
    zigzagged correction is <= 2^bits: 2^(bits+1) bins cover every depth."""
    return 1 << (bits + 1)


def encode_step_from_q(q_in: torch.Tensor, gathers: dict, bits: int = 11,
                       hist_bins: int | None = None) -> dict:
    """The fused step from host-quantized values (B, V, C), in plain
    PyTorch: symbols (B, T, C) int32, counts (B, hist_bins) int32 and the
    residual range vmin/vmax (B,) reduced over q."""
    if hist_bins is None:
        hist_bins = default_hist_bins(bits)
    q = q_in.to(torch.int32)
    q_trav = q[:, gathers["order"].long()]
    preds = parallelogram_predict_kernel(
        q, gathers["next"], gathers["prev"], gathers["opp"],
        gathers["fallback"], gathers["can_para"], gathers["has_fallback"])
    corr, vmin, vmax = wrapped_difference_kernel(q_trav, preds,
                                                 range_source=q)
    counts = bincount_kernel(corr.reshape(corr.shape[0], -1), hist_bins)
    return {"symbols": corr, "counts": counts, "vmin": vmin, "vmax": vmax}


def predict_residual_ref(q, gathers, vmin, vmax) -> torch.Tensor:
    """Plain version of K1: (B, T, C) int32 symbols against the given
    per-mesh residual range."""
    q32 = q.to(torch.int32)
    preds = parallelogram_predict_kernel(
        q32, gathers["next"], gathers["prev"], gathers["opp"],
        gathers["fallback"], gathers["can_para"], gathers["has_fallback"])
    return _wrapped_zigzag(q32[:, gathers["order"].long()], preds, vmin,
                           vmax)


_GATHER_INDEX = ("order", "next", "prev", "opp", "fallback")
_GATHER_MASK = ("can_para", "has_fallback")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _cuda_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def predict_fits_smem(V: int, C: int, itemsize: int) -> bool:
    """Whether K1 takes its shared-memory kernel for q rows of V * C values
    of ``itemsize`` bytes: C is 1 to 4 (the kernel's unrolled component
    counts), and the row and the staging tile (8 warps x 32 steps x C
    int32) fit ``PREDICT_SMEM_MAX_BYTES``. A row lies skewed, one 32-bit
    word of padding after every 32, and is rounded up to 16 bytes, as
    ``csrc/predict_residual.cu`` ``skewed_row`` has it. Otherwise: the
    direct-gather kernel."""
    if not 1 <= C <= 4:
        return False
    n = V * C
    per16 = 16 // itemsize
    row = (n + n // (128 // itemsize) * (4 // itemsize) + per16) \
        // per16 * per16 * itemsize
    return row + 8 * 32 * C * 4 <= PREDICT_SMEM_MAX_BYTES


def _check_predict_inputs(q, gathers, vmin, vmax) -> None:
    """Raise on what K1 does not take. The messages are built only on a
    failure: the launch path runs in tens of microseconds."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _require(q.dim() == 3 and q.is_contiguous(), "q must be (B, V, C) "
             "contiguous")
    if q.dtype not in (torch.uint16, torch.int32):
        raise ValueError(f"q must be uint16 or int32, got {q.dtype}")
    B = q.shape[0]
    T = gathers["order"].numel()
    for keys, dtype in ((_GATHER_INDEX, torch.int32),
                        (_GATHER_MASK, torch.bool)):
        for k in keys:
            g = gathers[k]
            if not (g.device == dev and g.dtype == dtype
                    and g.is_contiguous() and g.numel() == T):
                raise ValueError(f"gather {k!r} must be ({T},) {dtype} on "
                                 f"{dev}")
    for name, r in (("vmin", vmin), ("vmax", vmax)):
        if not (r.device == dev and r.dtype == torch.int32
                and r.is_contiguous() and r.shape == (B,)):
            raise ValueError(f"{name} must be ({B},) int32 on {dev}")


def predict_residual(q: torch.Tensor, gathers: dict, vmin: torch.Tensor,
                     vmax: torch.Tensor) -> torch.Tensor:
    """K1: (B, T, C) int32 zigzagged residual symbols of host-quantized
    q (B, V, C) uint16 or int32, against the host's per-mesh range
    vmin/vmax (B,) int32. Gather indices must lie in [0, V). On CUDA the
    kernel is chosen from the shape alone (``predict_fits_smem``)."""
    if q.device.type == "cpu":
        return predict_residual_ref(q, gathers, vmin, vmax)
    _check_predict_inputs(q, gathers, vmin, vmax)
    B, V, C = q.shape
    T = gathers["order"].numel()
    out = torch.empty((B, T, C), dtype=torch.int32, device=q.device)
    if B * T * C == 0:
        return out
    lib = _build.load()
    fn = (lib.tdr_predict_residual_u16 if q.dtype == torch.uint16
          else lib.tdr_predict_residual_i32)
    rc = fn(q.data_ptr(), *(gathers[k].data_ptr() for k in _GATHER_INDEX),
            *(gathers[k].data_ptr() for k in _GATHER_MASK),
            vmin.data_ptr(), vmax.data_ptr(), out.data_ptr(), B, V, T, C,
            int(predict_fits_smem(V, C, q.element_size())), _cuda_stream(q))
    _build.check(rc, "predict_residual")
    predict_residual.n_launches += 1
    return out


predict_residual.n_launches = 0


def histogram(symbols: torch.Tensor, num_bins: int) -> torch.Tensor:
    """K2: (B, num_bins) int32 per-row counts of (B, N) int32 symbols;
    out-of-range symbols are dropped."""
    if symbols.device.type == "cpu":
        return bincount_kernel(symbols, num_bins)
    _require(symbols.device.type == "cuda",
             f"unsupported device {symbols.device}")
    _require(symbols.dim() == 2 and symbols.dtype == torch.int32
             and symbols.is_contiguous(),
             "symbols must be (B, N) contiguous int32")
    _require(0 < num_bins < (1 << 31), f"bad num_bins {num_bins}")
    B, N = symbols.shape
    use_smem = num_bins <= HIST_SMEM_MAX_BINS
    alloc = torch.empty if use_smem else torch.zeros
    out = alloc((B, num_bins), dtype=torch.int32, device=symbols.device)
    if B == 0:
        return out
    lib = _build.load()
    rc = lib.tdr_histogram(symbols.data_ptr(), B, N, num_bins,
                           out.data_ptr(), int(use_smem),
                           _cuda_stream(symbols))
    _build.check(rc, "histogram")
    histogram.n_launches += 1
    return out


histogram.n_launches = 0


def encode_step_from_q_cuda(q: torch.Tensor, gathers: dict,
                            vmin: torch.Tensor, vmax: torch.Tensor,
                            bits: int = 11, hist_bins: int | None = None):
    """The fused step through K1 and K2, the counterpart of
    ``encode_step_pallas_from_q``: returns (symbols (B, T, C) int32,
    counts (B, hist_bins) int32). vmin/vmax come from the host quantize.
    There is no depth cap: the kernels gather, they do not multiply int8
    planes."""
    if hist_bins is None:
        hist_bins = default_hist_bins(bits)
    symbols = predict_residual(q, gathers, vmin, vmax)
    counts = histogram(symbols.view(symbols.shape[0], -1), hist_bins)
    return symbols, counts

"""The fused encode step on tensors: parallelogram predict, wrapped
difference, zigzag and histogram, batched over meshes sharing a topology,
and the float side of the single-mesh routes (quantize, the chunk passes).

Counterpart of ``tpudraco/ops/device.py``. The plain functions
(``zigzag_kernel`` ... ``encode_step_from_q``, ``quantize_kernel`` ...
``unpack12_kernel``) are PyTorch twins of the JAX functions of the same
names; the integer ones are the spec for the two CUDA kernels below and
the path a CPU tensor takes:

- ``predict_residual`` (K1, ``csrc/predict_residual.cu``) replaces the
  Pallas ``predict_matmul_pallas`` plus the residual tail of
  ``encode_step_pallas_from_q``; past the shared-memory budget of a
  mesh's q row it reads the tile tables of ``predict_tiles``;
- ``histogram`` (K2, ``csrc/histogram.cu``) replaces ``histogram_pallas``.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches its kernel or raises. Each counts its launches in ``n_launches``.
Symbols are int32 here (the JAX package returns the same values as uint32;
torch has no arithmetic on uint32).

K1 takes q in the layout it was uploaded in (``parallel/batch.py``
``upload_layout``): a uint8, uint16 or int32 tensor, or the 12-bit pack as
a pair (lo, hb) (``torchdraco.native.pack12``); it reads the narrow
layouts directly, and its plain version widens them first (``widen``).

Every float step is a separate eager ``/``, ``*`` or ``+``, each correctly
rounded on both devices (never ``torch.compile``, ``addcmul`` or another
fused form: a multiply-add rounds once and moves values on .5 boundaries,
``tpudraco/ops/device.py:201-206``), and a divisor is always a tensor on
the dividend's device, broadcast to its shape (``_div``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch

from ..device import replicate, resolve_axis, shard_bounds
from . import _build

# the largest bin count whose int32 bins fit a Hopper block's 227 KB of
# dynamic shared memory (232,448 bytes); above it K2 takes its wide form:
# these bins in shared memory, the rest by atomics into global memory
SMEM_MAX_BYTES = 232448
HIST_SMEM_MAX_BINS = SMEM_MAX_BYTES // 4
# K2 spreads one row over several blocks when the rows alone cannot fill
# the card: it aims at HIST_BLOCKS_PER_SM blocks on each of the device's
# SMs, and gives a block at least HIST_MIN_SLICE symbols, and at least 4
# for every shared-memory bin it must zero and flush into the output
HIST_BLOCKS_PER_SM = 2
HIST_MIN_SLICE = 8192
# K1's shared-memory kernel keeps a mesh's q row and a staging tile of
# symbols in dynamic shared memory. Up to this many bytes a block, two
# blocks fit an SM's 227 KB; a mesh past it takes the tiled kernel
PREDICT_SMEM_MAX_BYTES = 112 * 1024
# Past it, K1 takes its tiled kernel for C of 1 to 4: the traversal cut
# into tiles of PREDICT_TILE steps, each staging its distinct vertices
# (``predict_tiles``). chip_smoke.py phase 17.2 times tiles of 1,024,
# 2,048 and 4,096 steps at the real-size batches in three layouts; 2,048
# had the least time over them (NVIDIA H100 80GB HBM3, 700 W)
PREDICT_TILE = 2048
# predict_tiles sorts the keys of this many steps at a time
PREDICT_TILE_CHUNK = 1 << 16


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


def upload_layout_of(q) -> str:
    """The layout of uploaded quantized values: ``"pack12"`` for a (lo, hb)
    pair, else ``"u8"``, ``"u16"`` or ``"i32"`` by the tensor's type."""
    if isinstance(q, (tuple, list)):
        return "pack12"
    layout = _LAYOUTS.get(q.dtype)
    if layout is None:
        raise ValueError(f"q must be uint8, uint16 or int32, or a (lo, hb) "
                         f"pair of uint8, got {q.dtype}")
    return layout


def widen(q) -> torch.Tensor:
    """int32 values of an upload in any layout, on its device: the 12-bit
    pack through ``unpack12_kernel``, a tensor by a cast."""
    if isinstance(q, (tuple, list)):
        return unpack12_kernel(*q)
    return q.to(torch.int32)


def predict_residual_ref(q, gathers, vmin, vmax) -> torch.Tensor:
    """Plain version of K1: (B, T, C) int32 symbols against the given
    per-mesh residual range; q in any upload layout (``widen``)."""
    q32 = widen(q)
    preds = parallelogram_predict_kernel(
        q32, gathers["next"], gathers["prev"], gathers["opp"],
        gathers["fallback"], gathers["can_para"], gathers["has_fallback"])
    return _wrapped_zigzag(q32[:, gathers["order"].long()], preds, vmin,
                           vmax)


class PredictTiles(NamedTuple):
    """K1's tile tables for one traversal (``predict_tiles``): ``verts``
    the sorted distinct vertex ids each tile of ``tile`` steps reads, tile
    k's at ``verts[off[k]:off[k + 1]]`` (int32); ``local`` (5, T) int16,
    each step's order / next / prev / opp / fallback index as a position
    in its tile's list, -1 where the step's masks leave it unread (next,
    prev and opp where the parallelogram is not available, the fallback
    where it is or there is none); ``max_verts`` the largest tile's
    count, which sizes the kernel's shared memory."""
    verts: torch.Tensor
    off: torch.Tensor
    local: torch.Tensor
    tile: int
    max_verts: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.verts, self.off, self.local))


def predict_tiles(gathers: dict, tile: int = PREDICT_TILE) -> PredictTiles:
    """The tile tables of K1's tiled kernel for the gathers of one
    traversal (any segment of one), built with torch operations on the
    gathers' device: a sort of the (tile, vertex) keys of every index a
    step reads, PREDICT_TILE_CHUNK steps at a time, so that the sort's
    buffers stay a few MB beside tables of about 18 bytes a step.
    ``tile`` is a multiple of 32 and at most 4096, so that a tile's at
    most 5 * tile vertices fit int16 positions."""
    _require(tile % 32 == 0 and 0 < tile <= 4096,
             f"tile must be a multiple of 32 in [32, 4096], got {tile}")
    dev, T = gathers["order"].device, gathers["order"].numel()
    n_tiles = -(-T // tile)
    local = torch.full((5, T), -1, dtype=torch.int16, device=dev)
    sizes = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    verts = []
    span = max(tile, PREDICT_TILE_CHUNK // tile * tile)
    for a in range(0, T, span):
        b = min(T, a + span)
        para = gathers["can_para"][a:b].to(torch.bool)
        use_fb = gathers["has_fallback"][a:b].to(torch.bool) & ~para
        idx = torch.stack([gathers[k][a:b].to(torch.int64)
                           for k in _GATHER_INDEX])
        read = torch.stack([torch.ones_like(para), para, para, para,
                            use_fb])
        step_tile = torch.arange(b - a, device=dev) // tile
        uniq, inv = torch.unique(((step_tile << 32) | idx)[read],
                                 sorted=True, return_inverse=True)
        n = sizes[a // tile:-(-b // tile)]
        n.copy_(torch.bincount(uniq >> 32, minlength=n.numel()))
        start = torch.cumsum(n, 0) - n  # each tile's first position
        local[:, a:b][read] = (
            inv - start[step_tile.expand(5, -1)[read]]).to(torch.int16)
        verts.append((uniq & 0xFFFFFFFF).to(torch.int32))
    off = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    torch.cumsum(sizes, 0, out=off[1:])
    return PredictTiles(
        verts=torch.cat(verts) if verts else torch.zeros(
            0, dtype=torch.int32, device=dev),
        off=off.to(torch.int32), local=local, tile=tile,
        max_verts=int(sizes.max()) if n_tiles else 0)


_LAYOUTS = {torch.uint8: "u8", torch.uint16: "u16", torch.int32: "i32"}
_K1_ENTRY = {"u8": "tdr_predict_residual_u8",
             "pack12": "tdr_predict_residual_p12",
             "u16": "tdr_predict_residual_u16",
             "i32": "tdr_predict_residual_i32"}
_K1_TILED_ENTRY = {layout: name.replace("residual", "tiled")
                   for layout, name in _K1_ENTRY.items()}
_GATHER_INDEX = ("order", "next", "prev", "opp", "fallback")
_GATHER_MASK = ("can_para", "has_fallback")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@contextlib.contextmanager
def _launch_on(t: torch.Tensor):
    """Make ``t``'s card the current device for one launch and yield the
    handle of its current stream. The C entry points set their kernels'
    attributes and launch on the current device, which must be the
    stream's: a tensor on ``cuda:1`` launched from ``cuda:0`` fails."""
    with torch.cuda.device(t.device):
        yield torch.cuda.current_stream(t.device).cuda_stream


def predict_fits_smem(V: int, C: int, itemsize: int) -> bool:
    """Whether K1 takes its shared-memory kernel for q rows of V * C values
    of ``itemsize`` bytes: C is 1 to 4 (the kernel's unrolled component
    counts), and the row and the staging tile (8 warps x 32 steps x C
    int32) fit ``PREDICT_SMEM_MAX_BYTES``. A row lies skewed, one 32-bit
    word of padding after every 32, and is rounded up to 16 bytes, as
    ``csrc/predict_residual.cu`` ``skewed_row`` has it. Otherwise
    ``predict_form`` picks the tiled or the direct-gather kernel."""
    if not 1 <= C <= 4:
        return False
    n = V * C
    per16 = 16 // itemsize
    row = (n + n // (128 // itemsize) * (4 // itemsize) + per16) \
        // per16 * per16 * itemsize
    return row + 8 * 32 * C * 4 <= PREDICT_SMEM_MAX_BYTES


def predict_form(V: int, C: int, itemsize: int) -> str:
    """K1's kernel for q rows of V * C values staged at ``itemsize`` bytes
    (2 for the 12-bit pack): ``"rows"`` where ``predict_fits_smem``, else
    ``"tiled"`` for C of 1 to 4, else ``"gather"``."""
    if predict_fits_smem(V, C, itemsize):
        return "rows"
    return "tiled" if 1 <= C <= 4 else "gather"


# bytes a value of each upload layout takes once K1 stages it in shared
# memory: the 12-bit pack is unpacked to uint16
STAGED_ITEMSIZE = {"u8": 1, "pack12": 2, "u16": 2, "i32": 4}


def _tiled_smem_bytes(tiles: PredictTiles, C: int, itemsize: int) -> int:
    """Dynamic shared memory of the tiled kernel, as
    ``csrc/predict_residual.cu`` ``launch_tiled_c`` sizes it: the tile's
    local indices and a slot of 4 staged values a vertex (C <= 4)."""
    return 5 * 2 * tiles.tile + tiles.max_verts * 4 * itemsize


def _check_predict_inputs(q, hb, gathers, vmin, vmax) -> None:
    """Raise on what K1 does not take; ``hb`` is the 12-bit pack's nibble
    rows beside its low bytes ``q``, else None. The messages are built
    only on a failure: the launch path runs in tens of microseconds."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _require(q.dim() == 3 and q.is_contiguous(), "q must be (B, V, C) "
             "contiguous")
    B = q.shape[0]
    if hb is not None:
        n = q.shape[1] * q.shape[2]
        if not (q.dtype == torch.uint8 and hb.dtype == torch.uint8
                and hb.device == dev and hb.is_contiguous()
                and hb.shape == (B, (n + 1) // 2)):
            raise ValueError(f"the 12-bit pack must be lo (B, V, C) and hb "
                             f"({B}, {(n + 1) // 2}) uint8 on {dev}")
    elif q.dtype not in _LAYOUTS:
        raise ValueError(f"q must be uint8, uint16 or int32, got {q.dtype}")
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


def _check_tiles(tiles: PredictTiles, T: int, dev, C: int,
                 itemsize: int) -> None:
    if not (tiles.local.shape == (5, T) and tiles.local.dtype == torch.int16
            and tiles.verts.dtype == torch.int32
            and tiles.off.dtype == torch.int32
            and tiles.off.numel() == -(-T // tiles.tile) + 1
            and all(t.device == dev and t.is_contiguous()
                    for t in (tiles.verts, tiles.off, tiles.local))):
        raise ValueError(f"tile tables must be predict_tiles' of these "
                         f"{T} steps on {dev}")
    if _tiled_smem_bytes(tiles, C, itemsize) > SMEM_MAX_BYTES:
        raise ValueError(f"a tile of {tiles.max_verts} vertices of {C} "
                         f"values passes the shared memory of a block; "
                         f"build the tables with a smaller tile")


def predict_residual(q, gathers: dict, vmin: torch.Tensor,
                     vmax: torch.Tensor, tiles=None) -> torch.Tensor:
    """K1: (B, T, C) int32 zigzagged residual symbols of host-quantized
    q (B, V, C), against the host's per-mesh range vmin/vmax (B,) int32.
    q is uploaded in any layout: a uint8, uint16 or int32 tensor, or the
    12-bit pack (lo (B, V, C) uint8, hb (B, ceil(V*C/2)) uint8), which
    the kernel unpacks as it reads. Gather indices must lie in [0, V). On
    CUDA the kernel is chosen from the shape alone (``predict_form``, with
    the 2-byte elements of the pack's staged row); the tiled kernel reads
    ``tiles``, the ``predict_tiles`` of these gathers or a function of no
    arguments that returns them, called only where that kernel runs, so
    that a caller holding a topology keeps them without deciding the form
    (built for the call where None). Counts its
    launches in ``n_launches`` and by layout and by kernel form in
    ``n_launches_by_layout`` and ``n_launches_by_form``."""
    layout = upload_layout_of(q)
    lo, hb = q if layout == "pack12" else (q, None)
    if lo.device.type == "cpu":
        return predict_residual_ref(q, gathers, vmin, vmax)
    _check_predict_inputs(lo, hb, gathers, vmin, vmax)
    B, V, C = lo.shape
    T = gathers["order"].numel()
    out = torch.empty((B, T, C), dtype=torch.int32, device=lo.device)
    if B * T * C == 0:
        return out
    lib = _build.load()
    parts = (lo,) if hb is None else (lo, hb)
    staged = STAGED_ITEMSIZE[layout]
    form = predict_form(V, C, staged)
    if form == "tiled":
        if tiles is None:
            tiles = predict_tiles(gathers)
        elif callable(tiles):
            tiles = tiles()
        _check_tiles(tiles, T, lo.device, C, staged)
    with _launch_on(lo) as stream:
        if form == "tiled":
            rc = getattr(lib, _K1_TILED_ENTRY[layout])(
                *(t.data_ptr() for t in parts), tiles.verts.data_ptr(),
                tiles.off.data_ptr(), tiles.local.data_ptr(),
                vmin.data_ptr(), vmax.data_ptr(), out.data_ptr(), B, V, T, C,
                tiles.tile, tiles.off.numel() - 1, tiles.max_verts, stream)
        else:
            rc = getattr(lib, _K1_ENTRY[layout])(
                *(t.data_ptr() for t in parts),
                *(gathers[k].data_ptr() for k in _GATHER_INDEX),
                *(gathers[k].data_ptr() for k in _GATHER_MASK),
                vmin.data_ptr(), vmax.data_ptr(), out.data_ptr(), B, V, T, C,
                int(form == "rows"), stream)
        _build.check(rc, "predict_residual")
    predict_residual.n_launches += 1
    predict_residual.n_launches_by_layout[layout] += 1
    predict_residual.n_launches_by_form[form] += 1
    return out


predict_residual.n_launches = 0
predict_residual.n_launches_by_layout = dict.fromkeys(
    ("u8", "pack12", "u16", "i32"), 0)
predict_residual.n_launches_by_form = dict.fromkeys(
    ("rows", "tiled", "gather"), 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def histogram_splits(B: int, N: int, num_bins: int, sms: int) -> int:
    """Blocks that K2 gives each of B > 0 rows of N symbols on a card of
    ``sms`` SMs: 1 where the rows fill it (B >= HIST_BLOCKS_PER_SM * sms,
    the batch path's 512 meshes on an H100's 132), else enough to reach
    about that many blocks, each with at least HIST_MIN_SLICE symbols and,
    where the bins are in shared memory, 4 symbols a bin."""
    fill = HIST_BLOCKS_PER_SM * sms
    if B >= fill:
        return 1
    per_block = HIST_MIN_SLICE
    if num_bins <= HIST_SMEM_MAX_BINS:
        per_block = max(per_block, 4 * num_bins)
    return max(1, min(-(-fill // B), N // per_block))


def histogram_smem_bins(N: int, num_bins: int, splits: int) -> int:
    """The bins a K2 block keeps in shared memory, the rest going to
    global atomics: all of them up to HIST_SMEM_MAX_BINS; a block of a
    split row (``splits`` > 1) keeps at most a quarter of its slice's
    symbols, since it zeroes and flushes every shared bin (never fewer
    than ``histogram_splits`` gives the shared-memory form, which keeps 4
    symbols a bin)."""
    bins = min(num_bins, HIST_SMEM_MAX_BINS)
    if splits == 1:
        return bins
    return max(1, min(bins, -(-N // splits) // 4))


def histogram_form(num_bins: int) -> str:
    """K2's form for ``num_bins`` bins: ``"smem"`` where every bin fits a
    block's shared memory (``HIST_SMEM_MAX_BINS``), else ``"wide"``: the
    first HIST_SMEM_MAX_BINS bins in shared memory, the rest by global
    atomics (``histogram_smem_bins``)."""
    return "smem" if num_bins <= HIST_SMEM_MAX_BINS else "wide"


def histogram(symbols: torch.Tensor, num_bins: int) -> torch.Tensor:
    """K2: (B, num_bins) int32 per-row counts of (B, N) int32 symbols;
    out-of-range symbols are dropped. On CUDA a row runs on
    ``histogram_splits`` blocks, chosen from the shape and the SM count,
    in the form ``histogram_form`` picks from the bin count. Counts its
    launches in ``n_launches`` and by form in ``n_launches_by_form``."""
    if symbols.device.type == "cpu":
        return bincount_kernel(symbols, num_bins)
    _require(symbols.device.type == "cuda",
             f"unsupported device {symbols.device}")
    _require(symbols.dim() == 2 and symbols.dtype == torch.int32
             and symbols.is_contiguous(),
             "symbols must be (B, N) contiguous int32")
    _require(0 < num_bins < (1 << 31), f"bad num_bins {num_bins}")
    B, N = symbols.shape
    if B == 0:
        return torch.empty((0, num_bins), dtype=torch.int32,
                           device=symbols.device)
    splits = histogram_splits(B, N, num_bins,
                              _sm_count(symbols.device.index))
    # one block a row stores its row whole; split rows add into a zeroed
    # one
    alloc = torch.empty if splits == 1 else torch.zeros
    out = alloc((B, num_bins), dtype=torch.int32, device=symbols.device)
    lib = _build.load()
    with _launch_on(symbols) as stream:
        rc = lib.tdr_histogram(symbols.data_ptr(), B, N, num_bins,
                               out.data_ptr(),
                               histogram_smem_bins(N, num_bins, splits),
                               splits, stream)
        _build.check(rc, "histogram")
    histogram.n_launches += 1
    histogram.n_launches_by_form[histogram_form(num_bins)] += 1
    return out


histogram.n_launches = 0
histogram.n_launches_by_form = dict.fromkeys(("smem", "wide"), 0)


def encode_step_from_q_cuda(q: torch.Tensor, gathers: dict,
                            vmin: torch.Tensor, vmax: torch.Tensor,
                            bits: int = 11, hist_bins: int | None = None,
                            tiles=None):
    """The fused step through K1 and K2, the counterpart of
    ``encode_step_pallas_from_q`` (and, with q the 12-bit pack (lo, hb),
    of ``_jit_step_pallas_p12``): returns (symbols (B, T, C) int32,
    counts (B, hist_bins) int32). q is in any upload layout
    (``predict_residual``, which takes ``tiles``); vmin/vmax come from the
    host quantize. There is no depth cap: the kernels gather, they do not
    multiply int8 planes."""
    if hist_bins is None:
        hist_bins = default_hist_bins(bits)
    symbols = predict_residual(q, gathers, vmin, vmax, tiles)
    counts = histogram(symbols.flatten(1), hist_bins)
    return symbols, counts


def encode_step_stream_sharded(q, gathers: dict, vmin, vmax,
                               bits: int = 11, hist_bins: int | None = None,
                               mesh_axis=None, tiles: list | None = None):
    """The fused step with the traversal split over the stream axis
    ``mesh_axis`` (``resolve_axis``), the counterpart of
    ``_jit_step_stream_sharded``: every device holds the whole of q (B, V,
    C) and the range vmin/vmax (B,) int32 (copied once to each distinct
    device; a list, one entry a shard, is taken as placed), shard i runs
    K1 on its segment of the traversal (``shard_bounds`` over the T
    gathers) against that global range, and K2 on the segment's symbols.
    The segments' histograms are summed on the axis's first device: the
    psum over "stream". A segment's K1 tile tables are its own (a
    segment's first step need not start a tile of the whole traversal):
    ``tiles``, one entry a shard, each as ``predict_residual`` takes it
    (None: built for the call where the tiled kernel runs). Returns (the segments' symbols (B, T_i, C) int32,
    one tensor a shard on its device; counts (B, hist_bins) int32), which
    joined equal ``encode_step_from_q_cuda`` on one device."""
    axis = resolve_axis(mesh_axis)
    if hist_bins is None:
        hist_bins = default_hist_bins(bits)
    gs = replicate(gathers, axis)
    T = gs[0]["order"].numel()
    symbols, counts = [], None
    for (a, b), qd, g, lo, hi, tl in zip(
            shard_bounds(T, len(axis)), replicate(q, axis), gs,
            replicate(vmin, axis), replicate(vmax, axis),
            tiles or [None] * len(axis)):
        sym = predict_residual(qd, {k: v[a:b] for k, v in g.items()}, lo,
                               hi, tl)
        cnt = histogram(sym.flatten(1), hist_bins).to(axis[0])
        counts = cnt if counts is None else counts + cnt
        symbols.append(sym)
    return symbols, counts


# ---------------------------------------------------------------------------
# The float side: quantization and the streaming passes of one large mesh
# ---------------------------------------------------------------------------
#
# The chunked single-mesh route (parallel/batch.py
# ``encode_mesh_device_chunked``) holds O(chunk) rows on the device:
#   pass 1: per-vertex-chunk min/max          -> global quantization range
#   pass 2: per-vertex-chunk quantized min/max -> global residual range
#   pass 3: per-traversal-chunk rows gathered on the host: quantize,
#           predict, wrapped difference, zigzag and K2 on the device.
# Min and max are exact and every per-element formula is the resident
# one, so the symbols equal the host's.


def _div(num: torch.Tensor, den) -> torch.Tensor:
    """float32 ``num / den`` with ``den`` a float32 tensor on ``num``'s
    device, broadcast to ``num``'s shape. CUDA divides by a Python or CPU
    scalar as a multiply by its reciprocal, which can differ from the
    quotient in the last bit and move a quantized value across .5."""
    if not isinstance(den, torch.Tensor):
        den = torch.tensor(den, dtype=torch.float32)
    den = den.to(device=num.device, dtype=torch.float32)
    return num / torch.broadcast_to(den, num.shape)


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar on ``device``, filled there: no copy from the host,
    which on the card would wait for the work queued before it."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _quantize_normalized(diff: torch.Tensor, delta_max: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """(diff / delta_max, or diff where delta_max is 0) * (2^bits - 1)
    + 0.5, truncated: three roundings, as the host's float32 numpy.
    ``delta_max`` broadcasts against ``diff``."""
    dev = diff.device
    dz = delta_max == 0
    safe = torch.where(dz, _f32(1.0, dev), delta_max)
    normalized = torch.where(dz, diff, _div(diff, safe))
    prod = normalized * _f32(float((1 << bits) - 1), dev)
    return (prod + _f32(0.5, dev)).to(torch.int32)


def quantize_kernel(values: torch.Tensor, bits: int):
    """Coordinate-wise quantization of (..., V, N) float32 values (min and
    max seeded with zero, one delta_max over the components). Returns
    (q int32, mins (..., N), delta_max (...,))."""
    v = values.to(torch.float32)
    zero = _f32(0.0, v.device)
    mins = torch.minimum(v.amin(dim=-2), zero)
    maxs = torch.maximum(v.amax(dim=-2), zero)
    delta_max = (maxs - mins).amax(dim=-1)
    diff = v - mins[..., None, :]
    q = _quantize_normalized(diff, delta_max[..., None, None], bits)
    return q, mins, delta_max


def dequantize_kernel(q: torch.Tensor, mins: torch.Tensor,
                      delta_max: torch.Tensor, bits: int) -> torch.Tensor:
    """q * (delta_max / (2^bits - 1)) + mins, the product rounded before
    the sum; q (..., V, N), mins (..., N), delta_max (...,)."""
    scale = _div(delta_max.to(torch.float32), float((1 << bits) - 1))
    prod = q.to(torch.float32) * scale[..., None, None]
    return prod + mins.to(torch.float32)[..., None, :]


def unzigzag_kernel(u: torch.Tensor) -> torch.Tensor:
    """Inverse of ``zigzag_kernel`` for symbols read as uint32 (any
    integer dtype; the low 32 bits count). Returns int32."""
    u = u.to(torch.int64) & 0xFFFFFFFF
    half = (u >> 1).to(torch.int32)
    return torch.where((u & 1) == 0, half, -half - 1)


def minmax_chunk_kernel(pos_chunk: torch.Tensor):
    """(C, N) float32 -> ((N,) min, (N,) max). Padding rows must replicate
    a real row so that they cannot move the result."""
    v = pos_chunk.to(torch.float32)
    return v.amin(dim=0), v.amax(dim=0)


def quantize_rows_kernel(rows: torch.Tensor, mins: torch.Tensor,
                         delta_max: torch.Tensor, bits: int) -> torch.Tensor:
    """``quantize_kernel``'s per-element formula against a given range:
    rows (C, N) float32, mins (N,), delta_max a 0-dim tensor. Returns
    int32, equal to the resident quantize of the same rows."""
    diff = rows.to(torch.float32) - mins.to(torch.float32)
    return _quantize_normalized(diff, delta_max.to(torch.float32), bits)


def quantized_range_chunk_kernel(pos_chunk, mins, delta_max, bits: int):
    """Pass 2: the min and max (0-dim int32) of the chunk's quantized
    values over all components."""
    q = quantize_rows_kernel(pos_chunk, mins, delta_max, bits)
    return q.amin(), q.amax()


def encode_step_chunk(cur, nxt, prv, opp, fb, can_para, has_fallback,
                      active, mins, delta_max, vmin: int, vmax: int,
                      bits: int, hist_bins: int):
    """One traversal segment of the fused step. The five (C, N) float32
    row sets arrive gathered on the host (the vertex of each step, of its
    next, previous and opposite corners and its fallback), with the
    (C,) masks; ``active`` marks the rows that are not padding. Returns
    ((C, N) int32 symbols, (hist_bins,) int32 counts of the active rows):
    the counts are K2 over the (1, C*N) row on a CUDA tensor, with padding
    mapped to ``hist_bins``, which K2 drops."""
    q = [quantize_rows_kernel(r, mins, delta_max, bits)
         for r in (cur, nxt, prv, opp, fb)]
    para = q[1] + q[2] - q[3]
    fallback = torch.where(has_fallback[:, None], q[4],
                           torch.zeros_like(q[4]))
    preds = torch.where(can_para[:, None], para, fallback)
    max_diff = 1 + vmax - vmin
    max_corr = max_diff // 2
    min_corr = -max_corr
    if max_diff % 2 == 0:
        max_corr -= 1
    val = q[0] - torch.clamp(preds, vmin, vmax)
    corr = torch.where(val > max_corr, val - max_diff,
                       torch.where(val < min_corr, val + max_diff, val))
    sym = zigzag_kernel(corr)
    act = active.repeat_interleave(sym.shape[1])
    flat = torch.where(act, sym.reshape(-1), hist_bins)
    counts = histogram(flat.view(1, -1), hist_bins)[0]
    return sym, counts


def encode_step(positions: torch.Tensor, gathers: dict, bits: int = 11,
                hist_bins: int | None = None) -> dict:
    """The fused step from float32 positions (B, V, C), in plain PyTorch:
    ``quantize_kernel`` then ``encode_step_from_q``, with the quantization
    range (mins, delta_max) beside the symbols and counts."""
    q, mins, delta_max = quantize_kernel(positions, bits)
    out = encode_step_from_q(q, gathers, bits=bits, hist_bins=hist_bins)
    return {**out, "mins": mins, "delta_max": delta_max}


def unpack12_kernel(lo: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """Inverse of ``torchdraco.native.pack12``: int32 values from the
    12-bit layout, the low bytes ``lo`` (B, ...) uint8 and the high
    nibbles ``hb`` (B, ceil(n/2)) uint8 paired within a row (even index in
    the low nibble)."""
    B = lo.shape[0]
    n = lo[0].numel() if B else 0
    hi = torch.stack([hb & 0xF, hb >> 4], dim=-1).reshape(B, 2 * hb.shape[-1])
    hi = hi[:, :n].reshape(lo.shape)
    return lo.to(torch.int32) | (hi.to(torch.int32) << 8)

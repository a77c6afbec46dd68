"""The TEX_COORD attribute's device encode chain, as plain functions on
tensors.

Counterpart of ``tpudraco/ops/texcoords.py``: the encoder-side batched UV
prediction (shared/prediction.py TexCoordPrediction.predict_sequence) in
int64, batched over meshes sharing one topology, plus the
WrappedDifference residual. Bit-identical to the host path (pinned by
tests); rows whose intermediates could exceed the int64 headroom mark the
mesh "risky" and the integration layer routes that mesh to the host
encoder (the host handles them with arbitrary-precision Python ints).

Reference semantics: mesh_prediction_for_texture_coordinates.rs (integer
sqrt, overflow guards, the intentionally omitted prev-vertex fallback,
orientation bits), wrapped_difference.rs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
# single source of truth for the topology-static UV gathers lives with
# the host twin
from ..shared.prediction import collect_uv_gathers  # noqa: F401

_UV_INDEX_KEYS = ("cpt", "npt", "ppt", "last_pt")
_UV_MASK_KEYS = ("vis_n", "vis_p", "pos_ok_n", "pos_ok_p", "pos_ok_c")
I64_MAX = (1 << 63) - 1


def uv_gathers_to_torch(g: dict, device) -> dict:
    """The ``collect_uv_gathers`` dict (numpy) as tensors on ``device``
    (None: the card): int64 point indices, bool masks."""
    dev = resolve(device)
    out = {k: torch.from_numpy(np.ascontiguousarray(g[k], dtype=np.int64))
           .to(dev) for k in _UV_INDEX_KEYS}
    out.update({k: torch.from_numpy(np.ascontiguousarray(g[k],
                                                         dtype=np.bool_))
                .to(dev) for k in _UV_MASK_KEYS})
    return out


def _as_tensor(x, dev: torch.device, dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev).to(dtype)


def uv_encode_chain(q_pos, q_uv, g, uo_pos, uo_uv, device=None):
    """Batched device UV encode on ``device`` (None: the card; ``"cpu"``
    runs the same tensor code there). Arrays are numpy or tensors; ``g``
    is the collect_uv_gathers dict, as numpy or from uv_gathers_to_torch.

    q_pos: (B, Vp, 3) int quantized positions (unique values)
    q_uv:  (B, Vu, 2) int quantized UVs (unique values)
    uo_*: point -> unique-value maps

    Returns numpy (symbols (B, T, 2) uint32, vmin (B,), vmax (B,),
    orient_vals (B, T) bool, orient_flags (B, T) bool, risky (B,) bool).
    """
    dev = resolve(device)
    if not isinstance(g["cpt"], torch.Tensor):
        g = uv_gathers_to_torch(g, dev)
    out = _uv_chain_impl(
        _as_tensor(q_pos, dev, torch.int64),
        _as_tensor(q_uv, dev, torch.int64),
        _as_tensor(uo_pos, dev, torch.int64),
        _as_tensor(uo_uv, dev, torch.int64),
        *(g[k].to(dev) for k in _UV_INDEX_KEYS + _UV_MASK_KEYS))
    sym, vmin, vmax, orient, geo_v, risky = (x.cpu().numpy() for x in out)
    return (sym.astype(np.uint32), vmin, vmax, orient, geo_v, risky)


def _int_sqrt_dev(value: torch.Tensor) -> torch.Tensor:
    """Port of TexCoordPrediction._int_sqrt_vec (draco's integer sqrt:
    power-of-two seed, one averaged Newton step, downward refinement) —
    identical by construction. value int64 >= 0, < 2^62. The rounds are
    32 + 64 elementwise passes over the whole tensor."""
    value = value.to(torch.int64)
    act = value
    sqrt = torch.ones_like(value)
    for _ in range(32):
        m = act >= 2
        sqrt = torch.where(m, sqrt * 2, sqrt)
        act = torch.where(m, act >> 2, act)  # act >= 0: the floor of act / 4
    nz = value > 0
    one = torch.ones_like(value)
    zero = torch.zeros_like(value)
    safe = torch.where(nz, sqrt, one)
    sqrt = torch.where(
        nz, (sqrt + torch.div(value, safe, rounding_mode="floor")) >> 1,
        zero)
    for _ in range(64):
        over = nz & (sqrt * sqrt > value)
        safe = torch.where(sqrt > 0, sqrt, one)
        sqrt = torch.where(
            over, (sqrt + torch.div(value, safe, rounding_mode="floor")) >> 1,
            sqrt)
    return sqrt


def _tdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Division that truncates toward zero: the floor division of the
    absolute values, signed."""
    return torch.sign(a) * torch.sign(b) * torch.div(
        a.abs(), b.abs(), rounding_mode="floor")


def _unsigned_ge_2_62(p: torch.Tensor) -> torch.Tensor:
    """``p`` read as an unsigned 64-bit number is >= 2^62. The host
    multiplies as uint64 and compares there; torch has no arithmetic on
    unsigned 64-bit, but a wrapping int64 product holds the same bits, and
    those are >= 2^62 as unsigned exactly when bit 63 (``p`` negative) or
    bit 62 is set."""
    return (p < 0) | (p >= (1 << 62))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _uv_chain_impl(q_pos, q_uv, uo_pos, uo_uv, cpt, npt, ppt, last_pt,
                   vis_n, vis_p, ok_n, ok_p, ok_c):
    """All integer tensors int64, masks bool; see uv_encode_chain."""
    zero = torch.zeros((), dtype=torch.int64, device=q_pos.device)
    one = torch.ones((), dtype=torch.int64, device=q_pos.device)
    i64max = torch.full((), I64_MAX, dtype=torch.int64, device=q_pos.device)

    def uv_at(pt):
        return q_uv[:, uo_uv[pt], :]                       # (B, T, 2)

    def pos_at(pt, ok):
        v = q_pos[:, uo_pos[torch.where(ok, pt, zero)], :]
        return torch.where(ok[None, :, None], v, zero)

    next_uv, prev_uv, curr_uv = uv_at(npt), uv_at(ppt), uv_at(cpt)
    cpos = pos_at(cpt, ok_c)
    npos = pos_at(npt, ok_n)
    ppos = pos_at(ppt, ok_p)

    geo_try = (vis_n & vis_p)[None, :]                     # (1, T)
    eq = (next_uv == prev_uv).all(-1)
    pn = ppos - npos
    pn_norm2 = (pn * pn).sum(-1)
    nz = pn_norm2 != 0
    cn = cpos - npos
    cn_dot_pn = (pn * cn).sum(-1)
    pn_uv = prev_uv - next_uv

    def floor_div(a, b):
        return torch.div(a, b, rounding_mode="floor")

    wide = pn.abs().amax(-1) >= (1 << 20)
    pn_norm2_s = torch.where(nz, pn_norm2, one)
    g1 = next_uv.abs().amax(-1) > floor_div(i64max, pn_norm2_s)
    pn_uv_am = pn_uv.abs().amax(-1)
    g2 = (pn_uv_am != 0) & (cn_dot_pn.abs() > floor_div(
        i64max, torch.where(pn_uv_am != 0, pn_uv_am, one)))
    pn_am = pn.abs().amax(-1)
    g3 = cn_dot_pn.abs() > floor_div(
        i64max, torch.where(pn_am != 0, pn_am, one))
    geo = geo_try & ~eq & nz & ~(g1 | g2 | g3)

    x_uv = next_uv * pn_norm2_s[..., None] + pn_uv * cn_dot_pn[..., None]
    x_pos = npos + _tdiv(pn * cn_dot_pn[..., None], pn_norm2_s[..., None])
    cx = cpos - x_pos
    cx_norm2 = (cx * cx).sum(-1)
    prod = cx_norm2 * pn_norm2  # wraps mod 2^64, as the host's uint64
    risky = geo & _unsigned_ge_2_62(prod)
    prod_c = torch.where(risky | ~geo, zero, prod)
    norm_sq = _int_sqrt_dev(prod_c)
    risky = risky | (geo & ((pn_uv_am.clamp(min=1) * norm_sq)
                            >= (1 << 62)))
    risky = risky | (geo & (x_uv.abs().amax(-1) >= (1 << 62)))
    risky = risky | (geo_try & ~eq & wide)
    geo_v = geo & ~risky

    cx_uv = torch.stack([pn_uv[..., 1], -pn_uv[..., 0]],
                        dim=-1) * norm_sq[..., None]
    pred0 = _tdiv(x_uv + cx_uv, pn_norm2_s[..., None])
    pred1 = _tdiv(x_uv - cx_uv, pn_norm2_s[..., None])
    d0 = curr_uv - pred0
    d1 = curr_uv - pred1
    orient = (d0 * d0).sum(-1) < (d1 * d1).sum(-1)

    pred_geo = _wrap32(torch.where(orient[..., None], pred0, pred1))

    lastvals = uv_at(last_pt).clone()
    lastvals[:, 0, :] = 0
    fb = torch.where(vis_n[None, :, None], next_uv, lastvals)
    preds = torch.where(geo_v[..., None], pred_geo, fb)

    # WrappedDifference residual against the global UV range
    o = curr_uv
    vmax = q_uv.amax(dim=(-2, -1))
    vmin = q_uv.amin(dim=(-2, -1))
    max_diff = 1 + vmax - vmin
    max_corr = floor_div(max_diff, 2)
    min_corr = -max_corr
    max_corr = torch.where((max_diff & 1) == 0, max_corr - 1, max_corr)
    p = torch.minimum(torch.maximum(preds, vmin[..., None, None]),
                      vmax[..., None, None])
    val = o - p
    md = max_diff[..., None, None]
    corr = torch.where(val > max_corr[..., None, None], val - md,
                       torch.where(val < min_corr[..., None, None],
                                   val + md, val))
    # zigzag, kept to its low 32 bits (the wire's uint32)
    sym = torch.where(corr >= 0, corr << 1,
                      ((-(corr + 1)) << 1) + 1) & 0xFFFFFFFF

    return (sym, vmin.to(torch.int32), vmax.to(torch.int32),
            orient, geo_v, risky.any(dim=-1))

"""The NORMAL attribute's device chains: the CUDA kernels C1 (encode) and
C2 (decode), and their plain versions on tensors.

Counterpart of ``tpudraco/ops/normals.py``. Mirrors the host pipeline bit
for bit for NORMAL attributes: octahedral quantization
(shared/octahedral.py), ring-sum normal prediction (shared/prediction.py
NormalPrediction), flip selection, and the OctahedralOrthogonal residual
transform (encode/transforms.py) and its inverse, batched over meshes
sharing one topology.

``normal_encode_chain`` and ``normal_decode_chain`` take the device their
tensors lie on: on the card the kernels of ``csrc/normal_chains.cu``
(``normal_encode_cuda``, ``normal_decode_cuda``: one launch a call, a
thread a (mesh, step), tpudraco's XLA programs of the two chains
replaced), on the CPU the plain versions (``normal_encode_chain_ref``,
``normal_decode_chain_ref``), which the tests and chip_smoke.py also call
by name on the card.

The plain versions' float steps use the device's own IEEE-754 float32
``/``, ``*`` and square root (``_f32_sqrt``), each as a separate eager op,
so no product is contracted into a neighbouring add and every result is
the correctly rounded one numpy gives on the host; the kernels take each
step as one correctly rounded intrinsic. The ring sum runs in int64 and
wraps to int32 where the host wraps; the symbols equal the host encoder's
exactly (pinned by tests).

Reference semantics: mesh_normal_prediction.rs (ring cross-product sums,
clamp at 2^29, flips), octahedral_quantization.rs + geom.rs (transform +
faithful fixups), oct_orthogonal.rs via the involutive InvertDiamond.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import replicate, resolve, resolve_axis, shard_rows
# single source of truth for the ring precompute lives with the host twin
from ..shared.prediction import collect_normal_rings  # noqa: F401
from . import _build
from .device import (_expect, _launch_on, _on_the_card, _require,
                     int32_values)

# Working-set budget of one plain ring prediction. _ring_predict holds
# about RING_BYTES_PER_SLOT bytes for each (mesh, step, ring slot): two
# (.., 3) int64 edge tensors, the int64 cross products and the temporaries
# of their six products. A batch past the budget runs as sub-batches of
# meshes. The kernels hold nothing of the kind: their memory is their
# inputs and outputs, the ring tables (RING_TABLE_BYTES_PER_SLOT a slot)
# among them.
RING_BUDGET_BYTES = 8 << 30
RING_BYTES_PER_SLOT = 8 * 3 * 8
# the bytes of one ring slot in ``rings_to_torch``'s tables: the int64
# next and previous rows and the bool mask
RING_TABLE_BYTES_PER_SLOT = 8 + 8 + 1


# ---------------------------------------------------------------- host prep

def rings_to_torch(rings: dict, device, rows=None) -> dict:
    """The ``collect_normal_rings`` dict (numpy) as tensors on ``device``
    (None: the card): int64 indices, the form torch's gathers take, and
    the bool mask. ``rows`` optionally maps every point index first (the
    decoder's corner -> vertex row, the encoder's point -> unique value)."""
    dev = resolve(device)
    out = {}
    for k in ("tip_pt", "next_pt", "prev_pt"):
        v = np.asarray(rings[k], dtype=np.int64)
        if rows is not None:
            v = np.asarray(rows, dtype=np.int64)[v]
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    out["mask"] = torch.from_numpy(
        np.ascontiguousarray(rings["mask"], dtype=np.bool_)).to(dev)
    return out


# -------------------------------------------------------------- device ops

def _f32_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE float32 quotient, with 0 / b taken as 0 (a's own zero) for
    every b, b == 0 too: the one case the chains reach with a zero divisor
    is a zero vector over its zero norm."""
    return torch.where(a == 0, a, a / b)


def _f32_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. On the card that is
    ``torch.sqrt`` itself (sqrt.rn.f32; chip_smoke.py holds it to numpy bit
    for bit). On the CPU torch takes large tensors through a vector math
    library whose root is within one unit in the last place but not
    correctly rounded (about 0.6 % of float32 values differ from numpy's),
    so there the root is taken in float64 and rounded once: 53 bits are
    more than 2 * 24 + 2, so the second rounding changes nothing, and an
    error in the float64 root's last place cannot reach a float32
    rounding boundary."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def oct_transform_device(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 2) float32 octahedral coords; integer inputs are
    normalized first (shared/octahedral.py float semantics,
    geom.rs:40-91)."""
    if not v.dtype.is_floating_point:
        f = v.to(torch.float32)
        x, y, z = f[..., 0], f[..., 1], f[..., 2]
        # every square is rounded before it is added, and the sum folds
        # from the left, as numpy's small-axis reduction does on the host
        xx = x * x
        yy = y * y
        zz = z * z
        nsq = (xx + yy) + zz
        norm = _f32_sqrt(nsq)
        v = _f32_div(f, norm[..., None].expand_as(f))
    v = v.to(torch.float32)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    abs_sum = (x.abs() + y.abs()) + z.abs()
    u = _f32_div(y, abs_sum)
    w = _f32_div(z, abs_sum)
    u_out = torch.where(u < 0, w.abs() - 1.0, 1.0 - w.abs())
    v_out = torch.where(w < 0, u.abs() - 1.0, 1.0 - u.abs())
    neg = x < 0
    return torch.stack([torch.where(neg, u_out, u),
                        torch.where(neg, v_out, w)], dim=-1)


def into_faithful_device(q: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Edge fixups on quantized (..., 2) int oct coords (geom.rs:139-157;
    the reference hardcodes 8-bit max=255 — the formulas generalize to
    max = 2^bits - 1 exactly as the host twin,
    shared/octahedral.py into_faithful_oct_quantization)."""
    q = q.to(torch.int32)
    u, v = q[..., 0], q[..., 1]
    mx = (1 << bits) - 1
    half = mx // 2
    x, y = u, v
    corner = (((u == 0) & (v == 0)) | ((u == mx) & (v == 0))
              | ((u == 0) & (v == mx)))
    cond1 = (~corner) & (u == 0) & (v > half)
    y = torch.where(cond1, half - (v - half), y)
    cond2 = (~corner) & (~cond1) & (u == mx) & (v < half)
    y = torch.where(cond2, half + (half - v), y)
    cond3 = (~corner) & (~cond1) & (~cond2) & (v == mx) & (u < half)
    x = torch.where(cond3, half + (half - u), x)
    cond4 = (~corner) & (~cond1) & (~cond2) & (~cond3) & (v == 0) & (u > half)
    x = torch.where(cond4, half - (u - half), x)
    full = torch.full_like(x, mx)
    x = torch.where(corner, full, x)
    y = torch.where(corner, full, y)
    return torch.stack([x, y], dim=-1)


def oct_quantize_device(vals: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """(..., 3) float normals -> (..., 2) int32 oct coords
    (octahedral_quantization.rs:49-65)."""
    oct = oct_transform_device(vals) + 1.0
    scale = float((1 << (bits - 1)) - 1)
    # the cast truncates toward zero, as the host does
    return (oct * scale).to(torch.int32)


def oct_quantize_faithful_device(vals: torch.Tensor,
                                 bits: int = 8) -> torch.Tensor:
    """oct_quantize_device + faithful fixups at a matching depth
    (shared/octahedral.py oct_quantize_normals)."""
    return into_faithful_device(oct_quantize_device(vals, bits), bits)


def invert_diamond_device(v: torch.Tensor, center: int = 127) -> torch.Tensor:
    """Involutive diamond inversion on centered int coords
    (shared/octahedral.py invert_diamond)."""
    v = v.to(torch.int32)
    s, t = v[..., 0], v[..., 1]
    both_nonneg = (s >= 0) & (t >= 0)
    both_nonpos = (s <= 0) & (t <= 0)
    one = torch.ones_like(s)
    sign_s = torch.where(both_nonneg, one,
                         torch.where(both_nonpos | (s <= 0), -one, one))
    sign_t = torch.where(both_nonneg, one,
                         torch.where(both_nonpos | (t <= 0), -one, one))
    cs = sign_s * center
    ct = sign_t * center
    s2 = 2 * s - cs
    t2 = 2 * t - ct
    rotate = (sign_s * sign_t) >= 0
    ns = torch.where(rotate, -t2, t2)
    nt = torch.where(rotate, -s2, s2)
    # (ns + cs) and (nt + ct) are even, so the arithmetic shift is the
    # exact halving for both signs
    return torch.stack([(ns + cs) >> 1, (nt + ct) >> 1], dim=-1)


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sign(a) * torch.div(a.abs(), b.abs().clamp(min=1),
                                     rounding_mode="floor")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped into the int32 range, still int64: the
    host's explicit wrap32."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _ring_predict(q_pos, tip_i, next_i, prev_i, mask, bits: int):
    """Ring-sum normal prediction from quantized positions: (B, T, 2)
    faithful oct-quantized predictions + the nonzero-ring mask. The exact
    compute both directions share — the encoder's prediction and the
    decoder's (which re-predicts from the already-decoded positions).

    q_pos (B, Vp, 3) of any integer type; tip_i (T,), next_i/prev_i (T, R)
    int64 rows of q_pos; mask (T, R) bool."""
    q = q_pos.to(torch.int64)
    pos_tip = q[:, tip_i, :]                            # (B, T, 3)
    pn = q[:, next_i, :] - pos_tip[:, :, None, :]       # (B, T, R, 3)
    pp = q[:, prev_i, :] - pos_tip[:, :, None, :]
    # the host's products and their difference are int32 and wrap mod
    # 2^32: here they are exact in int64 and wrapped once, which gives
    # the same residue without a signed overflow
    cr = _wrap32(torch.stack([
        pn[..., 1] * pp[..., 2] - pn[..., 2] * pp[..., 1],
        pn[..., 2] * pp[..., 0] - pn[..., 0] * pp[..., 2],
        pn[..., 0] * pp[..., 1] - pn[..., 1] * pp[..., 0],
    ], dim=-1))
    cr = torch.where(mask[None, :, :, None], cr, torch.zeros_like(cr))
    # the ring SUM accumulates in int64 on the host and the overflow clamp
    # reads the UNWRAPPED sum; only afterwards does the host wrap to int32
    # (deep position depths push ring sums past 2^31)
    total64 = cr.sum(dim=2)                             # (B, T, 3)

    upper = 1 << 29
    abs_sum = total64.abs().sum(dim=-1)                 # (B, T)
    big = abs_sum > upper
    qd = torch.where(big, torch.div(abs_sum, upper, rounding_mode="floor"),
                     torch.ones_like(abs_sum))
    total64 = torch.where(big[..., None],
                          _trunc_div(total64, qd[..., None]), total64)
    # host wrap32 after the clamp (mesh_normal_prediction.rs wrap)
    total = _wrap32(total64).to(torch.int32)

    nonzero = (total != 0).any(dim=-1)
    unit = torch.tensor([1, 0, 0], dtype=torch.int32, device=total.device)
    safe_total = torch.where(nonzero[..., None], total, unit)
    oct = oct_transform_device(safe_total) + 1.0
    quant = (oct * float((1 << (bits - 1)) - 1)).to(torch.int32)
    pred = into_faithful_device(quant, bits)
    pred = torch.where(nonzero[..., None], pred, torch.zeros_like(pred))
    return pred, nonzero


def _sub_batches(n_meshes: int, steps: int, ring: int) -> int:
    """Meshes per ring prediction under RING_BUDGET_BYTES."""
    per_mesh = max(steps, 1) * max(ring, 1) * RING_BYTES_PER_SLOT
    return max(1, min(n_meshes, RING_BUDGET_BYTES // per_mesh))


def normal_encode_chain(q_pos, normals, tip_pt, next_pt, prev_pt, mask,
                        uo_point_pos, uo_point_nrm, bits: int = 8):
    """Batched device encode of a NORMAL attribute, on the device its
    tensors lie on: C1 (``normal_encode_cuda``) on the card, the plain
    version (``normal_encode_chain_ref``) on the CPU.

    q_pos:    (B, Vp, 3) integer quantized positions (unique values; on
              the card of a type that int32 holds: uint8, uint16, int32)
    normals:  (B, Vn, 3) float32 normal values (unique values)
    tip_pt/next_pt/prev_pt/mask: ring precompute (collect_normal_rings,
    rings_to_torch)
    uo_point_pos / uo_point_nrm: (P,) int64 point -> unique-value maps
    bits: octahedral depth (-qn, 7..16); every stage — quantization,
          prediction, faithful fixups, squeeze — runs at this depth,
          matching the host chain with Config.quant_bits[NORMAL]=bits.

    Returns (symbols (B, T, 2) int32, flips (B, T) bool)."""
    if q_pos.device.type == "cuda":
        return normal_encode_cuda(int32_values(q_pos), normals, tip_pt,
                                  next_pt, prev_pt, mask, uo_point_pos,
                                  uo_point_nrm, bits=bits)
    return normal_encode_chain_ref(q_pos, normals, tip_pt, next_pt, prev_pt,
                                   mask, uo_point_pos, uo_point_nrm,
                                   bits=bits)


def normal_encode_chain_ref(q_pos, normals, tip_pt, next_pt, prev_pt, mask,
                            uo_point_pos, uo_point_nrm, bits: int = 8):
    """The plain version of C1, on the device the tensors lie on: eager
    torch operations (``_normal_encode_chain_impl``); a batch whose ring
    tensors would pass RING_BUDGET_BYTES runs as sub-batches."""
    B = q_pos.shape[0]
    step = _sub_batches(B, next_pt.shape[0], next_pt.shape[1])
    if step >= B:
        return _normal_encode_chain_impl(
            q_pos, normals, tip_pt, next_pt, prev_pt, mask, uo_point_pos,
            uo_point_nrm, bits=bits)
    parts = [_normal_encode_chain_impl(
        q_pos[b0:b0 + step], normals[b0:b0 + step], tip_pt, next_pt,
        prev_pt, mask, uo_point_pos, uo_point_nrm, bits=bits)
        for b0 in range(0, B, step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _check_rings(dev, tip, nxt, prv, mask) -> tuple[int, int]:
    """Raise unless the ring tables are ``rings_to_torch``'s on ``dev``;
    returns (T, R)."""
    _expect(nxt, "next", dev, torch.int64, (None, None))
    T, R = nxt.shape
    _expect(tip, "tip", dev, torch.int64, (T,))
    _expect(prv, "prev", dev, torch.int64, (T, R))
    _expect(mask, "mask", dev, torch.bool, (T, R))
    return T, R


def encode_outputs(B: int, T: int, device) -> tuple:
    """C1's outputs as ``normal_encode_cuda`` allocates them: symbols (B,
    T, 2) int32 and flips (B, T) bool."""
    return (torch.empty((B, T, 2), dtype=torch.int32, device=device),
            torch.empty((B, T), dtype=torch.bool, device=device))


def normal_encode_cuda(q_pos, normals, tip_pt, next_pt, prev_pt, mask,
                       uo_point_pos, uo_point_nrm, bits: int = 8):
    """C1 (``csrc/normal_chains.cu``): ``normal_encode_chain`` in one
    launch, a thread a (mesh, step). q_pos (B, Vp, 3) int32, normals (B,
    Vn, 3) float32, the ring tables of ``rings_to_torch`` and the int64
    maps, all on one card; indices must lie in range. Raises on anything
    else, a CPU tensor included. Counts its launches in ``n_launches``."""
    dev = q_pos.device
    _require(1 <= bits <= 16, f"bits must be in [1, 16], got {bits}")
    _expect(q_pos, "q_pos", dev, torch.int32, (None, None, 3))
    B, Vp, _ = q_pos.shape
    _expect(normals, "normals", dev, torch.float32, (B, None, 3))
    T, R = _check_rings(dev, tip_pt, next_pt, prev_pt, mask)
    _expect(uo_point_pos, "uo_point_pos", dev, torch.int64, (None,))
    _expect(uo_point_nrm, "uo_point_nrm", dev, torch.int64, (None,))
    _on_the_card(dev, "C1")
    sym, flips = encode_outputs(B, T, dev)
    if B * T == 0:
        return sym, flips
    lib = _build.load()
    with _launch_on(q_pos) as stream:
        rc = lib.tdr_normal_encode(
            q_pos.data_ptr(), normals.data_ptr(), tip_pt.data_ptr(),
            next_pt.data_ptr(), prev_pt.data_ptr(), mask.data_ptr(),
            uo_point_pos.data_ptr(), uo_point_nrm.data_ptr(), B, Vp,
            normals.shape[1], T, R, bits, sym.data_ptr(), flips.data_ptr(),
            stream)
        _build.check(rc, "normal_encode_cuda")
    normal_encode_cuda.n_launches += 1
    return sym, flips


normal_encode_cuda.n_launches = 0


def normal_encode_chain_sharded(q_pos, normals, tip_pt, next_pt, prev_pt,
                                mask, uo_point_pos, uo_point_nrm,
                                bits: int = 8, mesh_axis=None):
    """``normal_encode_chain`` with the batch axis split over the shard
    axis ``mesh_axis`` (``resolve_axis``), the counterpart of
    ``_jit_normal_chain_sharded``: q_pos and normals are cut along the
    batch axis (``shard_rows``), every ring and index table is copied to
    each distinct device (``replicate``), and each shard runs the chain on
    its device (C1 on a card). Any argument may
    come as a list, one entry a shard, each on its device. Returns
    (symbols, flips) as the chain does, in shard order on the axis's
    first device."""
    axis = resolve_axis(mesh_axis)
    tables = [replicate(t, axis) for t in (tip_pt, next_pt, prev_pt, mask,
                                           uo_point_pos, uo_point_nrm)]
    parts = [normal_encode_chain(q, n, *(t[i] for t in tables), bits=bits)
             for i, (q, n) in enumerate(zip(shard_rows(q_pos, axis),
                                            shard_rows(normals, axis)))]
    return tuple(torch.cat([x.to(axis[0]) for x in part])
                 for part in zip(*parts))


def _flip_select(pred: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """True where -pred lies nearer to orig than pred does: exact int64
    squared distances, as the host compares them."""
    d1 = (pred - orig).to(torch.int64)
    d2 = (-pred - orig).to(torch.int64)
    return (d1 * d1).sum(-1) > (d2 * d2).sum(-1)


def _normal_encode_chain_impl(q_pos, normals, tip_pt, next_pt, prev_pt, mask,
                              uo_point_pos, uo_point_nrm, bits: int = 8):
    # per-point gathers resolved to unique-value rows
    tip_i = uo_point_pos[tip_pt]           # (T,)
    next_i = uo_point_pos[next_pt]         # (T, R)
    prev_i = uo_point_pos[prev_pt]
    pred, _ = _ring_predict(q_pos, tip_i, next_i, prev_i, mask, bits)

    # orig values: oct-quantize the normals, faithful fixups, traversal
    # gather (portabilization + per_point[pts] in the host path)
    q_n = into_faithful_device(oct_quantize_device(normals, bits), bits)
    orig = q_n[:, uo_point_nrm[tip_pt], :]              # (B, T, 2)

    # flip selection (mesh_normal_prediction.rs:133-143); d2 = -pred - orig
    # reaches 2*(2^bits - 1), so its square passes int32 at bits >= 15
    flips = _flip_select(pred, orig)
    pred = torch.where(flips[..., None], -pred, pred)

    # OctahedralOrthogonal squeeze (encode/transforms.py)
    mx = (1 << bits) - 1
    one = mx // 2
    o = orig - one
    p = pred - one
    flip = p.abs().sum(-1) > one
    p = torch.where(flip[..., None], invert_diamond_device(p, one), p)
    o = torch.where(flip[..., None], invert_diamond_device(o, one), o)
    nonzero_p = (p != 0).any(-1)
    for _ in range(4):
        todo = nonzero_p & ((p[..., 0] >= 0) | (p[..., 1] > 0))
        rp = torch.stack([-p[..., 1], p[..., 0]], dim=-1)
        ro = torch.stack([-o[..., 1], o[..., 0]], dim=-1)
        p = torch.where(todo[..., None], rp, p)
        o = torch.where(todo[..., None], ro, o)
    corr = o - p
    corr = torch.where(corr < 0, corr + mx, corr)
    return corr.to(torch.int32), flips


def _first_true(ok: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 0; 0 where there is none."""
    return ok.to(torch.uint8).argmax(dim=0)


def _take_dim0(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack (K, ..., 2) and idx (...) -> the (..., 2) rows stack[idx]."""
    return torch.gather(stack, 0, idx[None, ..., None].expand(
        1, *stack.shape[1:]))[0]


def invert_diamond_inverse_device(w: torch.Tensor,
                                  center: int = 127) -> torch.Tensor:
    """Exact diamond-inversion preimage, batched on device: evaluate the
    five candidate preimages, forward-map them, take the first that maps
    back to ``w``, the first candidate where none does
    (shared/octahedral.py invert_diamond_inverse_batched — same preference
    order, so values are bit-identical)."""
    w = w.to(torch.int32)
    w0, w1 = w[..., 0], w[..., 1]
    cands = torch.stack([
        invert_diamond_device(w, center),
        torch.stack([center - w1, center - w0], dim=-1),
        torch.stack([-w1 - center, -w0 - center], dim=-1),
        torch.stack([w1 + center, w0 - center], dim=-1),
        torch.stack([w1 - center, w0 + center], dim=-1),
    ])                                                   # (5, ..., 2)
    ok = (invert_diamond_device(cands, center) == w[None]).all(-1)
    return _take_dim0(cands, _first_true(ok))


def normal_decode_chain(q_pos, symbols, flips, tip_i, next_i, prev_i,
                        mask, bits: int = 8):
    """Batched device DECODE of a NORMAL attribute (the phased decoder's
    second phase), on the device its tensors lie on: C2
    (``normal_decode_cuda``) on the card, the plain version
    (``normal_decode_chain_ref``) on the CPU. Re-predicts from the
    already-decoded positions with the exact encoder ring compute
    (_ring_predict), applies the wire flips, then inverts the
    OctOrthogonal residual — the device mirror of decode/attribute.py
    _decode_normals_vectorized, integer-exact.

    q_pos:   (B, Vp, 3) integer decoded quantized positions (by vertex)
    symbols: (B, T, 2) integer residual symbols (decode order; int32 on
             the card)
    flips:   (B, T) bool wire flip bits
    tip_i/next_i/prev_i/mask: ring rows into q_pos (corner -> vertex
    resolved on host, rings_to_torch)

    Returns (B, T, 2) int32 decoded oct values along the traversal."""
    if q_pos.device.type == "cuda":
        return normal_decode_cuda(int32_values(q_pos), symbols, flips, tip_i,
                                  next_i, prev_i, mask, bits=bits)
    return normal_decode_chain_ref(q_pos, symbols, flips, tip_i, next_i,
                                   prev_i, mask, bits=bits)


def normal_decode_chain_ref(q_pos, symbols, flips, tip_i, next_i, prev_i,
                            mask, bits: int = 8):
    """The plain version of C2, on the device the tensors lie on: eager
    torch operations (``_normal_decode_chain_impl``); a batch whose ring
    tensors would pass RING_BUDGET_BYTES runs as sub-batches."""
    B = q_pos.shape[0]
    step = _sub_batches(B, next_i.shape[0], next_i.shape[1])
    if step >= B:
        return _normal_decode_chain_impl(q_pos, symbols, flips, tip_i,
                                         next_i, prev_i, mask, bits=bits)
    return torch.cat([_normal_decode_chain_impl(
        q_pos[b0:b0 + step], symbols[b0:b0 + step], flips[b0:b0 + step],
        tip_i, next_i, prev_i, mask, bits=bits)
        for b0 in range(0, B, step)])


def decode_outputs(B: int, T: int, device) -> torch.Tensor:
    """C2's output as ``normal_decode_cuda`` allocates it: (B, T, 2)
    int32."""
    return torch.empty((B, T, 2), dtype=torch.int32, device=device)


def normal_decode_cuda(q_pos, symbols, flips, tip_i, next_i, prev_i, mask,
                       bits: int = 8):
    """C2 (``csrc/normal_chains.cu``): ``normal_decode_chain`` in one
    launch, a thread a (mesh, step). q_pos (B, Vp, 3) int32, symbols (B,
    T, 2) int32, flips (B, T) bool and the ring rows of ``rings_to_torch``
    (vertex rows), all on one card; rows must lie in [0, Vp). Raises on
    anything else, a CPU tensor included. Counts its launches in
    ``n_launches``."""
    dev = q_pos.device
    _require(1 <= bits <= 16, f"bits must be in [1, 16], got {bits}")
    _expect(q_pos, "q_pos", dev, torch.int32, (None, None, 3))
    B, Vp, _ = q_pos.shape
    T, R = _check_rings(dev, tip_i, next_i, prev_i, mask)
    _expect(symbols, "symbols", dev, torch.int32, (B, T, 2))
    _expect(flips, "flips", dev, torch.bool, (B, T))
    _on_the_card(dev, "C2")
    out = decode_outputs(B, T, dev)
    if B * T == 0:
        return out
    lib = _build.load()
    with _launch_on(q_pos) as stream:
        rc = lib.tdr_normal_decode(
            q_pos.data_ptr(), symbols.data_ptr(), flips.data_ptr(),
            tip_i.data_ptr(), next_i.data_ptr(), prev_i.data_ptr(),
            mask.data_ptr(), B, Vp, T, R, bits, out.data_ptr(), stream)
        _build.check(rc, "normal_decode_cuda")
    normal_decode_cuda.n_launches += 1
    return out


normal_decode_cuda.n_launches = 0


def _normal_decode_chain_impl(q_pos, symbols, flips, tip_i, next_i, prev_i,
                              mask, bits: int = 8):
    pred, _ = _ring_predict(q_pos, tip_i, next_i, prev_i, mask, bits)
    pred = torch.where(flips[..., None], -pred, pred)

    mx = (1 << bits) - 1
    one = mx // 2
    corr = symbols.to(torch.int32)
    p = pred - one
    flip = p.abs().sum(-1) > one
    p = torch.where(flip[..., None], invert_diamond_device(p, one), p)

    rots = [p]
    for _ in range(3):
        q = rots[-1]
        rots.append(torch.stack([-q[..., 1], q[..., 0]], dim=-1))
    rots_s = torch.stack(rots)                           # (4, B, T, 2)
    in_q3 = (rots_s[..., 0] < 0) & (rots_s[..., 1] <= 0)
    r = torch.where((p != 0).any(-1), _first_true(in_q3),
                    torch.zeros_like(p[..., 0], dtype=torch.int64))
    p_rot = _take_dim0(rots_s, r)

    # the remainder takes the divisor's sign, as the host's % does
    o = torch.remainder(p_rot + corr + one, mx) - one
    outs = [o]
    for _ in range(3):
        q = outs[-1]
        outs.append(torch.stack([q[..., 1], -q[..., 0]], dim=-1))
    o = _take_dim0(torch.stack(outs), r)
    o = torch.where(flip[..., None], invert_diamond_inverse_device(o, one), o)
    return (o + one).to(torch.int32)

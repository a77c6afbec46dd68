"""Mesh encoding on one device: batches that share a topology, one large
mesh on its own, and the corpus driver over files on disk.

Counterpart of ``tpudraco/parallel/batch.py``. The batch path
(``encode_meshes_device``): meshes are grouped by topology; per group the
host runs the connectivity pass once and quantizes every mesh (the
canonical formula, C++), the quantized values go to the device in the
narrowest layout the depth allows (``upload_layout``: uint8 at up to 8
bits, the 12-bit pack at up to 12, uint16 at up to 16, int32 beyond), the
fused step (K1, which reads every layout, K2) and the multi-lane rANS
coder (K3) run there for
the position attribute (or, with ``entropy="host"``, the symbols come back
and the host's C++ coder codes each mesh), the NORMAL and TEX_COORD
attributes run their chains (ops/normals.py, ops/texcoords.py) on the same
uploaded positions, and the host assembles each ``.drc`` from the cached
connectivity bytes and the device's payloads.

The single-mesh routes: ``encode_mesh`` / ``encode_meshes`` (the host
plane, with the topology cache), ``encode_mesh_device`` (resident: the
batch path's step at B = 1, one symbol readback, the host's C++ rANS
coder), ``encode_mesh_device_chunked`` (streaming: O(chunk) rows on the
device, three passes) and ``_encode_huge``, which picks between the two by
size. Output bytes are identical to the per-mesh host ``encode()`` of
``torchdraco.encode`` on every route.

The corpus: ``encode_corpus`` loads files in bounded windows, encodes each
window on the device plane (``use_device=True``), on the router
(``use_device="auto"``: ``encode_meshes_auto`` measures the host plane and
the device plane per topology group and keeps the decision in memory and
on disk) or on the host plane (``use_device=False``), with resume and
per-file error isolation.

The host helpers (``PreparedTopology`` ... ``quantize_positions_host``) are
carried over from ``tpudraco/parallel/batch.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native, trace
from ..device import (
    axis_for, replicate, resolve, resolve_axis, shard_bounds, shard_rows,
)
from ..encode import (
    Config, _traversal_wire_id, encode_header, encode_metadata,
)
from ..encode.attribute import carries_port, encode_attributes
from ..encode.connectivity import EdgebreakerEncoder
from ..entropy.symbol_coding import DIRECT_CODED, encode_symbols
from ..models import AttributeType, TableView
from ..native import topo as native_topo
from ..ops.gathers import build_parallelogram_gathers
from ..ops.device import (
    PredictTiles, default_hist_bins, encode_step_chunk,
    encode_step_from_q_cuda, encode_step_stream_sharded,
    minmax_chunk_kernel, predict_tiles,
    quantized_range_chunk_kernel, widen,
)
from ..ops.normals import (
    RING_TABLE_BYTES_PER_SLOT, collect_normal_rings,
    normal_encode_chain_sharded, rings_to_torch,
)
from ..ops.rans_lanes import encode_group_entropy_device
from ..ops.texcoords import (
    collect_uv_gathers, uv_encode_chain_sharded, uv_gathers_to_torch,
)
from ..shared.prediction import (
    ring_width, write_normal_flips, write_tex_orientations,
)
from ..shared.sequencer import compute_sequence
from ..wire.byte_io import ByteWriter

# The narrow upload layouts of the quantized positions and UVs
# (``upload_layout``); TORCHDRACO_PACKED_UPLOAD=0 turns them off, so that
# uint16 crosses the link at every depth up to 16 bits: the same bytes,
# tpudraco's TPUDRACO_PACKED_UPLOAD twin.
PACKED_UPLOAD = os.environ.get("TORCHDRACO_PACKED_UPLOAD", "1") != "0"


class PreparedTopology:
    """Reusable connectivity state for meshes sharing one topology: the
    connectivity byte blob, the corner tables, per-attribute traversal
    sequences, the per-device gather tensors of the fused step and K1's
    tile tables, and the normal rings and UV gathers of the attribute
    chains. ``traversal`` and
    ``single_connectivity`` are the Config's: the connectivity bytes bake
    them in."""

    def __init__(self, mesh, traversal: int = 0,
                 single_connectivity: bool = False) -> None:
        w = ByteWriter()
        eb = EdgebreakerEncoder(mesh.faces, mesh.attributes,
                                traversal=traversal,
                                single_connectivity=single_connectivity)
        self.conn_out = eb.encode(w)
        self.conn_bytes = w.getvalue()
        self.sequences: dict[int, list[int]] = {}
        # per-attribute parallelogram gathers of the host assembly, keyed
        # like tpudraco's: every mesh of this topology reuses them
        self.pred_gathers: dict[int, dict] = {}
        # str(device) -> gather tensors of the position attribute
        self.dev_gathers: dict[str, dict] = {}
        # (str(device), traversal segment or None) -> K1's tile tables
        # (ops/device.py predict_tiles), built where its tiled kernel runs
        # (the span ``position.tiles``, which the routes count in
        # topology_s)
        self.dev_tiles: dict[tuple, PredictTiles] = {}
        self.normal_rings: dict[int, dict] = {}  # lazy (ops/normals.py)
        self.uv_gathers: dict[int, dict] = {}    # lazy (ops/texcoords.py)
        # (kind, attribute, str(device)) -> the tensors of either
        self.dev_chain_tables: dict[tuple, dict] = {}
        for i in range(len(mesh.attributes)):
            self.sequences[i] = compute_sequence(
                self.view_for(i), list(self.conn_out.corners_of_edgebreaker))

    def view_for(self, i: int):
        aict = self.conn_out.corner_table
        att_table = None
        if 0 < i <= len(aict.attribute_tables):
            att_table = aict.attribute_tables[i - 1]
        return TableView(aict.corner_table, att_table)

    def rings_for(self, i: int) -> dict:
        if i not in self.normal_rings:
            self.normal_rings[i] = collect_normal_rings(
                self.view_for(i), self.sequences[i])
        return self.normal_rings[i]

    def uv_gathers_for(self, i: int, num_pos_points: int) -> dict:
        if i not in self.uv_gathers:
            self.uv_gathers[i] = collect_uv_gathers(
                self.view_for(i), self.sequences[i], num_pos_points)
        return self.uv_gathers[i]

    def dev_rings_for(self, i: int, dev: torch.device) -> dict:
        key = ("rings", i, str(dev))
        if key not in self.dev_chain_tables:
            self.dev_chain_tables[key] = rings_to_torch(self.rings_for(i),
                                                        dev)
        return self.dev_chain_tables[key]

    def dev_uv_gathers_for(self, i: int, num_pos_points: int,
                           dev: torch.device) -> dict:
        key = ("uv", i, str(dev))
        if key not in self.dev_chain_tables:
            self.dev_chain_tables[key] = uv_gathers_to_torch(
                self.uv_gathers_for(i, num_pos_points), dev)
        return self.dev_chain_tables[key]

    def device_bytes(self) -> int:
        """Bytes of the tensors this topology holds on devices (the
        position gathers, K1's tile tables and the chains' tables)."""
        return sum(t.numel() * t.element_size()
                   for tables in (*self.dev_gathers.values(),
                                  *self.dev_chain_tables.values())
                   for t in tables.values()) + sum(
            t.nbytes for t in self.dev_tiles.values())

    def drop_device_tables(self) -> None:
        self.dev_gathers.clear()
        self.dev_tiles.clear()
        self.dev_chain_tables.clear()


def topology_signature(mesh) -> str:
    """Meshes share a PreparedTopology iff faces and all per-attribute
    value-dedup maps coincide."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.faces).tobytes())
    for a in mesh.attributes:
        h.update(bytes([a.att_type, a.domain, a.num_components]))
        h.update(np.ascontiguousarray(a.unique_indices()).tobytes())
    return h.hexdigest()


def _drop_output_collisions(inputs, out_path_for):
    """Split ``inputs`` into (kept, collided): an input whose output path
    an earlier input already claimed (the same basename in two
    directories, a repeated path) is reported instead of overwriting the
    earlier result."""
    seen: dict = {}
    kept, collided = [], []
    for p in inputs:
        o = out_path_for(p)
        if o in seen:
            collided.append(p)
        else:
            seen[o] = p
            kept.append(p)
    return kept, collided


def _refused_input(mesh) -> bool:
    """Whether the host encoder refuses ``mesh`` (``_require_finite``):
    NaN or inf in a float attribute it quantizes, which is every type
    but CUSTOM. The device planes would raise for the mesh's whole call,
    so the corpus drivers and the router keep such a mesh out of them and
    leave it to the host encoder, which raises the same error for it
    alone."""
    return any(a.att_type != AttributeType.CUSTOM
               and np.issubdtype(a.values.dtype, np.floating)
               and not np.isfinite(a.values).all()
               for a in mesh.attributes)


# default wire depths (portabilization/mod.rs:116-143): POSITION 11,
# NORMAL 8 (octahedral), TEX_COORD 10
DEFAULT_DEPTHS = {"bits": 11, "normal_bits": 8, "uv_bits": 10}
_DEPTH_TYPES = (("bits", AttributeType.POSITION),
                ("normal_bits", AttributeType.NORMAL),
                ("uv_bits", AttributeType.TEX_COORD))
# the attribute types that have a device chain beside the position path
_CHAIN_TYPES = (AttributeType.NORMAL, AttributeType.TEX_COORD)


def _device_quant_bits(cfg) -> dict | None:
    """The depth kwargs iff ``cfg`` differs from the default Config ONLY in
    quantization depths, all in range; None otherwise. None cfg is the
    default config."""
    if cfg is None:
        return dict(DEFAULT_DEPTHS)
    if dataclasses.replace(cfg, quant_bits={}) != Config():
        return None
    out = {k: cfg.quant_bits.get(t, DEFAULT_DEPTHS[k])
           for k, t in _DEPTH_TYPES}
    if not _depths_in_range(**out):
        return None
    return out


def _depths_in_range(bits: int, normal_bits: int, uv_bits: int) -> bool:
    """Accepted depths: normals 7..16 (OctOrthogonal mod-max ambiguity
    below 7), position/UV 1..30."""
    return (7 <= normal_bits <= 16 and 1 <= bits <= 30
            and 1 <= uv_bits <= 30)


def _merged_quant_cfg(base_cfg, bits: int, normal_bits: int,
                      uv_bits: int):
    """The assembly Config: the resolved depths override base_cfg's
    quantization entries (set when non-default, dropped when default —
    both spell identical bytes); other quantization keys pass through."""
    qb = dict(base_cfg.quant_bits) if base_cfg is not None else {}
    vals = {"bits": bits, "normal_bits": normal_bits, "uv_bits": uv_bits}
    for k, t in _DEPTH_TYPES:
        if vals[k] != DEFAULT_DEPTHS[k]:
            qb[t] = vals[k]
        else:
            qb.pop(t, None)
    return Config(quant_bits=qb) if qb else None


def encode_with_topology(mesh, topo: PreparedTopology, cfg=None,
                         precomputed: dict | None = None) -> bytes:
    """encode() with the connectivity stage replayed from the cache and,
    on the device path, the position payload precomputed."""
    cfg = cfg or Config()
    writer = ByteWriter()
    encode_header(writer, cfg)
    if cfg.metadata:
        encode_metadata(mesh, writer)
    writer.write_bytes(topo.conn_bytes)
    encode_attributes(
        mesh.attributes, writer, topo.conn_out, sequences=topo.sequences,
        precomputed=precomputed, quant_bits=cfg.quant_bits,
        symbol_coding=cfg.symbol_coding, prediction=cfg.prediction,
        transform=cfg.transform, pred_cache=topo.pred_gathers,
        attribute_traversal=_traversal_wire_id(
            cfg.attribute_traversal))
    return writer.getvalue()


def topology_gathers_np(topo: PreparedTopology, pos_att) -> dict:
    """Per-topology parallelogram gather arrays (numpy): the native pass,
    with the Python pass where the native library is missing."""
    view = TableView(topo.conn_out.corner_table.corner_table)
    seq = topo.sequences[0]
    unique_of_point = pos_att.unique_indices()
    arrays = view.as_arrays()
    voc = unique_of_point[view.u.faces_points.ravel()]
    g = native_topo.parallelogram_gathers(
        arrays[0], arrays[1], arrays[2], voc, np.asarray(seq))
    if g is None:
        g = build_parallelogram_gathers(view, seq, unique_of_point)
    return {k: np.asarray(v) for k, v in g.items()}


def gathers_to_torch(g_np: dict, device) -> dict:
    """The ``topology_gathers_np`` dict as tensors on ``device`` (None:
    the card): int32 indices, bool masks."""
    dev = resolve(device)
    out = {}
    for k, v in g_np.items():
        dt = torch.bool if v.dtype == np.bool_ else torch.int32
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
            dtype=dt).to(dev)
    return out


def quantize_positions_host(batch: np.ndarray, bits: int):
    """Canonical coordinate-wise quantization of a (B, V, C) float32 batch,
    the exact per-value formula of ``quantize_coordinate_wise`` (min/max
    seeded with zero, one shared delta_max per mesh, float32 math).
    Returns (q int32 (B, V, C), mins float32 (B, C), delta_max (B,))."""
    vals = batch.astype(np.float32)
    zero = np.float32(0.0)
    mins = np.minimum(vals.min(axis=1), zero).astype(np.float32)
    maxs = np.maximum(vals.max(axis=1), zero).astype(np.float32)
    # this path replaces portabilize for the batch, so it carries its
    # non-finite rejection (NaN/inf reach the min/max reductions)
    if not (np.isfinite(mins).all() and np.isfinite(maxs).all()):
        bad = ~(np.isfinite(mins).all(axis=1)
                & np.isfinite(maxs).all(axis=1))
        raise ValueError(
            f"attribute POSITION contains non-finite values (NaN/inf) in "
            f"{int(bad.sum())} mesh(es) of the batch; refusing to quantize")
    delta_max = np.maximum(np.float32(0.0),
                           (maxs - mins).max(axis=1)).astype(np.float32)
    work = vals - mins[:, None, :]
    safe = np.where(delta_max == 0.0, np.float32(1.0), delta_max)
    np.divide(work, safe[:, None, None], out=work)
    if np.any(delta_max == 0.0):
        # degenerate meshes keep the un-divided diff (canonical branch)
        dz = delta_max == 0.0
        work[dz] = vals[dz] - mins[dz][:, None, :]
    np.multiply(work, np.float32((1 << bits) - 1), out=work)
    np.add(work, np.float32(0.5), out=work)
    q = work.astype(np.int32)
    return q, mins, delta_max


def _device_gathers(topo: PreparedTopology, pos_att, dev: torch.device,
                    num_values: int) -> dict:
    key = str(dev)
    if key not in topo.dev_gathers:
        g = topology_gathers_np(topo, pos_att)
        for k in ("order", "next", "prev", "opp", "fallback"):
            v = g[k]
            if len(v) and (int(v.min()) < 0 or int(v.max()) >= num_values):
                raise ValueError(f"gather {k!r} indexes outside the "
                                 f"{num_values} quantized values")
        topo.dev_gathers[key] = gathers_to_torch(g, dev)
    return topo.dev_gathers[key]


def _device_tiles(topo: PreparedTopology, pos_att, dev: torch.device,
                  num_values: int, span: tuple | None = None) -> PredictTiles:
    """K1's tile tables of the topology's traversal on ``dev``, or of its
    steps [a, b) for ``span`` (a stream shard's segment), built once, on
    the first request; the routes hand K1 this function, which it calls
    only where it takes its tiled kernel (``predict_residual``)."""
    key = (str(dev), span)
    if key not in topo.dev_tiles:
        with trace.timed("position.tiles"):
            g = _device_gathers(topo, pos_att, dev, num_values)
            if span is not None:
                g = {k: v[span[0]:span[1]] for k, v in g.items()}
            topo.dev_tiles[key] = predict_tiles(g)  # ends in a host sync
    return topo.dev_tiles[key]


def _host_quantize(batch: np.ndarray, bits: int):
    """Quantize a (B, V, C) float32 batch on the host (C++, the canonical
    formula; numpy where the native library is missing or the depth passes
    16 bits, and for non-finite input, which raises there). Returns (q,
    mins, delta_max, vmin, vmax): q uint16 up to 16 bits, int32 past it;
    vmin and vmax int32."""
    got = native.quantize_batch(batch, bits) if bits <= 16 else None
    if got is not None:
        return got
    q, mins, delta_max = quantize_positions_host(batch, bits)
    vmin = q.min(axis=(1, 2)).astype(np.int32)
    vmax = q.max(axis=(1, 2)).astype(np.int32)
    return (q.astype(np.uint16) if bits <= 16 else q, mins, delta_max,
            vmin, vmax)


def upload_layout(bits: int) -> str:
    """The layout host-quantized values of ``bits`` bits cross the link in
    (the rule of ``tpudraco/parallel/batch.py`` ``device_encode_group``):
    ``"u8"`` at up to 8 bits, ``"pack12"`` (``native.pack12``: a low byte
    a value and a nibble a value, paired within a mesh's row) at up to 12,
    ``"u16"`` at up to 16 and ``"i32"`` beyond; with ``PACKED_UPLOAD``
    off, ``"u16"`` up to 16 bits."""
    if bits > 16:
        return "i32"
    if PACKED_UPLOAD and bits <= 8:
        return "u8"
    if PACKED_UPLOAD and bits <= 12:
        return "pack12"
    return "u16"


def _upload(q: np.ndarray, bits: int, axis: list) -> tuple[list, int]:
    """Host-quantized values ``q`` (B, ...) (uint16 up to 16 bits, int32
    past them: ``_host_quantize``) in the layout of ``bits``
    (``upload_layout``), cut along the batch axis (``shard_rows``; the
    12-bit pack's lo (B, ...) and hb (B, ceil(n/2)) cut on their rows
    alike) and piece i moved to ``axis[i]``. Returns (one upload a shard:
    a tensor, or the pack's (lo, hb) pair; the bytes sent)."""
    layout = upload_layout(bits)
    if layout == "u8":
        parts = (q.astype(np.uint8),)
    elif layout == "pack12":
        parts = native.pack12(q)
    else:
        parts = (q,)
    shards = [shard_rows(p, axis) for p in parts]
    return (list(zip(*shards)) if layout == "pack12" else shards[0],
            sum(p.nbytes for p in parts))


def device_encode_group(positions_batch: np.ndarray, topo: PreparedTopology,
                        pos_att, bits: int = 11, device=None,
                        mesh_axis=None) -> dict:
    """The fused step for a (B, V, C) float32 batch sharing ``topo``:
    quantize on the host (C++, the canonical formula), upload in the
    layout of ``bits`` (``upload_layout``: uint8, the 12-bit pack, uint16
    or int32), run K1, which reads that layout, and K2 on ``device``
    (None: the card; ``"cpu"`` runs their plain twins) or, with
    ``mesh_axis`` (a shard axis, ``resolve_axis``; ``device``, if given,
    its first device), split over its devices as ``_jit_step_sharded_q``
    and ``_jit_step_sharded_p12`` split the batch: shard i uploads its
    rows (``shard_bounds``) and runs K1 and K2 there against that
    device's gathers. Without an axis the one device is the axis.

    Returns ``symbols`` (B_i, T, C) int32, ``counts`` and the values as
    uploaded (``q_dev``: a uint8, uint16 or int32 tensor, or the pack's
    (lo, hb) pair) as lists, one entry a shard of the axis on its device,
    in axis order (empty where the batch has fewer meshes than the axis
    has shards); ``h2d_bytes``, the bytes of ``q_dev``; and on the host,
    whole, vmin/vmax, mins, delta_max and the quantized values (``q``)."""
    axis = axis_for(device, mesh_axis)
    B, V, C = positions_batch.shape
    q_np, mins, delta_max, vmin, vmax = _host_quantize(positions_batch, bits)
    q_up, h2d_bytes = _upload(q_np, bits, axis)
    shards = {"symbols": [], "counts": [], "q_dev": []}
    for dev, q_dev, lo, hi in zip(axis, q_up, *(shard_rows(x, axis)
                                                for x in (vmin, vmax))):
        symbols, counts = encode_step_from_q_cuda(
            q_dev, _device_gathers(topo, pos_att, dev, V), lo, hi,
            bits=bits,
            tiles=functools.partial(_device_tiles, topo, pos_att, dev, V))
        for k, v in zip(shards, (symbols, counts, q_dev)):
            shards[k].append(v)
    return {"vmin": vmin, "vmax": vmax, "mins": mins,
            "delta_max": delta_max, "q": q_np, "h2d_bytes": h2d_bytes,
            **shards}


def _attribute_eligible(meshes, idxs, att_idx, pos_id, n_comp):
    """Device-chain eligibility shared by the normal and UV entries: the
    attribute must be float32 with the expected component count IN EVERY
    mesh of the group (topology_signature does not hash dtype) and must be
    parented to the group's position attribute (the device chains predict
    from it, matching the host's parents[0])."""
    a0 = meshes[idxs[0]].attributes[att_idx]
    if a0.num_components != n_comp or a0.parents != [pos_id]:
        return False
    return all(meshes[i].attributes[att_idx].values.dtype == np.float32
               for i in idxs)


def _direct_coded_payload(symbols: np.ndarray) -> bytes:
    """One mesh's symbols as a DIRECT_CODED section: the host's C++ coder
    where it runs, else the numpy one."""
    w = ByteWriter()
    encode_symbols(symbols.astype(np.uint64).ravel(), 2, DIRECT_CODED, w)
    return w.getvalue()


def _chain_meta(row, n_mx: int = 0, lo: int | None = None,
                hi: int | None = None) -> bytes:
    """One mesh's chain metadata: the NORMAL transform's two u32 and its
    flips ``row`` (``lo`` None), or the TEX_COORD orientations ``row``
    and the u32 range ``lo``, ``hi``."""
    xw = ByteWriter()
    if lo is None:
        xw.write_u32(n_mx)
        xw.write_u32(n_mx // 2)
        write_normal_flips(row, xw)
    else:
        write_tex_orientations(row, xw)
        xw.write_u32(int(lo) & 0xFFFFFFFF)
        xw.write_u32(int(hi) & 0xFFFFFFFF)
    return xw.getvalue()


def _chain_payloads(syms: np.ndarray, skip: np.ndarray, bits: np.ndarray,
                    flags: np.ndarray | None = None, vmin=None, vmax=None,
                    n_mx: int = 0) -> tuple[dict, dict]:
    """The entries {k: {"payload", "xform_meta"}} of one NORMAL (``flags``
    None: ``bits`` the flips, ``n_mx`` the wire's maximum) or TEX_COORD
    attribute (``bits`` the orientation values, ``flags`` which are coded,
    ``vmin`` / ``vmax`` the ranges) for every mesh k of a chunk not in
    ``skip``, and the ``chains.payloads`` span's counts. One native call
    writes them all (``native.chain_payloads``); a mesh it leaves, and
    every mesh without the library, takes ``_chain_meta`` and
    ``_direct_coded_payload``, which write the same bytes."""
    got = native.chain_payloads(syms, skip, bits, flags, vmin, vmax, n_mx)
    buf, offs, n_bits = got if got is not None else (b"", None, 0)
    offs = offs.tolist() if offs is not None else [(-2, 0, 0)] * len(skip)
    out = {}
    for k, (a, b, c) in enumerate(offs):
        if skip[k]:
            continue
        if a >= 0:
            out[k] = {"payload": buf[b:c], "xform_meta": buf[a:b]}
            continue
        if flags is None:
            row, meta = bits[k], {"n_mx": n_mx}
        else:
            row, meta = bits[k][flags[k]], {"lo": vmin[k], "hi": vmax[k]}
        n_bits += len(row)
        out[k] = {"payload": _direct_coded_payload(syms[k]),
                  "xform_meta": _chain_meta(row, **meta)}
    return out, {"meshes": len(out), "skipped": int(np.count_nonzero(skip)),
                 "bits": n_bits, "native": got is not None}


def _normal_chain_fits(ring: int, bits: int) -> bool:
    """Whether the device chain codes a NORMAL attribute of ring width
    ``ring`` beside ``bits``-bit positions: only where no ring
    intermediate can leave int32 (the reference's headroom rule, kept as
    the routing rule: which side codes an attribute does not depend on
    the package)."""
    return 3 * ring * (1 << (2 * bits + 1)) < (1 << 31)


def _device_extra_attribute_entries(meshes, idxs, topo: PreparedTopology,
                                    bits: int, normal_bits: int = 8,
                                    uv_bits: int = 10, device=None,
                                    q_pos=None, mesh_axis=None) -> dict:
    """Device-encode the NORMAL (ops/normals.py) and TEX_COORD
    (ops/texcoords.py) attributes of one chunk ``idxs`` of a topology
    group through the sharded chains, over ``mesh_axis`` or else the one
    device ``device`` (None: the card), each device holding the tables
    of the topology. ``q_pos`` is the chunk's quantized positions as
    already uploaded (``device_encode_group``'s ``q_dev``, one upload a
    shard, in any layout); without it they are quantized and uploaded
    here, once, in the layout of ``bits`` (``upload_layout``). Either way
    each shard's positions are widened to int32 once on its device and
    feed every chain; the UVs cross the link in the layout of
    ``uv_bits`` and are widened there too (``_host_quantized_upload``'s
    counterpart). Returns
    {position-in-idxs: {att_idx: {"payload", "xform_meta", "port_meta"}}},
    each entry with the bytes its portabilization writes (the UVs' also
    with their values, ``port_values``: ``_quantized_port``), so that the
    assembly does not portabilize it again; ineligible
    attributes (or individual "risky"/degenerate meshes) are simply
    absent and take the host path in the assembly. An error inside a chain
    raises."""
    axis = axis_for(device, mesh_axis)
    mesh0 = meshes[idxs[0]]
    out: dict = {}
    pos_att0 = mesh0.position_attribute()
    pos_id = pos_att0.att_id

    normal_idxs = []
    for ni, a in enumerate(mesh0.attributes):
        if a.att_type != AttributeType.NORMAL:
            continue
        # the wire rejects depths < 7 (OctOrthogonal mod-max ambiguity,
        # portabilization.py); route out-of-range depths to the host
        # path so its canonical error surfaces
        if not 7 <= normal_bits <= 16:
            continue
        if not _attribute_eligible(meshes, idxs, ni, pos_id, 3):
            continue
        if not _normal_chain_fits(
                max(int(topo.rings_for(ni)["next_pt"].shape[1]), 1), bits):
            continue
        normal_idxs.append(ni)
    uv_idxs = [ui for ui, a in enumerate(mesh0.attributes)
               if a.att_type == AttributeType.TEX_COORD
               and _attribute_eligible(meshes, idxs, ui, pos_id, 2)]
    if not normal_idxs and not uv_idxs:
        return out

    # per-mesh degeneracy guard for normals: a zero/non-finite normal
    # makes the host path NaN-propagate (0/0) where the device chain's
    # division masks to 0 — route such meshes to the host
    nrm_ok = {ni: np.array([
        bool(np.isfinite(v).all() and not (v == 0).all(axis=1).any())
        for v in (meshes[i].attributes[ni].values for i in idxs)])
        for ni in normal_idxs}

    def stacked(att_idx):
        return np.stack([meshes[i].attributes[att_idx].values
                         .astype(np.float32) for i in idxs])

    uv_batches = {ui: stacked(ui) for ui in uv_idxs}
    # non-finite UVs must take the host path (its portabilize raises the
    # canonical error)
    uv_idxs = [ui for ui in uv_idxs if np.isfinite(uv_batches[ui]).all()]
    if not normal_idxs and not uv_idxs:
        return out

    if q_pos is None:
        pos_idx = next(j for j, a in enumerate(mesh0.attributes)
                       if a is pos_att0)
        q_pos = _upload(_host_quantize(stacked(pos_idx), bits)[0], bits,
                        axis)[0]
    # the chains take int32 values: each shard's upload widened on its device
    q_pos = [widen(q) for q in q_pos]
    uo_pos = replicate(pos_att0.unique_indices().astype(np.int64), axis)

    for ni in normal_idxs:
        uo_nrm = mesh0.attributes[ni].unique_indices().astype(np.int64)
        rings = [topo.dev_rings_for(ni, d) for d in axis]
        tables = [[r[k] for r in rings]
                  for k in ("tip_pt", "next_pt", "prev_pt", "mask")]
        s, f = normal_encode_chain_sharded(
            q_pos, stacked(ni), *tables, uo_pos, uo_nrm, bits=normal_bits,
            mesh_axis=axis)
        syms, flips = s.cpu().numpy(), f.cpu().numpy()
        with trace.span("chains.payloads") as sp:
            got, counts = _chain_payloads(syms, ~nrm_ok[ni], flips,
                                          n_mx=(1 << normal_bits) - 1)
            sp.note(**counts)
        for k, entry in got.items():
            # quantize_octahedral's bytes: the depth alone
            entry["port_meta"] = bytes([normal_bits])
            out.setdefault(k, {})[ni] = entry
    for ui in uv_idxs:
        q, mins, delta_max = _host_quantize(uv_batches[ui], uv_bits)[:3]
        q_uv = [widen(x) for x in _upload(q, uv_bits, axis)[0]]
        uo_uv = mesh0.attributes[ui].unique_indices()
        g = [topo.dev_uv_gathers_for(ui, pos_att0.num_points, d)
             for d in axis]
        syms, vmin, vmax, ovals, oflags, risky = uv_encode_chain_sharded(
            q_pos, q_uv, g, uo_pos, uo_uv, mesh_axis=axis)
        # a risky mesh's UVs take the host path, which codes them exactly
        with trace.span("chains.payloads") as sp:
            got, counts = _chain_payloads(syms, risky, ovals, oflags, vmin,
                                          vmax)
            sp.note(**counts)
        for k, entry in got.items():
            entry.update(_quantized_port(q, mins, delta_max, k, uv_bits))
            out.setdefault(k, {})[ui] = entry
    return out


def _read_symbols(sym: torch.Tensor, bits: int) -> np.ndarray:
    """Position symbols moved to the host, as uint16 where ``bits + 1 <=
    16`` (zigzag symbols stay below 2^(bits+1): half the bytes)."""
    return (sym.to(torch.uint16) if bits + 1 <= 16 else sym).cpu().numpy()


def _check_counted(counts: list, symbols: np.ndarray) -> None:
    """Raise where K2's histograms ``counts`` do not count every symbol
    read back (a RuntimeError, which ``-O`` does not strip)."""
    n_counted = sum(int(c.sum()) for c in counts)
    if n_counted != symbols.size:
        raise RuntimeError(f"histogram lost symbols: {n_counted} of "
                           f"{symbols.size} counted")


def _quantized_port(q: np.ndarray, mins: np.ndarray,
                    delta_max: np.ndarray, k: int, bits: int) -> dict:
    """Mesh ``k``'s portabilization out of ``_host_quantize``'s ``q``,
    ``mins`` and ``delta_max``: the bytes ``quantize_coordinate_wise``
    writes (``port_meta``: the mins and delta_max as float32, the depth)
    and its values (``port_values``)."""
    return {"port_meta": mins[k].astype("<f4").tobytes()
            + delta_max[k:k + 1].astype("<f4").tobytes() + bytes([bits]),
            "port_values": q[k]}


def _position_entry(mesh, payload: bytes, quant: dict, k: int,
                    bits: int) -> dict:
    """{POSITION index: the precomputed entry} of mesh ``k`` of a route's
    quantize results ``quant``: ``payload``, the residual range ``vmin``,
    ``vmax`` as the transform's two u32 and, where the host quantize ran
    (``quant`` holds ``_host_quantize``'s ``q``, ``mins``, ``delta_max``),
    the quantization metadata and values, which the assembly then does
    not redo."""
    w = ByteWriter()
    w.write_u32(int(quant["vmin"][k]) & 0xFFFFFFFF)
    w.write_u32(int(quant["vmax"][k]) & 0xFFFFFFFF)
    entry = {"payload": payload, "xform_meta": bytes(w.getvalue())}
    if "q" in quant:
        entry.update(_quantized_port(quant["q"], quant["mins"],
                                     quant["delta_max"], k, bits))
    pos_idx = next(j for j, a in enumerate(mesh.attributes)
                   if a.att_type == AttributeType.POSITION)
    return {pos_idx: entry}


def _chain_counts(mesh, pre: dict) -> tuple[int, int, int]:
    """(carried, ported, host) of ``mesh``'s NORMAL and TEX_COORD
    attributes: those whose chain entry in ``pre`` carries its
    portabilization (``carries_port``), which the assembly emits as it
    stands; those the assembly portabilizes itself; and of those, the
    ones without an entry, which a guard of the chains left to the host
    encoder."""
    named = {p for a in mesh.attributes for p in a.parents}
    chains = [(j, a) for j, a in enumerate(mesh.attributes)
              if a.att_type in _CHAIN_TYPES]
    carried = sum(carries_port(pre.get(j), a, named) for j, a in chains)
    host = sum(j not in pre for j, _ in chains)
    return carried, len(chains) - carried, host


def _assemble_precomputed(mesh, topo: PreparedTopology, cfg,
                          symbols: np.ndarray, quant: dict, bits: int,
                          extra_pre: dict | None = None) -> bytes:
    """The .drc of a single-mesh route's mesh at its route's ``cfg``: the
    host's C++ rANS coder (DIRECT_CODED) codes its position symbols (T,
    C), ``_position_entry`` makes their entry, ``extra_pre`` adds device
    entries of other attributes. Attributes without an entry are coded
    by the host encoder inside the assembly."""
    with trace.span("assembly.rans"):
        payload = _direct_coded_payload(symbols)
    pre = _position_entry(mesh, payload, quant, 0, bits)
    pre.update(extra_pre or {})
    return encode_with_topology(mesh, topo, cfg=cfg, precomputed=pre)


def _stage_timings(totals: dict, single: bool = False) -> dict:
    """An encode root's ``timings`` from its totals (``trace.root``): the
    stages in seconds, K1's tile tables (``position.tiles``) counted as
    topology work and not as the position path's. In a single-mesh route
    the signatures count as topology work too, and ``chains_s`` is there
    where the route runs the chains; elsewhere ``h2d_mb`` is the
    megabytes the group path uploaded (the total ``h2d_bytes``)."""
    s = {k: v * 1e-9 for k, v in totals.items()}
    tiles = s.get("position.tiles", 0.0)
    out = {"signatures_s": s.get("signatures", 0.0),
           "topology_s": s.get("topology", 0.0) + tiles,
           "position_s": s.get("position", 0.0) - tiles,
           "chains_s": s.get("chains", 0.0),
           "assembly_s": s.get("assembly", 0.0)}
    if not single:
        out["h2d_mb"] = totals.get("h2d_bytes", 0) / 1e6
        return out
    out["topology_s"] += out.pop("signatures_s")
    if "chains" not in totals:
        del out["chains_s"]
    return out


class BatchEncoder:
    """Encodes meshes with topology-group batching, the POSITION, NORMAL
    and TEX_COORD attributes on the device, and single meshes through the
    host plane or the single-mesh device routes; ``encode_corpus`` drives
    files on disk through one of the planes or the router. The device
    paths take a ``cfg`` that differs from the default Config only in
    quantization depths; ``encode_mesh`` takes any. ``n_host_attributes``
    counts the NORMAL and TEX_COORD attributes that a guard of the device
    chains sent to the host encoder (per mesh and attribute); ``timings``
    holds the host seconds of the last device call by stage
    (``position_s``: the quantize, upload, fused step and rANS coder of the
    position attribute, or the chunked route's three passes; ``chains_s``:
    the NORMAL and TEX_COORD chains with their readback and host payloads)
    and, for ``encode_meshes_device``, ``h2d_mb``: the megabytes of
    quantized positions uploaded, in their layout (``upload_layout``).
    Every device route is a root of spans (``torchdraco.trace``), and its
    ``timings`` are the call's totals (``_stage_timings``):
    ``signatures_s``, ``chains_s`` and ``assembly_s`` those of the spans
    of that name, ``position_s`` the ``position`` spans less K1's
    tile-table builds (``position.tiles``), which count in ``topology_s``
    beside ``topology`` (and, in the single-mesh routes,
    ``signatures``). After ``encode_meshes_auto``
    they describe the whole call: its device-plane calls' stages summed,
    the probes' and the host plane's seconds and the groups' counts (see
    there). To see the spans themselves,
    profile the call with ``torch.profiler`` and look for the
    ``torchdraco.*`` ranges in its trace.

    ``use_device``: the plane of ``encode_corpus``: True (the default) the
    device plane, False the host plane, ``"auto"`` the router
    (``encode_meshes_auto``). ``device``: where the device plane runs (None:
    the card; ``"cpu"`` runs the kernels' plain twins); a method's own
    ``device`` argument wins over it. A failure of a device plane raises,
    in the corpus driver and the router too: nothing falls back to the
    host plane. Per-file isolation comes from the input check
    (``_refused_input``): a mesh the host encoder would refuse is left to
    the per-file pass, which reports the encoder's error, and never joins
    a device group. ``route_cache_path``: the
    router's decision cache on disk; ``"default"`` is
    ``TORCHDRACO_ROUTE_CACHE`` or ``~/.cache/torchdraco/route_cache.json``,
    None or ``""`` keeps decisions in memory only. ``routing_log`` holds
    one entry per topology group the router decided.

    ``mesh_axis``: a shard axis (``torchdraco.device.resolve_axis``: a
    sequence of devices, which may repeat one card), the counterpart of
    tpudraco's 1-D ``("data",)`` mesh. The batch path splits every chunk
    of a topology group over it: the fused step, the rANS coder and the
    NORMAL and TEX_COORD chains run per shard, the same bytes; the corpus
    encoder, the router and ``transcode_corpus`` carry it. The single-mesh
    routes run on its first device (``encode_mesh_device_stream_sharded``
    takes an axis of its own). ``device``, where given beside it, must be
    the axis's first device."""

    # meshes per device call: the group's lanes run in one K3 launch
    DEVICE_CHUNK = 512
    # Card memory for the tables that topologies keep resident (position
    # gathers, normal rings, UV gathers), least recently used dropped
    # first. They cost 169 B a vertex with normals and UVs (int64 ring
    # indices, ring width 6) and 22 B with positions alone, so 8 GiB keeps
    # some 48 topologies of 1M vertices, or 12,000 of 64 x 64, and leaves
    # 71 GB of an 80 GB card to the working set: a 512-mesh chunk with
    # normals and UVs peaks at 0.2 GB (1.7 GB before the chains were
    # kernels), a resident mesh at most RESIDENT_MAX_BYTES.
    DEV_CACHE_BUDGET = 8 << 30
    # a lone mesh of CHUNKED_MIN_VERTS << 2 vertices or more is "huge": the
    # router sends it to _encode_huge; a group of meshes of
    # CHUNKED_MIN_VERTS vertices or more is probed whatever its size, and
    # on one mesh only
    CHUNKED_MIN_VERTS = 1 << 17
    # _encode_huge keeps a mesh resident while the resident route's
    # estimated peak (_resident_peak_bytes) stays within RESIDENT_MAX_BYTES,
    # and streams it in chunks beyond: half of an 80 GB card, beside
    # DEV_CACHE_BUDGET and the allocator's cache.
    RESIDENT_MAX_BYTES = 40 << 30
    # The estimate's terms, above the first-call peaks that chip_smoke.py
    # phase 12.3 measures (NVIDIA H100 80GB HBM3, 700 W): positions,
    # gathers, K1's tile tables (about 18 B a vertex, and the buffers of
    # their build) and symbols cost RESIDENT_BYTES_PER_VERTEX (46 B a
    # vertex on a 1024^2 grid before the tables). The chains are kernels
    # (C1, C3), whose memory is their inputs and outputs: each TEX_COORD
    # attribute costs RESIDENT_UV_BYTES_PER_VERTEX (the upload and its
    # int32 widening, the int64 unique-value maps, the gather tables of
    # UV_TABLE_BYTES_PER_STEP a step, 10 B of outputs a step); each
    # NORMAL attribute that the device chain takes costs
    # RING_TABLE_BYTES_PER_SLOT for each of its T x R ring slots (R is the
    # most corners on one vertex, so one fan or pole vertex sets it) and
    # RESIDENT_NORMAL_BYTES_PER_STEP a step (the int64 tip row, the
    # int32 positions, the float32 normals, the int64 maps, C1's 9 B of
    # outputs and their copy by the shard join): 66 B, and the rest for
    # the allocator's rounding. Measured first-call peaks against the
    # estimate: 1,024^2 grid with normals and UVs 272.7 MB (260 B a
    # vertex; 1.10 GB with the plain chains) against 509.6 MB; 512^2
    # grid with UVs 38.5 against 67.1 MB; 512^2 grid with a fan vertex of
    # valence 80, normals and UVs 404.9 MB (3.25 GB with the plain
    # chains) against 457.2 MB.
    RESIDENT_BYTES_PER_VERTEX = 96
    RESIDENT_UV_BYTES_PER_VERTEX = 160
    RESIDENT_NORMAL_BYTES_PER_STEP = 128
    # encode_corpus holds this many loaded meshes at once on the device
    # planes: two DEVICE_CHUNKs, so that a topology group of DEVICE_CHUNK
    # meshes inside a window fills one chunk
    DEVICE_CORPUS_WINDOW = 1024
    # The router's knobs, from chip_smoke.py phase 13.2's sweep of
    # encode_meshes_device at B = 1 ... 512 against the host plane per mesh
    # (64 x 64 grids; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
    # MIN_DEVICE_GROUP: a smaller group of small meshes stays on the host
    # without a probe. The device plane beat the host plane from B = 2 with
    # normals and UVs (35 ms against 51 ms; 25.6 ms a mesh on the host) and
    # from B = 16 with positions only (13 ms against 14 ms; 0.87 ms a mesh).
    # PROBE_CHUNK: the least width of the device probe, where the device
    # plane's time a mesh came within twice its time a mesh at B = 512
    # (positions only: 0.81 against 0.46 ms). PROBE_SKIP_S: a group whose
    # whole host cost is below this skips the probe: the device plane's
    # wall at PROBE_CHUNK meshes, positions only. chip_smoke.py runs the
    # corpus with these values and prints the sweep's beside them.
    MIN_DEVICE_GROUP = 2
    PROBE_SKIP_S = 0.013
    PROBE_CHUNK = 16

    def __init__(self, cfg=None, use_device: bool | str = True,
                 route_cache_path: str | None = "default",
                 device=None, mesh_axis=None) -> None:
        if use_device not in (False, True, "auto"):
            raise ValueError(f"use_device must be bool or 'auto', "
                             f"got {use_device!r}")
        self.cfg = cfg
        self.use_device = use_device
        self.device = device
        self.mesh_axis = mesh_axis
        self.n_host_attributes = 0
        self.routing_log: list[dict] = []
        # host seconds of the last device call, by stage
        self.timings: dict = {}
        # topology signature (with the traversal and single-connectivity
        # knobs when a cfg sets them) -> PreparedTopology
        self._topo_cache: dict = {}
        # LRU of topologies holding device tables, most recent last
        self._dev_cache: dict = {}
        # the router's decisions: signature -> (plane, size of the group
        # the decision routed), and the decision cache on disk
        self._plane_cache: dict = {}
        self._route_cache_path = (_route_cache_default_path()
                                  if route_cache_path == "default"
                                  else (route_cache_path or None))
        self._route_disk: dict | None = None
        self._route_dev_name = "cpu"
        # throughput observations of the lone-mesh rule: (kind, size
        # class) -> [position bytes, seconds, bytes at the last persist]
        self._mbs_obs: dict = {}

    def _axis(self, device) -> list:
        """The devices of a call (``axis_for``): the encoder's shard axis,
        whose first device the call's ``device``, else the encoder's, must
        be, or else the one device of the call, else of the encoder; the
        card where none is set."""
        return axis_for(self.device if device is None else device,
                        self.mesh_axis)

    def _dev(self, device) -> torch.device:
        """The device of a call where the results gather: the first of
        ``_axis``."""
        return self._axis(device)[0]

    def _dev_cache_touch(self, key, topo: PreparedTopology) -> None:
        """Mark ``topo``'s device tables most recently used and drop the
        least recent topologies' tables while the total passes
        DEV_CACHE_BUDGET (the topologies themselves stay cached)."""
        self._dev_cache.pop(key, None)
        self._dev_cache[key] = topo
        total = sum(t.device_bytes() for t in self._dev_cache.values())
        for old_key in list(self._dev_cache):
            if total <= self.DEV_CACHE_BUDGET or old_key == key:
                break
            old = self._dev_cache.pop(old_key)
            total -= old.device_bytes()
            old.drop_device_tables()

    def encode_mesh(self, mesh, cfg=None) -> bytes:
        """The host plane for one mesh, ``encode(mesh, cfg)``'s bytes, with
        the connectivity pass cached by topology (``cfg`` None:
        ``self.cfg``). The cache keys on the traversal kind and the
        single-connectivity knob too, which the connectivity bytes bake
        in."""
        cfg = cfg if cfg is not None else self.cfg
        key = topology_signature(mesh)
        if cfg is not None and (cfg.traversal
                                or cfg.use_single_connectivity):
            key = (key, cfg.traversal, cfg.use_single_connectivity)
        topo = self._topo_cache.get(key)
        if topo is None:
            topo = PreparedTopology(
                mesh, traversal=cfg.traversal if cfg is not None else 0,
                single_connectivity=bool(cfg is not None
                                         and cfg.use_single_connectivity))
            self._topo_cache[key] = topo
        return encode_with_topology(mesh, topo, cfg=cfg)

    def encode_meshes(self, meshes: list) -> list:
        """``encode_mesh`` for each mesh, with per-mesh isolation: a mesh
        that fails yields None and does not stop the others."""
        out: list[bytes | None] = []
        for m in meshes:
            try:
                out.append(self.encode_mesh(m))
            except Exception:
                out.append(None)
        return out

    def encode_meshes_device(self, meshes: list, bits: int | None = None,
                             entropy: str = "device",
                             normal_bits: int | None = None,
                             uv_bits: int | None = None,
                             device=None) -> list[bytes]:
        """Per topology group, the fused step of the position attribute and
        the NORMAL and TEX_COORD chains run on ``device`` (None: the
        encoder's ``device``, else the card; ``"cpu"`` runs the kernels'
        plain twins), or shard by shard over the encoder's ``mesh_axis``,
        in chunks of DEVICE_CHUNK meshes; the host assembles the bytes.
        Output equals sequential encode(). ``bits``/``normal_bits``/
        ``uv_bits`` are the -qp/-qn/-qt depths; unset depths come from
        ``self.cfg``.

        ``entropy`` picks the rANS coder of the position symbols:
        ``"device"`` (the default) codes each chunk's meshes as lanes of one
        K3 launch; ``"host"`` reads the symbols back (uint16 where
        ``bits + 1 <= 16``) and codes each mesh with the host's C++ coder on
        a pool of 8 threads. The bytes are the same.

        An attribute or mesh that a chain's guard refuses (a zero or
        non-finite normal, a "risky" UV row, non-finite UVs, a type or
        parent the chains do not take) is coded by the host encoder inside
        the assembly, same bytes, and counted in ``n_host_attributes``.
        Errors raise, for the whole call; there is no host fallback."""
        if entropy not in ("device", "host"):
            raise ValueError(f"entropy must be 'device' or 'host', "
                             f"got {entropy!r}")
        axis = self._axis(device)
        depths, cfg = self._resolve_depths(bits, normal_bits, uv_bits)
        with trace.root("encode_meshes_device", meshes=len(meshes)) as call:
            with trace.timed("signatures"):
                groups: dict[str, list[int]] = {}
                for idx, m in enumerate(meshes):
                    groups.setdefault(topology_signature(m), []).append(idx)
            out: list[bytes | None] = [None] * len(meshes)
            # the upload's bytes ride the totals up to an enclosing root
            call.totals["h2d_bytes"] = 0
            for sig, idxs in groups.items():
                call.totals["h2d_bytes"] += self._encode_group_device(
                    meshes, sig, idxs, out, depths, cfg, entropy, axis)
        self.timings = _stage_timings(call.totals)
        return out

    def _device_plane(self, meshes: list, device=None) -> list:
        """The device plane of the corpus driver, the router and
        ``transcode_corpus``: ``encode_meshes_device`` at the encoder's
        depths over the meshes that pass the input check; a refused mesh
        yields None (the caller's per-file pass reports the host encoder's
        error for it), so one bad file does not stop its topology group.
        A device failure raises."""
        out: list[bytes | None] = [None] * len(meshes)
        ok = [i for i, m in enumerate(meshes) if not _refused_input(m)]
        if ok:
            blobs = self.encode_meshes_device([meshes[i] for i in ok],
                                              device=device)
            for i, blob in zip(ok, blobs):
                out[i] = blob
        return out

    def _encode_group_device(self, meshes, sig, idxs, out, depths: dict,
                             cfg, entropy, axis) -> int:
        """One topology group of ``encode_meshes_device`` into ``out`` at
        the resolved ``depths`` and ``cfg``, over the devices ``axis``;
        returns the bytes of quantized positions uploaded."""
        with trace.timed("topology"):
            topo = self._topo_cache.get(sig)
            if topo is None:
                topo = PreparedTopology(meshes[idxs[0]])
                self._topo_cache[sig] = topo
        pos_att0 = meshes[idxs[0]].position_attribute()
        batch = np.stack([meshes[i].position_attribute().values
                          .astype(np.float32) for i in idxs])
        bits = depths["bits"]
        h2d_bytes = 0
        for c0 in range(0, len(idxs), self.DEVICE_CHUNK):
            chunk = idxs[c0:c0 + self.DEVICE_CHUNK]
            with trace.timed("position"):
                dev_c = device_encode_group(
                    batch[c0:c0 + self.DEVICE_CHUNK], topo, pos_att0,
                    bits=bits, mesh_axis=axis)
                if entropy == "device":
                    payloads = encode_group_entropy_device(
                        dev_c["symbols"], dev_c["counts"], mesh_axis=axis)
                else:  # the shards in axis order, the host's C++ coder
                    syms = np.concatenate([_read_symbols(p, bits)
                                           for p in dev_c["symbols"]])
                    _check_counted(dev_c["counts"], syms)
                    with ThreadPoolExecutor(max_workers=8) as pool:
                        payloads = list(pool.map(_direct_coded_payload, syms))
            h2d_bytes += dev_c["h2d_bytes"]
            with trace.timed("chains"):
                # the NORMAL and TEX_COORD chains read the positions the
                # fused step uploaded: quantized once, uploaded once
                extra = _device_extra_attribute_entries(
                    meshes, chunk, topo, **depths, q_pos=dev_c["q_dev"],
                    mesh_axis=axis)
            with trace.timed("assembly") as sp:
                carried = ported = 0
                for k, i in enumerate(chunk):
                    pre = _position_entry(meshes[i], payloads[k], dev_c, k,
                                          bits)
                    pre.update(extra.get(k, {}))
                    c, p, host = _chain_counts(meshes[i], pre)
                    carried, ported = carried + c, ported + p
                    self.n_host_attributes += host
                    out[i] = encode_with_topology(meshes[i], topo, cfg=cfg,
                                                  precomputed=pre)
                sp.note(carried=carried, ported=ported)
        self._dev_cache_touch(sig, topo)
        return h2d_bytes

    # ------------------------------------------------------------------
    # one large mesh

    def _topo_for(self, mesh):
        """(cache key, PreparedTopology) of ``mesh`` under the device
        routes' connectivity (the default: their cfg holds depths only)."""
        with trace.timed("signatures"):
            key = topology_signature(mesh)
        with trace.timed("topology"):
            topo = self._topo_cache.get(key)
            if topo is None:
                topo = self._topo_cache[key] = PreparedTopology(mesh)
        return key, topo

    def _resolve_depths(self, bits: int | None = None,
                        normal_bits: int | None = None,
                        uv_bits: int | None = None
                        ) -> tuple[dict, Config | None]:
        """The device routes' depths and assembly Config: each depth given
        (-qp, -qn, -qt), the rest from ``self.cfg``, which must hold
        quantization depths only (other overrides cannot ride the
        precomputed positions)."""
        depths = _device_quant_bits(self.cfg)
        if depths is None:
            raise ValueError(
                "BatchEncoder.cfg goes beyond the device routes' config "
                "space (quantization depths only); encode such meshes with "
                "encode_mesh instead")
        given = {"bits": bits, "normal_bits": normal_bits, "uv_bits": uv_bits}
        depths.update((k, v) for k, v in given.items() if v is not None)
        if not _depths_in_range(**depths):
            raise ValueError(
                f"quantization depths out of range (position "
                f"{depths['bits']}, normal {depths['normal_bits']} [7..16], "
                f"texcoord {depths['uv_bits']})")
        return depths, _merged_quant_cfg(self.cfg, **depths)

    def encode_mesh_device(self, mesh, bits: int | None = None,
                           device=None) -> bytes:
        """One mesh with its positions and gathers resident on ``device``
        (None: the encoder's ``device``, else the card; ``"cpu"`` runs
        the plain twins): the host C++ quantize, one upload in the layout
        of the depth (``upload_layout``), K1 and K2 at B = 1, the NORMAL and
        TEX_COORD chains on the same uploaded positions, one readback of
        the symbols (``_read_symbols``), and the host's C++ rANS coder and
        assembly. The position symbols form one rANS stream, which one lane
        of K3 would code at one dependent step a symbol; the host coder
        does it. Output equals ``encode()``; a guard
        of the chains is counted in ``n_host_attributes``; errors raise."""
        depths, cfg = self._resolve_depths(bits)
        bits = depths["bits"]
        dev = self._dev(device)
        with trace.root("encode_mesh_device", meshes=1) as call:
            key, topo = self._topo_for(mesh)
            with trace.timed("position"):
                pos_att = mesh.position_attribute()
                pos = np.ascontiguousarray(pos_att.values, np.float32)[None]
                dev_c = device_encode_group(pos, topo, pos_att, bits=bits,
                                            device=dev)
                syms = _read_symbols(dev_c["symbols"][0][0], bits)
                _check_counted(dev_c["counts"], syms)
            with trace.timed("chains"):
                pre = _device_extra_attribute_entries(
                    [mesh], [0], topo, **depths, device=dev,
                    q_pos=dev_c["q_dev"]).get(0, {})
            with trace.timed("assembly") as sp:
                carried, ported, host = _chain_counts(mesh, pre)
                self.n_host_attributes += host
                sp.note(carried=carried, ported=ported)
                blob = _assemble_precomputed(mesh, topo, cfg, syms, dev_c,
                                             bits, pre)
                self._dev_cache_touch(key, topo)
        self.timings = _stage_timings(call.totals, single=True)
        return blob

    def encode_mesh_device_chunked(self, mesh, bits: int | None = None,
                                   chunk: int = 1 << 15,
                                   device=None) -> bytes:
        """One mesh streamed through ``device`` (None: the encoder's
        ``device``, else the card; ``"cpu"`` runs the plain twins)
        ``chunk`` rows at a time, so that the device
        holds O(chunk) whatever the mesh: pass 1 takes the float range
        over vertex chunks (padded by repeating a real row), pass 2 the
        range of the quantized values, pass 3 runs traversal segments,
        their rows gathered on the host, through ``encode_step_chunk``
        (quantize, predict, wrapped difference, zigzag, K2) and reads each
        segment's symbols back. The host's C++ rANS coder and the assembly
        follow; the NORMAL and TEX_COORD attributes of this route are
        coded by the host inside the assembly. Output equals
        ``encode()``; errors raise."""
        depths, cfg = self._resolve_depths(bits)
        bits = depths["bits"]
        dev = self._dev(device)
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        with trace.root("encode_mesh_device_chunked", meshes=1) as call:
            _, topo = self._topo_for(mesh)
            with trace.timed("topology"):
                pos_att = mesh.position_attribute()
                pos = np.ascontiguousarray(pos_att.values, dtype=np.float32)
                g = topology_gathers_np(topo, pos_att)
            V, N = pos.shape
            T = len(g["order"])

            def vertex_chunks():
                for c0 in range(0, V, chunk):
                    rows = pos[c0:c0 + chunk]
                    if len(rows) < chunk:  # pad by repeating a real row
                        rows = np.concatenate(
                            [rows, np.broadcast_to(pos[:1],
                                                   (chunk - len(rows), N))])
                    yield torch.from_numpy(rows).to(dev)

            with trace.timed("position"):
                # pass 1: the float range (exact reduces, float32
                # throughout, the zero-seeded range of quantize_kernel)
                lo = torch.full((N,), float("inf"), dtype=torch.float32,
                                device=dev)
                hi = torch.full((N,), float("-inf"), dtype=torch.float32,
                                device=dev)
                for rows in vertex_chunks():
                    mn, mx = minmax_chunk_kernel(rows)
                    lo, hi = torch.minimum(lo, mn), torch.maximum(hi, mx)
                zero = np.float32(0)
                mins = np.minimum(lo.cpu().numpy(), zero).astype(np.float32)
                maxs = np.maximum(hi.cpu().numpy(), zero).astype(np.float32)
                if V and not (np.isfinite(mins).all()
                              and np.isfinite(maxs).all()):
                    raise ValueError("attribute POSITION contains non-finite "
                                     "values (NaN/inf); refusing to quantize")
                delta_max = np.float32(np.max((maxs - mins)
                                              .astype(np.float32)))
                d_mins = torch.from_numpy(mins).to(dev)
                d_delta = torch.from_numpy(np.asarray(delta_max)).to(dev)

                # pass 2: the range of the quantized values
                qlo = torch.full((), np.iinfo(np.int32).max,
                                 dtype=torch.int32, device=dev)
                qhi = torch.full((), np.iinfo(np.int32).min,
                                 dtype=torch.int32, device=dev)
                for rows in vertex_chunks():
                    a, b = quantized_range_chunk_kernel(rows, d_mins, d_delta,
                                                        bits)
                    qlo, qhi = torch.minimum(qlo, a), torch.maximum(qhi, b)
                vmin, vmax = int(qlo), int(qhi)

                # pass 3: traversal segments, rows gathered on the host,
                # each segment's symbols read back before the next
                hist_bins = default_hist_bins(bits)
                counts = torch.zeros(hist_bins, dtype=torch.int64, device=dev)
                sym_parts = []

                def padded(a):  # a segment's rows, zero-padded to chunk
                    r = np.zeros((chunk, *a.shape[1:]), a.dtype)
                    r[:len(a)] = a
                    return torch.from_numpy(r).to(dev)

                for s0 in range(0, T, chunk):
                    seg = slice(s0, min(s0 + chunk, T))
                    sym, cnt = encode_step_chunk(
                        *(padded(pos[g[k][seg]]) for k in (
                            "order", "next", "prev", "opp", "fallback")),
                        *(padded(np.asarray(g[k][seg], bool))
                          for k in ("can_para", "has_fallback")),
                        padded(np.ones(seg.stop - s0, bool)), d_mins,
                        d_delta, vmin, vmax, bits=bits, hist_bins=hist_bins)
                    counts += cnt
                    sym_parts.append(_read_symbols(sym[:seg.stop - s0],
                                                   bits))
                symbols = (np.concatenate(sym_parts) if sym_parts
                           else np.zeros((0, N), np.int32))
                _check_counted([counts], symbols)
            with trace.timed("assembly") as sp:
                carried, ported, _ = _chain_counts(mesh, {})
                sp.note(carried=carried, ported=ported)
                blob = _assemble_precomputed(
                    mesh, topo, cfg, symbols, {"vmin": [vmin], "vmax": [vmax]},
                    bits)
        self.timings = _stage_timings(call.totals, single=True)
        return blob

    def encode_mesh_device_stream_sharded(self, mesh, mesh_axis,
                                          bits: int | None = None) -> bytes:
        """One mesh with its traversal split over the stream axis
        ``mesh_axis`` (``resolve_axis``), the counterpart of tpudraco's
        route of the same name: the host quantizes once (C++), every
        distinct device holds the whole quantized row and the topology's
        gathers, and shard i runs K1 on its segment of the traversal
        against the global residual range, then K2 on that segment
        (``encode_step_stream_sharded``). The segments' histograms are
        summed on the first device and must count every symbol; the
        symbols are read back (uint16 where ``bits + 1 <= 16``) in segment
        order, and the host's C++ rANS coder and the assembly finish the
        mesh. Only the positions take this route: the other attributes are
        coded by the host encoder inside the assembly. Output equals
        ``encode()``; errors raise."""
        depths, cfg = self._resolve_depths(bits)
        bits = depths["bits"]
        axis = resolve_axis(mesh_axis)
        with trace.root("encode_mesh_device_stream_sharded",
                        meshes=1) as call:
            key, topo = self._topo_for(mesh)
            with trace.timed("position"):
                pos_att = mesh.position_attribute()
                pos = np.ascontiguousarray(pos_att.values, np.float32)[None]
                V = pos.shape[1]
                quant = dict(zip(("q", "mins", "delta_max", "vmin", "vmax"),
                                 _host_quantize(pos, bits)))
                # a segment's own tile tables, where K1 tiles
                gathers = [_device_gathers(topo, pos_att, d, V) for d in axis]
                T = gathers[0]["order"].numel()
                parts, counts = encode_step_stream_sharded(
                    quant["q"], gathers, quant["vmin"], quant["vmax"],
                    bits=bits, mesh_axis=axis,
                    tiles=[functools.partial(_device_tiles, topo, pos_att, d,
                                             V, span)
                           for d, span in zip(axis,
                                              shard_bounds(T, len(axis)))])
                symbols = np.concatenate([_read_symbols(p[0], bits)
                                          for p in parts])
                _check_counted([counts], symbols)
            with trace.timed("assembly") as sp:
                carried, ported, _ = _chain_counts(mesh, {})
                sp.note(carried=carried, ported=ported)
                blob = _assemble_precomputed(mesh, topo, cfg, symbols, quant,
                                             bits)
                self._dev_cache_touch(key, topo)
        self.timings = _stage_timings(call.totals, single=True)
        return blob

    def _resident_peak_bytes(self, mesh) -> int:
        """Estimated peak card memory of ``encode_mesh_device`` on
        ``mesh`` at ``self.cfg``'s depths (see RESIDENT_BYTES_PER_VERTEX)."""
        bits = self._resolve_depths()[0]["bits"]
        _, topo = self._topo_for(mesh)
        V = mesh.position_attribute().num_points
        peak = V * self.RESIDENT_BYTES_PER_VERTEX
        for i, a in enumerate(mesh.attributes):
            if a.att_type == AttributeType.TEX_COORD:
                peak += V * self.RESIDENT_UV_BYTES_PER_VERTEX
            elif a.att_type == AttributeType.NORMAL:
                R = ring_width(topo.view_for(i).as_arrays()[1])
                if _normal_chain_fits(R, bits):
                    peak += len(topo.sequences[i]) * (
                        R * RING_TABLE_BYTES_PER_SLOT
                        + self.RESIDENT_NORMAL_BYTES_PER_STEP)
        return peak

    def _encode_huge(self, mesh, device=None) -> bytes:
        """A lone large mesh on ``device``: resident while its estimated
        peak stays within RESIDENT_MAX_BYTES, streamed in chunks beyond.
        Errors raise."""
        if self._resident_peak_bytes(mesh) > self.RESIDENT_MAX_BYTES:
            return self.encode_mesh_device_chunked(mesh, device=device)
        return self.encode_mesh_device(mesh, device=device)

    def _encode_one_safe(self, mesh) -> bytes | None:
        try:
            return self.encode_mesh(mesh)
        except Exception:
            return None

    # ------------------------------------------------------------------
    # the router

    def encode_meshes_auto(self, meshes: list, device=None) -> list:
        """Per topology group, the host plane or the device plane (on
        ``device``; None: the encoder's ``device``, else the card), chosen
        by measuring both in this process on a part of the group; the
        probes' outputs are kept. Both planes give the bytes of
        ``encode()``, so a mix is safe. Static rules come first: a lone
        mesh of CHUNKED_MIN_VERTS << 2 vertices or more takes
        ``_encode_huge`` (unless this process's or the disk's throughput
        estimates for its size class say the host plane is more than twice
        as fast), any other lone mesh and a group of fewer than
        MIN_DEVICE_GROUP small meshes the host plane. A measured decision
        is kept for the topology (in memory, and on disk under the device's
        name) and reused: a device decision for groups at least as large as
        the one it routed, a host decision for groups at most twice as
        large. Decisions go to ``routing_log``. A mesh that fails the input
        check (``_refused_input``) yields None and joins no group, as one
        that the host plane fails to encode does; a failure of a device
        plane raises.

        After the call ``timings`` describes the whole call: the stage
        keys of ``encode_meshes_device`` (``signatures_s`` ...
        ``assembly_s``, ``h2d_mb``) summed over every device-plane call in
        it, probes included, from the totals that its nested roots add to
        its own (a lone huge mesh's route adds its stages too); the host
        plane's seconds in the probes (``route_probe_host_s``), the device
        plane's in the probes (``route_probe_device_s``) and the host
        plane's outside them (``route_host_s``); and the counts
        ``groups``, ``groups_measured`` (probed), ``groups_cached`` (a kept
        decision, in memory or on disk), ``groups_static`` (a lone mesh or
        a small group), ``meshes_device`` and ``meshes_host``. Under a
        torch profiler the call is the root ``encode_meshes_auto``
        (``meshes``, ``groups``): a ``signatures`` span over the grouping,
        then a ``route.group`` span a group (``meshes``, ``verts``,
        ``plane``, ``source``: the decision's, as ``_route_group``
        returns it), with ``route.probe.host`` / ``route.probe.device``
        around the probes and ``route.host`` around the host plane's other
        encodes (``torchdraco.trace``)."""
        axis = self._axis(device)
        dev = axis[0]
        # a decision measured over a shard axis routes that axis only
        self._route_dev_name = _device_name(dev) + (
            f" x{len(axis)}" if self.mesh_axis is not None else "")
        counts = dict.fromkeys(_ROUTE_COUNTS, 0)
        with trace.root("encode_meshes_auto", meshes=len(meshes)) as call:
            with trace.span("signatures"):
                groups: dict[str, list[int]] = {}
                for idx, m in enumerate(meshes):
                    if not _refused_input(m):
                        groups.setdefault(topology_signature(m),
                                          []).append(idx)
            call.note(groups=len(groups))
            out: list[bytes | None] = [None] * len(meshes)
            for sig, idxs in groups.items():
                with trace.span("route.group", meshes=len(idxs)) as span:
                    entry, source = self._route_group(meshes, idxs, sig,
                                                      out, dev, counts)
                    span.note(verts=entry["verts"], plane=entry["plane"],
                              source=source)
                counts[_SOURCE_COUNT[source]] += 1
                self.routing_log.append(entry)
        counts["groups"] = len(groups)
        self.timings = dict(_stage_timings(call.totals), **counts, **{
            key.replace(".", "_") + "_s": call.totals.get(key, 0) * 1e-9
            for key in ("route.probe.host", "route.probe.device",
                        "route.host")})
        return out

    def _route_host(self, meshes, idxs, out, counts) -> None:
        """The host plane on ``idxs``, in a ``route.host`` span."""
        with trace.timed("route.host"):
            for i in idxs:
                out[i] = self._encode_one_safe(meshes[i])
        counts["meshes_host"] += len(idxs)

    def _route_device(self, meshes, idxs, out, dev, counts) -> None:
        """The device plane on ``idxs``."""
        for i, blob in zip(idxs, self._device_plane(
                [meshes[i] for i in idxs], dev)):
            out[i] = blob
        counts["meshes_device"] += len(idxs)

    def _route_group(self, meshes, idxs, sig, out, dev,
                     counts) -> tuple[dict, str]:
        """Routes one group into ``out``, counting its meshes by plane in
        ``counts``; returns its ``routing_log`` entry and the decision's
        source: "static" (a lone mesh), "small" (below MIN_DEVICE_GROUP),
        "memory" or "disk" (a kept decision), "cheaper" (the host probe
        priced the group below PROBE_SKIP_S) or "measured" (both planes
        probed)."""
        n = len(idxs)
        m0 = meshes[idxs[0]]
        v = int(m0.position_attribute().num_points)
        nbytes = int(m0.position_attribute().values.nbytes)
        entry = {"group": sig[:12], "meshes": n, "verts": v}
        if n == 1:
            # a lone mesh cannot be probed without doing the work twice:
            # huge ones take _encode_huge, unless the estimates of their
            # size class say the host plane is more than twice as fast
            huge = v >= (self.CHUNKED_MIN_VERTS << 2)
            reason = "single mesh (static)"
            if huge:
                est_h = self._mbs_estimate("host", v)
                est_d = self._mbs_estimate("huge_device", v)
                if est_h and est_d:
                    if est_h > 2 * est_d:
                        huge = False
                    elif est_d > 2 * est_h:
                        huge = True
                    reason = (f"single mesh (measured: device "
                              f"{est_d:.1f} vs host {est_h:.1f} MB/s)")
            t0 = _clock()
            if huge:
                out[idxs[0]] = self._encode_huge(m0, dev)
                counts["meshes_device"] += 1
            else:
                self._route_host(meshes, idxs, out, counts)
            dt = _clock() - t0
            if out[idxs[0]] is not None and dt > 0:
                self._note_mbs("huge_device" if huge else "host", nbytes,
                               dt, v)
            entry.update(plane="device" if huge else "host", reason=reason)
            return entry, "static"
        if n < self.MIN_DEVICE_GROUP and v < self.CHUNKED_MIN_VERTS:
            self._route_host(meshes, idxs, out, counts)
            entry.update(plane="host", reason="small group")
            return entry, "small"
        cached = self._plane_cache.get(sig)
        source = "memory"
        if cached is None and self._route_cache_path:
            disk = self._route_cache_load().get(self._route_key(sig))
            if disk is not None:
                cached = (disk["plane"], int(disk["n_basis"]))
                source = "disk"
        if cached is not None:
            plane, n_basis = cached
            # the safe direction: a device decision holds for larger
            # groups (the fixed costs spread further), a host one for
            # smaller ones and up to twice the size
            if ((plane == "device" and n >= n_basis)
                    or (plane == "host" and n <= 2 * n_basis)):
                if source == "disk":
                    self._plane_cache[sig] = cached
                if plane == "device":
                    self._route_device(meshes, idxs, out, dev, counts)
                else:
                    self._route_host(meshes, idxs, out, counts)
                entry.update(plane=plane,
                             reason=f"cached decision ({source})")
                return entry, source
        # probe: the host plane on a few meshes (one, if they are large),
        # the device plane on a part of the group
        k = 1 if v >= self.CHUNKED_MIN_VERTS else min(4, n - 1)
        with trace.timed("route.probe.host"):
            t0 = _clock()
            for i in idxs[:k]:
                out[i] = self._encode_one_safe(meshes[i])
            th = (_clock() - t0) / k
        counts["meshes_host"] += k
        self._note_mbs("host", k * nbytes, th * k, v)
        if th * (n - k) < self.PROBE_SKIP_S:
            # the whole group costs the host less than a device probe
            self._route_host(meshes, idxs[k:], out, counts)
            entry.update(plane="host", reason="group cheaper than probe",
                         host_s_per_mesh=round(th, 4))
            self._keep_decision(sig, "host", n, th, None)
            return entry, "cheaper"
        # a quarter of the group, at least PROBE_CHUNK meshes and at most
        # 128: the probe prices how far the device plane's fixed costs
        # spread over a group of this size
        probe_w = min(max(self.PROBE_CHUNK, n // 4), 128, n - k)
        chunk_ids = idxs[k:k + probe_w]
        with trace.timed("route.probe.device"):
            t0 = _clock()  # the call returns bytes on the host: synchronous
            self._route_device(meshes, chunk_ids, out, dev, counts)
            td = (_clock() - t0) / len(chunk_ids)
        rest = idxs[k + probe_w:]
        use_dev = td < th
        if use_dev and rest:
            self._route_device(meshes, rest, out, dev, counts)
        elif rest:
            self._route_host(meshes, rest, out, counts)
        entry.update(plane="device" if use_dev else "host",
                     host_s_per_mesh=round(th, 4),
                     device_s_per_mesh=round(td, 4))
        self._keep_decision(sig, "device" if use_dev else "host", n, th, td)
        return entry, "measured"

    def _keep_decision(self, sig: str, plane: str, n: int, th: float,
                       td: float | None) -> None:
        """Keep a measured decision for the topology, in memory and on
        disk, with the size of the group it routed as its basis."""
        self._plane_cache[sig] = (plane, n)
        self._route_cache_persist(self._route_key(sig), {
            "plane": plane, "n_basis": int(n),
            "host_s_per_mesh": round(th, 5),
            "device_s_per_mesh": None if td is None else round(td, 5),
            "ts": time.time()})

    def _route_key(self, *parts) -> str:
        """A key of the decision cache: a decision measured on one device
        does not route another."""
        return "|".join(str(p) for p in (*parts, self._route_dev_name))

    def _route_cache_load(self) -> dict:
        """Unexpired entries of the decision cache on disk ({} where it is
        off, missing or unreadable)."""
        if self._route_disk is not None:
            return self._route_disk
        self._route_disk = {}
        p = self._route_cache_path
        if p:
            try:
                with open(p) as f:
                    data = json.load(f)
                if isinstance(data, dict) and data.get("v") == 1:
                    now = time.time()
                    self._route_disk = {
                        k: e for k, e in data.get("entries", {}).items()
                        if isinstance(e, dict)
                        and now - float(e.get("ts", 0)) < ROUTE_CACHE_TTL_S}
            except Exception:
                pass
        return self._route_disk

    def _route_cache_persist(self, key: str, entry: dict) -> None:
        """Write one entry into the cache on disk (atomic rename; a failure
        is silent: the cache saves probes, it is never needed)."""
        p = self._route_cache_path
        if not p:
            return
        try:
            entries = dict(self._route_cache_load())
            entries[key] = entry
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            tmp = f"{p}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"v": 1, "entries": entries}, f)
            os.replace(tmp, p)
            self._route_disk = entries
        except Exception:
            pass

    def _note_mbs(self, kind: str, nbytes: int, seconds: float,
                  verts: int) -> None:
        """Add a throughput observation (position bytes over wall seconds)
        to its size class, ``floor(log2(verts))``; persist when the
        class's evidence has doubled. ``kind``: "host" (a host-plane
        encode) or "huge_device" (``_encode_huge``)."""
        cls = _size_class(verts)
        obs = self._mbs_obs.setdefault((kind, cls), [0.0, 0.0, 0.0])
        obs[0] += float(nbytes)
        obs[1] += float(seconds)
        if obs[0] >= 1e6 and obs[1] > 0.05 and obs[0] >= 2 * obs[2]:
            obs[2] = obs[0]
            self._route_cache_persist(
                self._route_key("__mbs__", kind, cls),
                {"mbs": round(obs[0] / obs[1] / 1e6, 2), "ts": time.time()})

    def _mbs_estimate(self, kind: str, verts: int) -> float | None:
        """MB/s of ``kind`` for meshes of the size class of ``verts``:
        this process's observations first, then the disk's record."""
        cls = _size_class(verts)
        obs = self._mbs_obs.get((kind, cls))
        if obs is not None and obs[0] >= 1e6 and obs[1] > 0.05:
            return obs[0] / obs[1] / 1e6
        e = self._route_cache_load().get(self._route_key("__mbs__", kind,
                                                         cls))
        if e and e.get("mbs"):
            return float(e["mbs"])
        return None

    # ------------------------------------------------------------------
    # the corpus

    def encode_corpus(self, inputs: list[str], out_dir: str,
                      resume: bool = True, workers: int = 1,
                      device_window: int | None = None) -> dict:
        """Encode mesh files (.obj, .ply, .gltf, .glb) into ``out_dir`` as
        ``<basename>.drc``, on the plane ``use_device`` names, with resume
        (an existing output is skipped) and per-file error isolation (a
        file that fails is reported in ``failed``). On the device planes
        the inputs are loaded ``device_window`` meshes at a time (default
        DEVICE_CORPUS_WINDOW) and each window is encoded before the files
        are written; the bytes do not depend on the window. ``workers`` > 1
        loads the windows and writes (and host-encodes) files on a thread
        pool; only the calling thread touches the device. A ``cfg`` beyond
        the device planes' quantization depths takes the host plane
        (``device_disabled_by_cfg`` in the report). A device failure
        raises. Writes and returns the report (``corpus_report.json``); its
        ``stages_s`` splits the wall into loading and encoding the device
        windows and the per-file pass."""
        from ..io import load_mesh

        dev_plane = (self.use_device
                     and _device_quant_bits(self.cfg) is not None)
        dev = self._dev(None) if dev_plane else None
        os.makedirs(out_dir, exist_ok=True)
        report = {"encoded": 0, "skipped": 0, "failed": [],
                  "total_in_bytes": 0, "total_out_bytes": 0}
        t0 = time.perf_counter()

        def out_path_for(path):
            name = os.path.splitext(os.path.basename(path))[0] + ".drc"
            return os.path.join(out_dir, name)

        inputs, name_collisions = _drop_output_collisions(inputs,
                                                          out_path_for)
        for path in name_collisions:
            report["failed"].append(
                {"path": path, "error": "output name collision"})

        def load(path):
            try:
                return load_mesh(path)
            except Exception:
                return None  # the per-file pass below reports it

        def one(path):
            out_path = out_path_for(path)
            if resume and os.path.isfile(out_path):
                return ("skipped", path, 0, 0)
            try:
                blob = device_blobs.get(path)
                if blob is None:
                    blob = self.encode_mesh(load_mesh(path))
                tmp = out_path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, out_path)
                return ("encoded", path, os.path.getsize(path), len(blob))
            except Exception as e:  # per-file isolation
                return ("failed", path, repr(e), 0)

        device_blobs: dict[str, bytes | None] = {}
        stages = {"load_s": 0.0, "device_s": 0.0}
        if self.use_device and not dev_plane:
            report["device_disabled_by_cfg"] = True
        pool = ThreadPoolExecutor(max_workers=workers) if workers > 1 else None
        each = pool.map if pool is not None else map
        try:
            if dev_plane:
                # load W meshes, encode them by topology group, keep only
                # the blobs; inputs whose outputs exist are not loaded
                W = device_window or self.DEVICE_CORPUS_WINDOW
                pending = [p for p in inputs if not (
                    resume and os.path.isfile(out_path_for(p)))]
                for w0 in range(0, len(pending), W):
                    t1 = time.perf_counter()
                    window = pending[w0:w0 + W]
                    loaded = [(p, m) for p, m in zip(window,
                                                     each(load, window))
                              if m is not None]
                    t2 = time.perf_counter()
                    stages["load_s"] += t2 - t1
                    if not loaded:
                        continue
                    paths, meshes = zip(*loaded)
                    blobs = (self.encode_meshes_auto(list(meshes), device=dev)
                             if self.use_device == "auto"
                             else self._device_plane(list(meshes), dev))
                    device_blobs.update(zip(paths, blobs))
                    stages["device_s"] += time.perf_counter() - t2
            t1 = time.perf_counter()
            results = list(each(one, inputs))
            stages["files_s"] = time.perf_counter() - t1
        finally:
            if pool is not None:
                pool.shutdown()

        for status, path, a, b in results:
            if status == "encoded":
                report["encoded"] += 1
                report["total_in_bytes"] += a
                report["total_out_bytes"] += b
            elif status == "skipped":
                report["skipped"] += 1
            else:
                report["failed"].append({"path": path, "error": a})
        report["seconds"] = round(time.perf_counter() - t0, 3)
        # where the seconds went: loading and encoding the device windows,
        # then the per-file pass (writes, and host encodes)
        report["stages_s"] = {k: round(v, 3) for k, v in stages.items()}
        if self.use_device == "auto":
            report["routing"] = self.routing_log
        tmp_rep = os.path.join(out_dir,
                               f"corpus_report.json.tmp{os.getpid()}")
        with open(tmp_rep, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp_rep, os.path.join(out_dir, "corpus_report.json"))
        return report


# the router's clock (a test replaces it)
_clock = time.perf_counter

# a decision or estimate on disk older than this is measured again: the
# host's speed drifts over hours
ROUTE_CACHE_TTL_S = 6 * 3600.0


# encode_meshes_auto's counts, and the count that each source of a
# decision adds to
_ROUTE_COUNTS = ("groups", "groups_measured", "groups_cached",
                 "groups_static", "meshes_device", "meshes_host")
_SOURCE_COUNT = {"static": "groups_static", "small": "groups_static",
                 "memory": "groups_cached", "disk": "groups_cached",
                 "cheaper": "groups_measured", "measured": "groups_measured"}


def _route_cache_default_path() -> str | None:
    """TORCHDRACO_ROUTE_CACHE: a path, or "" / "0" for no cache on disk;
    unset: ``route_cache.json`` under ``$XDG_CACHE_HOME/torchdraco`` (or
    ``~/.cache/torchdraco``)."""
    p = os.environ.get("TORCHDRACO_ROUTE_CACHE")
    if p is not None:
        return None if p in ("", "0") else p
    root = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(root, "torchdraco", "route_cache.json")


def _size_class(verts: int) -> int:
    """floor(log2(verts)): the estimates of the lone-mesh rule are kept
    apart by it, so small meshes do not price a large one."""
    return max(int(verts), 1).bit_length() - 1


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

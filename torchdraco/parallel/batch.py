"""Mesh encoding on one device: batches that share a topology, and one
large mesh on its own.

Counterpart of ``tpudraco/parallel/batch.py``. The batch path
(``encode_meshes_device``): meshes are grouped by topology; per group the
host runs the connectivity pass once and quantizes every mesh (the
canonical formula, C++), the quantized values go to the device as uint16,
the fused step (K1, K2) and the multi-lane rANS coder (K3) run there for
the position attribute, the NORMAL and TEX_COORD attributes run their
chains (ops/normals.py, ops/texcoords.py) on the same uploaded positions,
and the host assembles each ``.drc`` from the cached connectivity bytes
and the device's payloads.

The single-mesh routes: ``encode_mesh`` / ``encode_meshes`` (the host
plane, with the topology cache), ``encode_mesh_device`` (resident: the
batch path's step at B = 1, one symbol readback, the host's C++ rANS
coder), ``encode_mesh_device_chunked`` (streaming: O(chunk) rows on the
device, three passes) and ``_encode_huge``, which picks between the two by
size. Output bytes are identical to the per-mesh host ``encode()`` of
``torchdraco.encode`` on every route.

The host helpers (``PreparedTopology`` ... ``quantize_positions_host``) are
carried over from ``tpudraco/parallel/batch.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..encode import (
    Config, _traversal_wire_id, encode_header, encode_metadata,
)
from ..encode.attribute import encode_attributes
from ..encode.connectivity import EdgebreakerEncoder
from ..entropy.symbol_coding import DIRECT_CODED, encode_symbols
from ..models import AttributeType, TableView
from ..native import topo as native_topo
from ..ops.gathers import build_parallelogram_gathers
from ..ops.device import (
    default_hist_bins, encode_step_chunk, encode_step_from_q_cuda,
    minmax_chunk_kernel, quantized_range_chunk_kernel,
)
from ..ops.normals import (
    RING_BYTES_PER_SLOT, collect_normal_rings, normal_encode_chain,
    rings_to_torch,
)
from ..ops.rans_lanes import encode_group_entropy_device
from ..ops.texcoords import (
    collect_uv_gathers, uv_encode_chain, uv_gathers_to_torch,
)
from ..shared.prediction import (
    ring_width, write_normal_flips, write_tex_orientations,
)
from ..shared.sequencer import compute_sequence
from ..wire.byte_io import ByteWriter


class PreparedTopology:
    """Reusable connectivity state for meshes sharing one topology: the
    connectivity byte blob, the corner tables, per-attribute traversal
    sequences, the per-device gather tensors of the fused step, and the
    normal rings and UV gathers of the attribute chains. ``traversal`` and
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
        position gathers and the chains' tables)."""
        return sum(t.numel() * t.element_size()
                   for tables in (*self.dev_gathers.values(),
                                  *self.dev_chain_tables.values())
                   for t in tables.values())

    def drop_device_tables(self) -> None:
        self.dev_gathers.clear()
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


def _host_quantize(batch: np.ndarray, bits: int):
    """Quantize a (B, V, C) float32 batch on the host (C++, the canonical
    formula; numpy where the native library is missing or the depth passes
    16 bits, and for non-finite input, which raises there). Returns (q,
    mins, delta_max, vmin, vmax): q uint16 up to 16 bits, int32 past it."""
    got = native.quantize_batch(batch, bits) if bits <= 16 else None
    if got is not None:
        return got
    q, mins, delta_max = quantize_positions_host(batch, bits)
    vmin = q.min(axis=(1, 2)).astype(np.int32)
    vmax = q.max(axis=(1, 2)).astype(np.int32)
    return (q.astype(np.uint16) if bits <= 16 else q, mins, delta_max,
            vmin, vmax)


def device_encode_group(positions_batch: np.ndarray, topo: PreparedTopology,
                        pos_att, bits: int = 11, device=None) -> dict:
    """The fused step for a (B, V, C) float32 batch sharing ``topo``:
    quantize on the host (C++, the canonical formula), upload uint16
    (int32 past 16 bits), run K1 and K2 on ``device`` (None: the card;
    ``"cpu"`` runs their plain twins). Returns symbols and
    counts on the device, plus vmin/vmax, mins, delta_max and the quantized
    values on the host (``q``) and as uploaded (``q_dev``)."""
    dev = resolve(device)
    B, V, C = positions_batch.shape
    gathers = _device_gathers(topo, pos_att, dev, V)
    q_np, mins, delta_max, vmin, vmax = _host_quantize(positions_batch, bits)
    q_dev = torch.from_numpy(q_np).to(dev)
    vmin_dev = torch.from_numpy(np.asarray(vmin, np.int32)).to(dev)
    vmax_dev = torch.from_numpy(np.asarray(vmax, np.int32)).to(dev)
    symbols, counts = encode_step_from_q_cuda(q_dev, gathers, vmin_dev,
                                              vmax_dev, bits=bits)
    return {"symbols": symbols, "counts": counts, "vmin": vmin,
            "vmax": vmax, "mins": mins, "delta_max": delta_max, "q": q_np,
            "q_dev": q_dev}


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
    w = ByteWriter()
    encode_symbols(symbols.astype(np.uint64).ravel(), 2, DIRECT_CODED, w)
    return w.getvalue()


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
                                    q_pos=None) -> dict:
    """Device-encode the NORMAL (ops/normals.py) and TEX_COORD
    (ops/texcoords.py) attributes of one chunk ``idxs`` of a topology
    group, on ``device`` (None: the card). ``q_pos`` is the chunk's
    quantized positions as already uploaded (``device_encode_group``'s
    ``q_dev``); without it they are quantized and uploaded here, once, and
    feed every chain. Returns
    {position-in-idxs: {att_idx: {"payload", "xform_meta"}}}; ineligible
    attributes (or individual "risky"/degenerate meshes) are simply
    absent and take the host path in the assembly. An error inside a chain
    raises."""
    dev = resolve(device)
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
        q_pos = torch.from_numpy(
            _host_quantize(stacked(pos_idx), bits)[0]).to(dev)
    uo_pos = torch.from_numpy(
        pos_att0.unique_indices().astype(np.int64)).to(dev)
    n = len(idxs)

    for ni in normal_idxs:
        rings = topo.dev_rings_for(ni, dev)
        uo_nrm = torch.from_numpy(
            mesh0.attributes[ni].unique_indices().astype(np.int64)).to(dev)
        nrm = torch.from_numpy(stacked(ni)).to(dev)
        s, f = normal_encode_chain(
            q_pos, nrm, rings["tip_pt"], rings["next_pt"], rings["prev_pt"],
            rings["mask"], uo_pos, uo_nrm, bits=normal_bits)
        syms, flips = s.cpu().numpy(), f.cpu().numpy()
        n_mx = (1 << normal_bits) - 1
        for k in range(n):
            if not nrm_ok[ni][k]:
                continue
            xw = ByteWriter()
            xw.write_u32(n_mx)
            xw.write_u32(n_mx // 2)
            write_normal_flips(flips[k].tolist(), xw)
            out.setdefault(k, {})[ni] = {
                "payload": _direct_coded_payload(syms[k]),
                "xform_meta": bytes(xw.getvalue())}
    for ui in uv_idxs:
        q_uv = torch.from_numpy(
            _host_quantize(uv_batches[ui], uv_bits)[0]).to(dev)
        syms, vmin, vmax, ovals, oflags, risky = uv_encode_chain(
            q_pos, q_uv,
            topo.dev_uv_gathers_for(ui, pos_att0.num_points, dev), uo_pos,
            mesh0.attributes[ui].unique_indices(), device=dev)
        for k in range(n):
            if risky[k]:
                continue  # host path handles this mesh's UVs exactly
            xw = ByteWriter()
            write_tex_orientations(ovals[k][oflags[k]].tolist(), xw)
            xw.write_u32(int(vmin[k]) & 0xFFFFFFFF)
            xw.write_u32(int(vmax[k]) & 0xFFFFFFFF)
            out.setdefault(k, {})[ui] = {
                "payload": _direct_coded_payload(syms[k]),
                "xform_meta": bytes(xw.getvalue())}
    return out


class BatchEncoder:
    """Encodes meshes with topology-group batching, the POSITION, NORMAL
    and TEX_COORD attributes on the device, and single meshes through the
    host plane or the single-mesh device routes. The device paths take a
    ``cfg`` that differs from the default Config only in quantization
    depths; ``encode_mesh`` takes any. ``n_host_attributes`` counts the
    NORMAL and TEX_COORD attributes that a guard of the device chains sent
    to the host encoder (per mesh and attribute); ``timings`` holds the
    host seconds of the last device call by stage (``position_s``: the
    quantize, upload, fused step and rANS coder of the position attribute;
    ``chains_s``: the NORMAL and TEX_COORD chains with their readback and
    host payloads; the chunked route's ``pass1_s`` ... ``pass3_s``)."""

    # meshes per device call: the group's lanes run in one K3 launch
    DEVICE_CHUNK = 512
    # Card memory for the tables that topologies keep resident (position
    # gathers, normal rings, UV gathers), least recently used dropped
    # first. They cost 169 B a vertex with normals and UVs (int64 ring
    # indices, ring width 6) and 22 B with positions alone, so 8 GiB keeps
    # some 48 topologies of 1M vertices, or 12,000 of 64 x 64, and leaves
    # 71 GB of an 80 GB card to the working set: a 512-mesh chunk peaks at
    # 1.7 GB, a resident mesh at most RESIDENT_MAX_BYTES.
    DEV_CACHE_BUDGET = 8 << 30
    # a lone mesh of CHUNKED_MIN_VERTS << 2 vertices or more is "huge": the
    # router (not ported yet) sends it to _encode_huge
    CHUNKED_MIN_VERTS = 1 << 17
    # _encode_huge keeps a mesh resident while the resident route's
    # estimated peak (_resident_peak_bytes) stays within RESIDENT_MAX_BYTES,
    # and streams it in chunks beyond: half of an 80 GB card, beside
    # DEV_CACHE_BUDGET and the allocator's cache.
    RESIDENT_MAX_BYTES = 40 << 30
    # The estimate's terms, above the first-call peaks that chip_smoke.py
    # phase 12.3 measures (NVIDIA H100 80GB HBM3, 700 W): positions,
    # gathers and symbols cost RESIDENT_BYTES_PER_VERTEX (46 B a vertex on
    # a 1024^2 grid); each TEX_COORD attribute RESIDENT_UV_BYTES_PER_VERTEX
    # (712 B with positions on a 512^2 grid); each NORMAL attribute that
    # the device chain takes RING_BYTES_PER_SLOT for each of its T x R ring
    # slots (int64 ring tensors at B = 1, which the chain cannot split; R
    # is the most corners on one vertex, so one fan or pole vertex sets
    # it): 155 B a slot on a 512^2 grid with a fan vertex of valence 80,
    # 3.25 GB, 12.4 KB a vertex, where the plain 1024^2 grid (R = 6) with
    # normals and UVs peaks at 1.10 GB, 1,051 B a vertex. The chains run
    # one after the other, so the sum overestimates: by 1.17-1.89x on
    # those four meshes.
    RESIDENT_BYTES_PER_VERTEX = 64
    RESIDENT_UV_BYTES_PER_VERTEX = 768

    def __init__(self, cfg=None) -> None:
        self.cfg = cfg
        self.n_host_attributes = 0
        # host seconds of the last device call, by stage
        self.timings: dict = {}
        # topology signature (with the traversal and single-connectivity
        # knobs when a cfg sets them) -> PreparedTopology
        self._topo_cache: dict = {}
        # LRU of topologies holding device tables, most recent last
        self._dev_cache: dict = {}

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
        """Per topology group, the fused step and the rANS coder of the
        position attribute and the NORMAL and TEX_COORD chains run on
        ``device`` (None: the card; ``"cpu"`` runs the kernels' plain
        twins) in chunks of DEVICE_CHUNK meshes; the host assembles the
        bytes. Output equals sequential encode(). ``bits``/``normal_bits``/
        ``uv_bits`` are the -qp/-qn/-qt depths; unset depths come from
        ``self.cfg``. An attribute or mesh that a chain's guard refuses
        (a zero or non-finite normal, a "risky" UV row, non-finite UVs, a
        type or parent the chains do not take) is coded by the host
        encoder inside the assembly, same bytes, and counted in
        ``n_host_attributes``. Errors raise; there is no host fallback."""
        if entropy != "device":
            raise ValueError(f"entropy={entropy!r}: only the device rANS "
                             "coder is ported")
        dev = resolve(device)
        dflt = _device_quant_bits(self.cfg)
        if dflt is None:
            raise ValueError(
                "BatchEncoder.cfg goes beyond the device batch's config "
                "space (quantization depths only)")
        bits = dflt["bits"] if bits is None else bits
        normal_bits = (dflt["normal_bits"] if normal_bits is None
                       else normal_bits)
        uv_bits = dflt["uv_bits"] if uv_bits is None else uv_bits
        if not _depths_in_range(bits, normal_bits, uv_bits):
            raise ValueError(
                f"quantization depths out of range (position {bits}, "
                f"normal {normal_bits} [7..16], texcoord {uv_bits})")
        cfg = _merged_quant_cfg(self.cfg, bits, normal_bits, uv_bits)

        t = self.timings = dict.fromkeys(
            ("signatures_s", "topology_s", "position_s", "chains_s",
             "assembly_s"), 0.0)
        clock = time.perf_counter
        t0 = clock()
        groups: dict[str, list[int]] = {}
        for idx, m in enumerate(meshes):
            groups.setdefault(topology_signature(m), []).append(idx)
        t["signatures_s"] = clock() - t0
        out: list[bytes | None] = [None] * len(meshes)
        bits_byte = bytes([bits])
        for sig, idxs in groups.items():
            t0 = clock()
            topo = self._topo_cache.get(sig)
            if topo is None:
                topo = PreparedTopology(meshes[idxs[0]])
                self._topo_cache[sig] = topo
            t["topology_s"] += clock() - t0
            pos_att0 = meshes[idxs[0]].position_attribute()
            batch = np.stack([meshes[i].position_attribute().values
                              .astype(np.float32) for i in idxs])
            for c0 in range(0, len(idxs), self.DEVICE_CHUNK):
                chunk = idxs[c0:c0 + self.DEVICE_CHUNK]
                t0 = clock()
                dev_c = device_encode_group(
                    batch[c0:c0 + self.DEVICE_CHUNK], topo, pos_att0,
                    bits=bits, device=dev)
                payloads = encode_group_entropy_device(dev_c["symbols"],
                                                       dev_c["counts"])
                t1 = clock()
                # the NORMAL and TEX_COORD chains read the positions the
                # fused step uploaded: quantized once, uploaded once
                extra = _device_extra_attribute_entries(
                    meshes, chunk, topo, bits=bits, normal_bits=normal_bits,
                    uv_bits=uv_bits, device=dev, q_pos=dev_c["q_dev"])
                t2 = clock()
                for k, i in enumerate(chunk):
                    w = ByteWriter()
                    w.write_u32(int(dev_c["vmin"][k]) & 0xFFFFFFFF)
                    w.write_u32(int(dev_c["vmax"][k]) & 0xFFFFFFFF)
                    pos_idx = next(
                        j for j, a in enumerate(meshes[i].attributes)
                        if a.att_type == AttributeType.POSITION)
                    # quantization already ran on the host: hand the
                    # assembly its metadata bytes and values, so it does
                    # not re-quantize the mesh
                    port_meta = (dev_c["mins"][k].astype("<f4").tobytes()
                                 + dev_c["delta_max"][k:k + 1]
                                 .astype("<f4").tobytes() + bits_byte)
                    pre = {pos_idx: {"payload": payloads[k],
                                     "xform_meta": bytes(w.getvalue()),
                                     "port_meta": port_meta,
                                     "port_values": dev_c["q"][k]}}
                    pre.update(extra.get(k, {}))
                    self.n_host_attributes += sum(
                        1 for j, a in enumerate(meshes[i].attributes)
                        if a.att_type in _CHAIN_TYPES and j not in pre)
                    out[i] = encode_with_topology(meshes[i], topo, cfg=cfg,
                                                  precomputed=pre)
                t["position_s"] += t1 - t0
                t["chains_s"] += t2 - t1
                t["assembly_s"] += clock() - t2
            self._dev_cache_touch(sig, topo)
        return out

    # ------------------------------------------------------------------
    # one large mesh

    def _topo_for(self, mesh):
        """(cache key, PreparedTopology) of ``mesh`` under the device
        routes' connectivity (the default: their cfg holds depths only)."""
        key = topology_signature(mesh)
        topo = self._topo_cache.get(key)
        if topo is None:
            topo = self._topo_cache[key] = PreparedTopology(mesh)
        return key, topo

    def _resolve_depths(self, bits: int | None) -> dict:
        """The single-mesh device routes' depths: ``bits`` (-qp) when given,
        the rest from ``self.cfg``, which must hold quantization depths
        only (other overrides cannot ride the precomputed positions)."""
        dflt = _device_quant_bits(self.cfg)
        if dflt is None:
            raise ValueError(
                "BatchEncoder.cfg goes beyond the device routes' config "
                "space (quantization depths only); encode this mesh with "
                "encode_mesh instead")
        if bits is not None:
            dflt["bits"] = bits
        if not _depths_in_range(**dflt):
            raise ValueError(f"quantization depths out of range {dflt}")
        return dflt

    def _assemble_precomputed(self, mesh, topo: PreparedTopology,
                              symbols: np.ndarray, vmin: int, vmax: int,
                              bits: int, extra_pre: dict | None = None,
                              port: dict | None = None) -> bytes:
        """The .drc of one mesh from its position symbols (T, C) and
        residual range: the host's C++ rANS coder (DIRECT_CODED) codes the
        symbols, ``extra_pre`` adds device entries of other attributes,
        ``port`` (``port_meta``, ``port_values``) the host quantize's
        result, which the assembly then does not redo. Attributes without
        an entry are coded by the host encoder inside the assembly, at
        ``self.cfg``'s depths."""
        w = ByteWriter()
        encode_symbols(symbols.astype(np.uint64).ravel(), symbols.shape[-1],
                       DIRECT_CODED, w)
        meta = ByteWriter()
        meta.write_u32(int(vmin) & 0xFFFFFFFF)
        meta.write_u32(int(vmax) & 0xFFFFFFFF)
        pos_idx = next(j for j, a in enumerate(mesh.attributes)
                       if a.att_type == AttributeType.POSITION)
        dflt = self._resolve_depths(bits)
        cfg = _merged_quant_cfg(self.cfg, bits, dflt["normal_bits"],
                                dflt["uv_bits"])
        pre = {pos_idx: {"payload": w.getvalue(),
                         "xform_meta": bytes(meta.getvalue()), **(port or {})}}
        pre.update(extra_pre or {})
        return encode_with_topology(mesh, topo, cfg=cfg, precomputed=pre)

    def encode_mesh_device(self, mesh, bits: int | None = None,
                           device=None) -> bytes:
        """One mesh with its positions and gathers resident on ``device``
        (None: the card; ``"cpu"`` runs the kernels' plain twins): the host
        C++ quantize, one uint16 upload, K1 and K2 at B = 1, the NORMAL and
        TEX_COORD chains on the same uploaded positions, one readback of
        the symbols (uint16 where ``bits + 1 <= 16``), and the host's C++
        rANS coder and assembly. The position symbols form one rANS
        stream, which one lane of K3 would code at one dependent step a
        symbol; the host coder does it. Output equals ``encode()``; a guard
        of the chains is counted in ``n_host_attributes``; errors raise."""
        depths = self._resolve_depths(bits)
        bits = depths["bits"]
        dev = resolve(device)
        t = self.timings = dict.fromkeys(
            ("topology_s", "position_s", "chains_s", "assembly_s"), 0.0)
        clock = time.perf_counter
        t0 = clock()
        key, topo = self._topo_for(mesh)
        pos_att = mesh.position_attribute()
        pos = np.ascontiguousarray(pos_att.values, np.float32)[None]
        t1 = clock()
        dev_c = device_encode_group(pos, topo, pos_att, bits=bits,
                                    device=dev)
        syms = dev_c["symbols"][0]
        if bits + 1 <= 16:  # zigzag symbols < 2^(bits+1): half the bytes
            syms = syms.to(torch.uint16)
        n_counted = int(dev_c["counts"].sum())
        syms = syms.cpu().numpy()
        if n_counted != syms.size:
            raise RuntimeError(f"histogram lost symbols: {n_counted} of "
                               f"{syms.size} counted")
        t2 = clock()
        extra = _device_extra_attribute_entries(
            [mesh], [0], topo, bits=bits, normal_bits=depths["normal_bits"],
            uv_bits=depths["uv_bits"], device=dev, q_pos=dev_c["q_dev"])
        pre = extra.get(0, {})
        self.n_host_attributes += sum(
            1 for j, a in enumerate(mesh.attributes)
            if a.att_type in _CHAIN_TYPES and j not in pre)
        t3 = clock()
        port = {"port_meta": dev_c["mins"][0].astype("<f4").tobytes()
                + dev_c["delta_max"][:1].astype("<f4").tobytes()
                + bytes([bits]),
                "port_values": dev_c["q"][0]}
        blob = self._assemble_precomputed(
            mesh, topo, syms, int(dev_c["vmin"][0]), int(dev_c["vmax"][0]),
            bits, extra_pre=pre, port=port)
        self._dev_cache_touch(key, topo)
        t.update(topology_s=t1 - t0, position_s=t2 - t1, chains_s=t3 - t2,
                 assembly_s=clock() - t3)
        return blob

    def encode_mesh_device_chunked(self, mesh, bits: int | None = None,
                                   chunk: int = 1 << 15,
                                   device=None) -> bytes:
        """One mesh streamed through ``device`` (None: the card; ``"cpu"``
        runs the plain twins) ``chunk`` rows at a time, so that the device
        holds O(chunk) whatever the mesh: pass 1 takes the float range
        over vertex chunks (padded by repeating a real row), pass 2 the
        range of the quantized values, pass 3 runs traversal segments,
        their rows gathered on the host, through ``encode_step_chunk``
        (quantize, predict, wrapped difference, zigzag, K2) and reads each
        segment's symbols back. The host's C++ rANS coder and the assembly
        follow; the NORMAL and TEX_COORD attributes of this route are
        coded by the host inside the assembly. Output equals
        ``encode()``; errors raise."""
        bits = self._resolve_depths(bits)["bits"]
        dev = resolve(device)
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        clock = time.perf_counter
        t = self.timings = {}
        t0 = clock()
        _, topo = self._topo_for(mesh)
        pos_att = mesh.position_attribute()
        pos = np.ascontiguousarray(pos_att.values, dtype=np.float32)
        g = topology_gathers_np(topo, pos_att)
        V, N = pos.shape
        T = len(g["order"])
        t1 = clock()
        t["topology_s"] = t1 - t0

        def vertex_chunks():
            for c0 in range(0, V, chunk):
                rows = pos[c0:c0 + chunk]
                if len(rows) < chunk:  # pad by repeating a real row
                    rows = np.concatenate(
                        [rows, np.broadcast_to(pos[:1],
                                               (chunk - len(rows), N))])
                yield torch.from_numpy(rows).to(dev)

        # pass 1: the float range (exact reduces, float32 throughout, the
        # zero-seeded range of quantize_kernel)
        lo = torch.full((N,), float("inf"), dtype=torch.float32, device=dev)
        hi = torch.full((N,), float("-inf"), dtype=torch.float32,
                        device=dev)
        for rows in vertex_chunks():
            mn, mx = minmax_chunk_kernel(rows)
            lo, hi = torch.minimum(lo, mn), torch.maximum(hi, mx)
        zero = np.float32(0)
        mins = np.minimum(lo.cpu().numpy(), zero).astype(np.float32)
        maxs = np.maximum(hi.cpu().numpy(), zero).astype(np.float32)
        if V and not (np.isfinite(mins).all() and np.isfinite(maxs).all()):
            raise ValueError("attribute POSITION contains non-finite values "
                             "(NaN/inf); refusing to quantize")
        delta_max = np.float32(np.max((maxs - mins).astype(np.float32)))
        d_mins = torch.from_numpy(mins).to(dev)
        d_delta = torch.from_numpy(np.asarray(delta_max)).to(dev)
        t2 = clock()

        # pass 2: the range of the quantized values
        qlo = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32,
                         device=dev)
        qhi = torch.full((), np.iinfo(np.int32).min, dtype=torch.int32,
                         device=dev)
        for rows in vertex_chunks():
            a, b = quantized_range_chunk_kernel(rows, d_mins, d_delta, bits)
            qlo, qhi = torch.minimum(qlo, a), torch.maximum(qhi, b)
        vmin, vmax = int(qlo), int(qhi)
        t3 = clock()

        # pass 3: traversal segments, rows gathered on the host
        hist_bins = default_hist_bins(bits)
        counts = torch.zeros(hist_bins, dtype=torch.int64, device=dev)
        masks = {k: np.asarray(g[k], bool) for k in ("can_para",
                                                     "has_fallback")}
        sym_parts = []
        for s0 in range(0, T, chunk):
            s1 = min(s0 + chunk, T)
            n_valid = s1 - s0

            def rows_of(idx):
                r = np.zeros((chunk, N), np.float32)
                r[:n_valid] = pos[idx[s0:s1]]
                return torch.from_numpy(r).to(dev)

            def mask_of(m):
                r = np.zeros(chunk, bool)
                r[:n_valid] = m[s0:s1]
                return torch.from_numpy(r).to(dev)

            active = np.zeros(chunk, bool)
            active[:n_valid] = True
            sym, cnt = encode_step_chunk(
                *(rows_of(g[k]) for k in ("order", "next", "prev", "opp",
                                          "fallback")),
                mask_of(masks["can_para"]), mask_of(masks["has_fallback"]),
                torch.from_numpy(active).to(dev), d_mins, d_delta, vmin,
                vmax, bits=bits, hist_bins=hist_bins)
            counts += cnt
            if bits + 1 <= 16:
                sym = sym.to(torch.uint16)
            sym_parts.append(sym[:n_valid].cpu().numpy())
        symbols = (np.concatenate(sym_parts) if sym_parts
                   else np.zeros((0, N), np.int32))
        n_counted = int(counts.sum())
        if n_counted != T * N:
            raise RuntimeError(f"chunked histogram lost symbols: "
                               f"{n_counted} of {T * N} counted")
        t4 = clock()
        blob = self._assemble_precomputed(mesh, topo, symbols, vmin, vmax,
                                          bits)
        t.update(pass1_s=t2 - t1, pass2_s=t3 - t2, pass3_s=t4 - t3,
                 assembly_s=clock() - t4)
        return blob

    def _resident_peak_bytes(self, mesh) -> int:
        """Estimated peak card memory of ``encode_mesh_device`` on
        ``mesh`` at ``self.cfg``'s depths (see RESIDENT_BYTES_PER_VERTEX)."""
        bits = self._resolve_depths(None)["bits"]
        _, topo = self._topo_for(mesh)
        V = mesh.position_attribute().num_points
        peak = V * self.RESIDENT_BYTES_PER_VERTEX
        for i, a in enumerate(mesh.attributes):
            if a.att_type == AttributeType.TEX_COORD:
                peak += V * self.RESIDENT_UV_BYTES_PER_VERTEX
            elif a.att_type == AttributeType.NORMAL:
                R = ring_width(topo.view_for(i).as_arrays()[1])
                if _normal_chain_fits(R, bits):
                    peak += len(topo.sequences[i]) * R * RING_BYTES_PER_SLOT
        return peak

    def _encode_huge(self, mesh, device=None) -> bytes:
        """A lone large mesh on ``device``: resident while its estimated
        peak stays within RESIDENT_MAX_BYTES, streamed in chunks beyond.
        Errors raise."""
        if self._resident_peak_bytes(mesh) > self.RESIDENT_MAX_BYTES:
            return self.encode_mesh_device_chunked(mesh, device=device)
        return self.encode_mesh_device(mesh, device=device)

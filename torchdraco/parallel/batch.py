"""Batch encoding of meshes that share one topology, on one device.

Counterpart of the position path of ``tpudraco/parallel/batch.py``: meshes
are grouped by topology; per group the host runs the connectivity pass once
and quantizes every mesh (the canonical formula, C++), the quantized values
go to the device as uint16, the fused step (K1, K2) and the multi-lane rANS
coder (K3) run there, and the host assembles each ``.drc`` from the cached
connectivity bytes and the device's payload. Output bytes are identical to
the per-mesh host ``encode()`` of ``torchdraco.encode``.

The host helpers (``PreparedTopology`` ... ``quantize_positions_host``) are
carried over from ``tpudraco/parallel/batch.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..encode import (
    Config, _traversal_wire_id, encode_header, encode_metadata,
)
from ..encode.attribute import encode_attributes
from ..encode.connectivity import EdgebreakerEncoder
from ..models import AttributeType, TableView
from ..native import topo as native_topo
from ..ops.gathers import build_parallelogram_gathers
from ..ops.device import encode_step_from_q_cuda
from ..ops.rans_lanes import encode_group_entropy_device
from ..shared.sequencer import compute_sequence
from ..wire.byte_io import ByteWriter


class PreparedTopology:
    """Reusable connectivity state for meshes sharing one topology: the
    connectivity byte blob, the corner tables, per-attribute traversal
    sequences, and the per-device gather tensors of the fused step."""

    def __init__(self, mesh) -> None:
        w = ByteWriter()
        eb = EdgebreakerEncoder(mesh.faces, mesh.attributes)
        self.conn_out = eb.encode(w)
        self.conn_bytes = w.getvalue()
        self.sequences: dict[int, list[int]] = {}
        # per-attribute parallelogram gathers of the host assembly, keyed
        # like tpudraco's: every mesh of this topology reuses them
        self.pred_gathers: dict[int, dict] = {}
        # str(device) -> gather tensors of the position attribute
        self.dev_gathers: dict[str, dict] = {}
        for i in range(len(mesh.attributes)):
            self.sequences[i] = compute_sequence(
                self.view_for(i), list(self.conn_out.corners_of_edgebreaker))

    def view_for(self, i: int):
        aict = self.conn_out.corner_table
        att_table = None
        if 0 < i <= len(aict.attribute_tables):
            att_table = aict.attribute_tables[i - 1]
        return TableView(aict.corner_table, att_table)


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


def device_encode_group(positions_batch: np.ndarray, topo: PreparedTopology,
                        pos_att, bits: int = 11, device=None) -> dict:
    """The fused step for a (B, V, C) float32 batch sharing ``topo``:
    quantize on the host (C++, the canonical formula), upload uint16
    (int32 past 16 bits), run K1 and K2 on ``device`` (None: the card;
    ``"cpu"`` runs their plain twins). Returns symbols and
    counts on the device, plus vmin/vmax, mins, delta_max and the quantized
    values on the host."""
    dev = resolve(device)
    B, V, C = positions_batch.shape
    gathers = _device_gathers(topo, pos_att, dev, V)
    got = native.quantize_batch(positions_batch, bits) \
        if bits <= 16 else None
    if got is not None:
        q_np, mins, delta_max, vmin, vmax = got   # q_np uint16
        q_up = q_np
    else:
        # no native library, or non-finite input (this raises for it)
        q_np, mins, delta_max = quantize_positions_host(positions_batch,
                                                        bits)
        vmin = q_np.min(axis=(1, 2)).astype(np.int32)
        vmax = q_np.max(axis=(1, 2)).astype(np.int32)
        q_up = q_np.astype(np.uint16) if bits <= 16 else q_np
    q_dev = torch.from_numpy(q_up).to(dev)
    vmin_dev = torch.from_numpy(np.asarray(vmin, np.int32)).to(dev)
    vmax_dev = torch.from_numpy(np.asarray(vmax, np.int32)).to(dev)
    symbols, counts = encode_step_from_q_cuda(q_dev, gathers, vmin_dev,
                                              vmax_dev, bits=bits)
    return {"symbols": symbols, "counts": counts, "vmin": vmin,
            "vmax": vmax, "mins": mins, "delta_max": delta_max, "q": q_np}


class BatchEncoder:
    """Encodes meshes with topology-group batching, the position attribute
    on the device. ``cfg`` may differ from the default Config only in
    quantization depths."""

    # meshes per device call: the group's lanes run in one K3 launch
    DEVICE_CHUNK = 512

    def __init__(self, cfg=None) -> None:
        self.cfg = cfg
        self._topo_cache: dict[str, PreparedTopology] = {}

    def encode_meshes_device(self, meshes: list, bits: int | None = None,
                             entropy: str = "device",
                             device=None) -> list[bytes]:
        """Per topology group, the fused step and the rANS coder run on
        ``device`` (None: the card; ``"cpu"`` runs the kernels' plain
        twins) in chunks of DEVICE_CHUNK meshes; the host assembles the
        bytes. Output equals sequential encode(). Errors raise; there
        is no host fallback. Only the position attribute is ported: a mesh
        with any other attribute raises NotImplementedError."""
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
        if not _depths_in_range(bits, dflt["normal_bits"], dflt["uv_bits"]):
            raise ValueError(f"position quantization depth {bits} out of "
                             "range [1..30]")
        for m in meshes:
            extra = [a.att_type.name for a in m.attributes
                     if a.att_type != AttributeType.POSITION]
            if extra:
                raise NotImplementedError(
                    f"attributes {extra} beyond POSITION: the NORMAL and "
                    "TEX_COORD device chains are not ported yet (ROADMAP "
                    "open item 6)")
        cfg = _merged_quant_cfg(self.cfg, bits, dflt["normal_bits"],
                                dflt["uv_bits"])

        groups: dict[str, list[int]] = {}
        for idx, m in enumerate(meshes):
            groups.setdefault(topology_signature(m), []).append(idx)
        out: list[bytes | None] = [None] * len(meshes)
        bits_byte = bytes([bits])
        for sig, idxs in groups.items():
            topo = self._topo_cache.get(sig)
            if topo is None:
                topo = PreparedTopology(meshes[idxs[0]])
                self._topo_cache[sig] = topo
            pos_att0 = meshes[idxs[0]].position_attribute()
            batch = np.stack([meshes[i].position_attribute().values
                              .astype(np.float32) for i in idxs])
            for c0 in range(0, len(idxs), self.DEVICE_CHUNK):
                dev_c = device_encode_group(
                    batch[c0:c0 + self.DEVICE_CHUNK], topo, pos_att0,
                    bits=bits, device=dev)
                payloads = encode_group_entropy_device(dev_c["symbols"],
                                                       dev_c["counts"])
                for k, i in enumerate(idxs[c0:c0 + self.DEVICE_CHUNK]):
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
                    out[i] = encode_with_topology(meshes[i], topo, cfg=cfg,
                                                  precomputed=pre)
        return out

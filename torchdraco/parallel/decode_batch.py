"""Batch decoding of .drc blobs that share one topology, with the rANS
stage on one device.

Counterpart of the shared-topology decoder of
``tpudraco/parallel/decode_batch.py``. The host
parses and reconstructs the connectivity once for the group, collects every
blob's DirectCoded symbol streams, decodes all of them as lanes of one
``rans_decode_lanes`` call per precision (D1, which searches each lane's
cumulative row: no slot table is built or uploaded), and injects the
symbols into the host attribute chains. Output meshes equal the per-blob
host ``decode()`` of ``torchdraco.decode``.

A blob that is malformed, of another topology, or carries a stream the
lanes cannot take (LengthCoded) goes to the host decoder on its own; those
are counted in ``BatchDecoder.n_host_blobs``. A failure of the device stage
raises: no batch falls back to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..decode import _assemble_mesh, decode, decode_header
from ..decode.attribute import decode_attributes
from ..decode.connectivity import decode_connectivity
from ..device import resolve
from ..entropy.symbol_coding import parse_direct_coded_stream
from ..ops.rans_lanes import rans_decode_lanes
from ..wire.byte_io import ByteReader

# Per-call budget for a lane decode's device working set: the lanes'
# streams (L x cap bytes), their tables (freqs and the inclusive row the
# kernel searches, L x S x 4 bytes each, with the int64 temporaries of the
# cumsum) and the output (L x T elements of up to 4 bytes). At Draco's
# shapes that is about 130 KB a lane, so 8 GiB holds tens of thousands of
# lanes on an 80 GB card and a 512-blob group is one launch.
LANE_BUDGET_BYTES = 8 << 30


def _device_decode_streams(streams: dict, device: torch.device,
                           timings: dict) -> dict:
    """rANS-decode independent DirectCoded streams as lanes on ``device``.
    ``streams``: key -> (dist, precision, payload bytes, n_sym). Returns
    key -> (n_sym,) symbols in the host decoder's order. Lanes group by
    precision, each group in calls whose working set fits
    LANE_BUDGET_BYTES. Adds the packing, upload, launch and readback
    (``lanes_s``) to ``timings``."""
    out: dict = {}
    by_prec: dict = {}
    for key, (_, prec, _, _) in streams.items():
        by_prec.setdefault(int(prec), []).append(key)
    for prec, keys in sorted(by_prec.items()):
        S = max(len(streams[k][0]) for k in keys)
        cap = max(max(len(streams[k][2]) for k in keys), 1)
        T = max(max(int(streams[k][3]) for k in keys), 1)
        per_lane = cap + 24 * S + 4 * T
        per_call = max(1, LANE_BUDGET_BYTES // per_lane)
        for c0 in range(0, len(keys), per_call):
            chunk = keys[c0:c0 + per_call]
            t0 = time.perf_counter()
            L = len(chunk)
            buffers = np.zeros((L, cap), np.uint8)
            nbytes = np.zeros(L, np.int32)
            freqs = np.zeros((L, S), np.int32)
            counts = np.zeros(L, np.int64)
            for j, k in enumerate(chunk):
                dist, _, payload, n_sym = streams[k]
                buffers[j, :len(payload)] = np.frombuffer(payload, np.uint8)
                nbytes[j] = len(payload)
                freqs[j, :len(dist)] = dist
                counts[j] = n_sym
            got = rans_decode_lanes(
                torch.from_numpy(buffers).to(device), nbytes,
                torch.from_numpy(freqs).to(device), counts,
                precision=prec).cpu().numpy()
            timings["lanes_s"] = timings.get("lanes_s", 0.0) \
                + time.perf_counter() - t0
            for j, k in enumerate(chunk):
                out[k] = got[j, :int(streams[k][3])]
    return out


class BatchDecoder:
    """Decode Draco blobs with per-blob error isolation; blobs of one
    topology group decode with their rANS stage as device lanes.
    ``n_host_blobs`` counts the blobs sent to the full host decoder;
    ``timings`` holds the stage times of the last shared-topology call."""

    def __init__(self) -> None:
        self.n_host_blobs = 0
        self.timings: dict = {}

    def _host_decode(self, blob):
        self.n_host_blobs += 1
        try:
            return decode(blob)
        except Exception:  # per-blob isolation: a bad blob decodes to None
            return None

    def decode_blobs(self, blobs: list[bytes]) -> list:
        """Each blob through the host decoder; None where it fails."""
        return [self._host_decode(b) for b in blobs]

    def decode_blobs_shared_topology(self, blobs: list[bytes],
                                     entropy: str = "host",
                                     device=None) -> list:
        """Batch decode for blobs made from one topology group (the output
        of ``BatchEncoder.encode_meshes_device``): the connectivity of the
        first blob is parsed and reconstructed ONCE and reused for every
        blob whose connectivity bytes match it byte for byte; the others
        take the host decoder. Meshes equal per-blob ``decode()``.

        ``entropy="device"`` decodes every attribute symbol stream of the
        group as rANS lanes on ``device`` (None: the card; ``"cpu"``, where
        the lanes take D1's plain twin, is had by asking). NORMAL chains
        decode per blob on the host."""
        if entropy not in ("host", "device"):
            raise ValueError(f"entropy must be 'host' or 'device', got "
                             f"{entropy!r}")
        self.timings = {}
        if not blobs:
            return []
        try:
            r0 = ByteReader(blobs[0])
            header = decode_header(r0)
            if header["flags"] & 0x8000 or header["method"] != 1 \
                    or header["geometry_type"] != 1:
                raise ValueError("not a plain edgebreaker mesh stream")
            conn = decode_connectivity(r0)
            conn_end = r0.pos
            prefix = bytes(blobs[0][:conn_end])
        except Exception:  # the first blob cannot anchor a group
            return self.decode_blobs(blobs)

        if entropy == "device":
            return self._decode_shared_device(blobs, conn, conn_end, prefix,
                                              resolve(device))
        out: list = [None] * len(blobs)
        items = []
        for i, blob in enumerate(blobs):
            if bytes(blob[:conn_end]) != prefix:
                out[i] = self._host_decode(blob)  # another topology
                continue

            def fn(_b=blob):
                return decode_attributes(
                    ByteReader(_b, pos=conn_end), conn)
            items.append((i, fn))
        self._decode_items_with_phase(conn, items, out)
        return out

    @staticmethod
    def _decode_items_with_phase(conn, items, out) -> None:
        """The unphased branch of tpudraco's method of this name: each
        item's attribute decode, then the mesh assembly. ``items``: (blob
        index, callable returning the decoded attribute list); a blob
        whose decode raises becomes None."""
        for i, fn in items:
            try:
                out[i] = _assemble_mesh(conn, fn())
            except Exception:  # per-blob isolation
                out[i] = None

    def _decode_shared_device(self, blobs, conn, conn_end, prefix,
                              device: torch.device) -> list:
        """Three phases: (A) one structural pass per blob collects every
        DirectCoded stream (table + payload bytes) without decoding it,
        (B) all streams rANS-decode as device lanes grouped by precision,
        (C) a second pass injects the symbols into the host chains."""
        t0 = time.perf_counter()
        out: list = [None] * len(blobs)
        streams: dict = {}  # (blob idx, att idx) -> (dist, prec, payload, n)
        matching = []
        for i, blob in enumerate(blobs):
            if bytes(blob[:conn_end]) != prefix:
                out[i] = self._host_decode(blob)  # another topology
                continue
            found: dict = {}

            def collect(att_idx, n_sym, n, reader, _found=found):
                dist, prec, payload = parse_direct_coded_stream(reader)
                if int(dist.sum()) != 1 << prec:
                    # a corrupt or foreign table: this blob takes the host
                    # path, so that the lanes' own refusal of such a table
                    # cannot fail the whole group
                    raise ValueError("non-normalized rANS table")
                _found[att_idx] = (dist, prec, payload, n_sym)

            try:
                decode_attributes(
                    ByteReader(blob, pos=conn_end), conn,
                    symbol_source=collect, collect_only=True)
            except Exception:  # e.g. a LengthCoded stream: the host path
                out[i] = self._host_decode(blob)
                continue
            streams.update(((i, a), s) for a, s in found.items())
            matching.append(i)
        t1 = time.perf_counter()
        decoded = _device_decode_streams(streams, device, self.timings)
        t2 = time.perf_counter()
        items = []
        for i in matching:
            def fn(_i=i):
                def inject(att_idx, n_sym, n, reader):
                    parse_direct_coded_stream(reader)  # advance
                    return decoded[(_i, att_idx)][:n_sym].astype(np.uint64)
                return decode_attributes(
                    ByteReader(blobs[_i], pos=conn_end), conn,
                    symbol_source=inject)
            items.append((i, fn))
        self._decode_items_with_phase(conn, items, out)
        self.timings.update(collect_s=t1 - t0, device_stage_s=t2 - t1,
                            assemble_s=time.perf_counter() - t2)
        return out

"""Batch decoding of .drc blobs that share one topology, with the rANS
stage on one device.

Counterpart of the shared-topology decoder of
``tpudraco/parallel/decode_batch.py``. The host
parses and reconstructs the connectivity once for the group, collects every
blob's DirectCoded symbol streams, decodes all of them as lanes of one
``rans_decode_lanes`` call per precision (D1, which searches each lane's
cumulative row: no slot table is built or uploaded), and injects the
symbols into the host attribute chains. With ``normals="device"`` the
decode is phased: each blob's chains run with the NORMAL chain deferred,
then every deferred chain of the group runs as one batch on the device
(ops/normals.normal_decode_chain). Output meshes equal the per-blob host
``decode()`` of ``torchdraco.decode``.

A blob that is malformed, of another topology, or carries a stream the
lanes cannot take (LengthCoded) goes to the host decoder on its own; those
are counted in ``BatchDecoder.n_host_blobs``. A failure of a device stage
(the lanes, the normal phase) raises: no batch falls back to the host.

``BatchDecoder.decode_corpus`` decodes ``.drc`` files on disk into OBJ or
PLY files, groups of files with the same leading bytes through the shared
topology decoder on the device, with resume and per-file error isolation.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..decode import _assemble_mesh, decode, decode_header
from ..decode.attribute import _deportabilize, decode_attributes
from ..decode.connectivity import decode_connectivity
from ..device import resolve
from ..entropy.symbol_coding import parse_direct_coded_stream
from ..ops.normals import (
    collect_normal_rings, normal_decode_chain, rings_to_torch,
)
from ..ops.rans_lanes import rans_decode_lanes
from .batch import _drop_output_collisions
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

    # normals="auto": below this many matching blobs, and for a mesh below
    # this many faces, the per-blob host chains stand; a batch that large,
    # or a single mesh that large, takes the device phase. (tpudraco also
    # asks a probe of its host-to-device link here; that gate measured its
    # own link and has no counterpart.)
    PHASED_NORMALS_MIN_BLOBS = 16
    PHASED_NORMALS_MIN_FACES = 1 << 17

    def _phased_auto(self, n_blobs: int, conn) -> bool:
        return (n_blobs >= self.PHASED_NORMALS_MIN_BLOBS
                or conn.corner_table.num_faces()
                >= self.PHASED_NORMALS_MIN_FACES)

    def _phased(self, normals: str, n_blobs: int, conn) -> bool:
        return normals == "device" or (
            normals == "auto" and self._phased_auto(n_blobs, conn))

    def decode_blobs_shared_topology(self, blobs: list[bytes],
                                     entropy: str = "host",
                                     normals: str = "auto",
                                     device=None) -> list:
        """Batch decode for blobs made from one topology group (the output
        of ``BatchEncoder.encode_meshes_device``): the connectivity of the
        first blob is parsed and reconstructed ONCE and reused for every
        blob whose connectivity bytes match it byte for byte; the others
        take the host decoder. Meshes equal per-blob ``decode()``.

        ``entropy="device"`` decodes every attribute symbol stream of the
        group as rANS lanes on ``device`` (None: the card; ``"cpu"``, where
        the lanes take D1's plain twin, is had by asking).

        ``normals``: "host" keeps the per-blob vectorized NORMAL chains;
        "device" batches them across blobs on ``device`` (the PHASED
        decode: positions first per blob, then all normal chains as one
        ring-predict + inverse-transform batch); "auto" picks device at
        PHASED_NORMALS_MIN_BLOBS matching blobs or a mesh of
        PHASED_NORMALS_MIN_FACES faces. Values are identical either way;
        a failure of the device phase raises. ``device`` None is the card
        for the phase too, also with ``entropy="host"``: where "auto"
        takes the phase and there is no card, the call raises a
        RuntimeError that names ``normals="host"`` and ``device="cpu"``;
        it never switches to the host by itself.

        An entry that is not bytes-like, or whose decode fails, yields
        None and does not stop the group."""
        if entropy not in ("host", "device"):
            raise ValueError(f"entropy must be 'host' or 'device', got "
                             f"{entropy!r}")
        if normals not in ("host", "device", "auto"):
            raise ValueError(f"normals must be 'host', 'device' or 'auto', "
                             f"got {normals!r}")
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
                                              resolve(device), normals)
        out: list = [None] * len(blobs)
        items = []
        for i, blob in enumerate(blobs):
            try:
                same = bytes(blob[:conn_end]) == prefix
            except Exception:  # not bytes-like: the entry yields None
                continue
            if not same:
                out[i] = self._host_decode(blob)  # another topology
                continue

            def fn(collector, _b=blob):
                return decode_attributes(
                    ByteReader(_b, pos=conn_end), conn,
                    normal_collector=collector)
            items.append((i, fn))
        self._decode_items_with_phase(conn, items, out, normals, device)
        return out

    @staticmethod
    def _phase_device(normals: str, device) -> torch.device:
        """The device of the batched normal phase. Where "auto" chose the
        phase and the card is missing, the error says how to stay off
        it."""
        try:
            return resolve(device)
        except RuntimeError as e:
            if normals != "auto":
                raise
            raise RuntimeError(
                f"normals='auto' chose the batched normal phase on the card "
                f"for this group, and {e}; pass normals='host' to keep the "
                f"per-blob host chains, or device='cpu'") from e

    def _decode_items_with_phase(self, conn, items, out, normals: str,
                                 device) -> None:
        """Each item's attribute decode, then the mesh assembly; where
        ``normals`` takes the phase for these items, with the NORMAL
        chains deferred by the collector and run as one batch on
        ``device`` between the two. ``items``: (blob index, callable
        taking the collector and returning the decoded attribute list); a
        blob whose own decode raises becomes None, a failure of the
        batched phase raises."""
        phased = self._phased(normals, len(items), conn)
        deferred: list = []       # (blob idx, att idx, da, payload)
        pending: dict = {}        # blob idx -> decoded attribute list
        for i, fn in items:
            try:
                if phased:
                    pending[i] = fn(lambda ai, da, pl, _i=i:
                                    deferred.append((_i, ai, da, pl)))
                else:
                    out[i] = _assemble_mesh(conn, fn(None))
            except Exception:  # per-blob isolation
                deferred = [d for d in deferred if d[0] != i]
                pending.pop(i, None)
                out[i] = None
        if deferred:
            t0 = time.perf_counter()
            self._fill_deferred_normals(
                conn, deferred, self._phase_device(normals, device))
            self.timings["normals_s"] = time.perf_counter() - t0
        for i, atts in pending.items():
            try:
                out[i] = _assemble_mesh(conn, atts)
            except Exception:  # per-blob isolation
                out[i] = None

    @staticmethod
    def _fill_deferred_normals(conn, deferred: list, device) -> None:
        """Phase 2 of the phased decode: batch every deferred NORMAL chain
        (same attribute slot, same topology) through the device ring
        prediction + OctOrthogonal inverse (ops/normals.normal_decode_chain
        — bit-identical to the host chain) on ``device`` (None: the card),
        then scatter, dequantize, and fill each DecodedAttribute in
        place. An error raises."""
        dev = resolve(device)
        groups: dict = {}
        for bi, ai, da, pl in deferred:
            # the attribute TRAVERSAL is part of the key: blobs with
            # different TraversalType bytes have different sequences over
            # the same topology
            trav = int(pl["h"].get("traversal", 0))
            groups.setdefault((ai, int(pl["max_q"]), trav), []).append(
                (da, pl))
        for (ai, max_q, trav), items in groups.items():
            pl0 = items[0][1]
            view, seq = pl0["view"], pl0["sequence"]
            bits = int(max_q).bit_length()  # max_q == 2^bits - 1
            cache = getattr(conn, "_phased_rings", None)
            if cache is None:
                cache = conn._phased_rings = {}
            rings = cache.get((ai, trav, str(dev)))
            if rings is None:
                rings = cache[(ai, trav, str(dev))] = rings_to_torch(
                    collect_normal_rings(view, seq), dev,
                    rows=pl0["pos"].da.vertex_of_corner)
            T = len(seq)
            q_pos = np.stack([
                np.asarray(pl["pos"].da.quantized_by_vertex, dtype=np.int32)
                for _, pl in items])
            sym = np.stack([np.asarray(pl["symbols"][:T], dtype=np.int32)
                            for _, pl in items])
            fl = np.stack([np.asarray(pl["flips"][:T], dtype=bool)
                           for _, pl in items])
            vals = normal_decode_chain(
                torch.from_numpy(q_pos).to(dev),
                torch.from_numpy(sym).to(dev), torch.from_numpy(fl).to(dev),
                rings["tip_pt"], rings["next_pt"], rings["prev_pt"],
                rings["mask"], bits=bits).cpu().numpy()
            _opp, ctv, _lm = view.as_arrays()
            rows = ctv[np.asarray(seq, dtype=np.int64)]
            for b, (da, pl) in enumerate(items):
                vbv = np.zeros((view.num_vertices, 2), dtype=np.int64)
                vbv[rows] = vals[b]
                da.quantized_by_vertex = vbv
                da.values_by_vertex = _deportabilize(
                    vbv, pl["h"], pl["port_meta"])

    def _decode_shared_device(self, blobs, conn, conn_end, prefix,
                              device: torch.device, normals: str) -> list:
        """Three phases: (A) one structural pass per blob collects every
        DirectCoded stream (table + payload bytes) without decoding it,
        (B) all streams rANS-decode as device lanes grouped by precision,
        (C) a second pass injects the symbols into the host chains (with
        the NORMAL chains deferred to the batched device phase where
        ``normals`` says so, see decode_blobs_shared_topology)."""
        t0 = time.perf_counter()
        out: list = [None] * len(blobs)
        streams: dict = {}  # (blob idx, att idx) -> (dist, prec, payload, n)
        matching = []
        for i, blob in enumerate(blobs):
            try:
                same = bytes(blob[:conn_end]) == prefix
            except Exception:  # not bytes-like: the entry yields None
                continue
            if not same:
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
            def fn(collector, _i=i):
                def inject(att_idx, n_sym, n, reader):
                    parse_direct_coded_stream(reader)  # advance
                    return decoded[(_i, att_idx)][:n_sym].astype(np.uint64)
                return decode_attributes(
                    ByteReader(blobs[_i], pos=conn_end), conn,
                    symbol_source=inject, normal_collector=collector)
            items.append((i, fn))
        self._decode_items_with_phase(conn, items, out, normals, device)
        self.timings.update(collect_s=t1 - t0, device_stage_s=t2 - t1,
                            assemble_s=time.perf_counter() - t2)
        return out

    def decode_corpus(self, inputs: list[str], out_dir: str,
                      resume: bool = True, fmt: str = "obj",
                      workers: int = 1, use_device: bool = True,
                      device=None) -> dict:
        """Decode .drc files into ``out_dir`` as ``<basename>.<fmt>``
        (``fmt``: obj or ply), with resume (an existing output is skipped)
        and per-file error isolation (a bad blob is reported in ``failed``).
        ``use_device`` (the default): the files are grouped by their first
        64 bytes and each group goes through
        ``decode_blobs_shared_topology(entropy="device")`` on ``device``
        (None: the card; ``"cpu"`` runs D1's plain twin), which decodes
        every symbol stream of the group as rANS lanes and, with
        ``normals="auto"``, takes the batched normal phase for a group of
        PHASED_NORMALS_MIN_BLOBS blobs or more; a failure there raises.
        ``use_device=False`` is the host plane. ``workers`` > 1 decodes the
        host plane's files on a thread pool. Writes and returns the report
        (``decode_report.json``), whose ``stages_s`` splits the wall into
        the device groups and the per-file pass."""
        from ..io.obj import save_obj as _save_obj
        from ..io.ply import save_ply as _save_ply
        save_mesh = _save_ply if fmt == "ply" else _save_obj
        dev = resolve(device) if use_device else None

        os.makedirs(out_dir, exist_ok=True)
        report = {"decoded": 0, "skipped": 0, "failed": [],
                  "total_in_bytes": 0}
        t0 = time.perf_counter()

        def out_path_for(path):
            name = os.path.splitext(os.path.basename(path))[0] + "." + fmt
            return os.path.join(out_dir, name)

        inputs, collided = _drop_output_collisions(inputs, out_path_for)
        for path in collided:
            report["failed"].append(
                {"path": path, "error": "output name collision"})

        done: dict[str, tuple] = {}
        t1 = time.perf_counter()
        if use_device:
            # group by a cheap prefix key (the shared-topology decoder
            # checks the whole connectivity prefix), then decode and write
            # one group at a time: memory is O(group)
            groups: dict[bytes, list[str]] = {}
            for path in inputs:
                if resume and os.path.isfile(out_path_for(path)):
                    continue
                try:
                    with open(path, "rb") as f:
                        head = f.read(64)
                    groups.setdefault(bytes(head), []).append(path)
                except Exception:
                    pass  # the per-file pass below reports it
            for paths in groups.values():
                blobs, sizes = [], []
                for p in paths:
                    with open(p, "rb") as f:
                        b = f.read()
                    blobs.append(b)
                    sizes.append(len(b))
                got = self.decode_blobs_shared_topology(
                    blobs, entropy="device", device=dev)
                for p, mesh, nbytes in zip(paths, got, sizes):
                    if mesh is None:
                        continue  # the host pass below reports the error
                    try:
                        out_path = out_path_for(p)
                        tmp = out_path + f".tmp{os.getpid()}"
                        save_mesh(mesh, tmp)
                        os.replace(tmp, out_path)
                        done[p] = ("decoded", p, nbytes)
                    except Exception as e:
                        done[p] = ("failed", p, repr(e))

        def one(path):
            if path in done:
                return done[path]
            out_path = out_path_for(path)
            if resume and os.path.isfile(out_path):
                return ("skipped", path, 0)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                mesh = decode(blob)
                tmp = out_path + f".tmp{os.getpid()}"
                save_mesh(mesh, tmp)
                os.replace(tmp, out_path)
                return ("decoded", path, len(blob))
            except Exception as e:  # per-file isolation
                return ("failed", path, repr(e))

        t2 = time.perf_counter()
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                results = list(pool.map(one, inputs))
        else:
            results = [one(p) for p in inputs]

        for status, path, x in results:
            if status == "decoded":
                report["decoded"] += 1
                report["total_in_bytes"] += x
            elif status == "skipped":
                report["skipped"] += 1
            else:
                report["failed"].append({"path": path, "error": x})
        report["seconds"] = round(time.perf_counter() - t0, 3)
        # the device groups (read, decode, write), then the per-file pass
        report["stages_s"] = {"device_s": round(t2 - t1, 3),
                              "files_s": round(time.perf_counter() - t2, 3)}
        tmp_rep = os.path.join(out_dir,
                               f"decode_report.json.tmp{os.getpid()}")
        with open(tmp_rep, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp_rep, os.path.join(out_dir, "decode_report.json"))
        return report

"""Benchmarks of torchdraco's production paths on one NVIDIA GPU: the
counterpart of the repository's root ``bench.py``, with its metrics, its
inputs, its baselines and its output, one JSON line per metric.

  python -m torchdraco.bench                   # the mixed corpus through
                                               # the router (the default)
  python -m torchdraco.bench --metric e2e      # encode_meshes_device: host
                                               # meshes in, .drc bytes out
  python -m torchdraco.bench --metric step     # the fused step (quantize,
                                               # K1, K2) on resident floats
  python -m torchdraco.bench --metric decode   # the lane decoder (D1) over
                                               # the lane coder's streams
  python -m torchdraco.bench --metric decode-corpus  # the grouped decoder
  python -m torchdraco.bench --metric huge     # one 1024 x 1024 grid with
                                               # normals and UVs, resident
  python -m torchdraco.bench --metric all      # one line per metric
  python -m torchdraco.bench --breakdown       # the e2e wall by stage, and
                                               # the card's own trace of it
  python -m torchdraco.bench --device cpu ...  # a rehearsal on the plain
                                               # twins (CPU tensors)

A line is ``{"metric", "value", "unit", "baseline_measured",
"vs_baseline"}`` as ``bench.py`` writes it, with the card beside it
(``"device": {"platform": "gpu", "name", "count", "power_limit_w"}``,
the limit as ``nvidia-smi --query-gpu=name,power.limit`` reads it), the
launches of each kernel over the metric's run (``launches``), and the
card's busy time and idle share in one more warm call of the measured path
under ``torch.profiler``, outside the timed runs (``device_busy_ms``,
``device_idle_share``).

Baselines are host pipelines measured in the same process, in turns with
the device runs, the best of each:
  - step: the per-mesh numpy fused step (``_host_step_once``);
  - e2e, corpus, huge: the host plane (``BatchEncoder.encode_mesh``, the
    topology cached, C++ entropy), which writes the same bytes;
  - decode: the host's C++ rANS decoder, a stream at a time;
  - decode-corpus: ``decode()`` a blob at a time.
Every device path holds its bytes, or its round trip, to the host plane
before it is timed, and raises where they differ. A host clock is read
with the card synchronised; the step is timed with CUDA events and moves
nothing between host and card while it is timed.

There is no fallback: without a card the bench exits with status 2 and
names ``--device cpu``. Under ``--device cpu`` each metric is named
``rehearsal_<metric>``, its device's platform is ``"cpu"`` and the line
carries ``"rehearsal": true``: no CPU number stands under a device
metric's name.

Sizes: ``TORCHDRACO_BENCH_BATCH`` meshes (512) of ``TORCHDRACO_BENCH_N`` x
``TORCHDRACO_BENCH_N`` vertices (64), and the corpus's lone grid of
``TORCHDRACO_BENCH_HUGE_N`` x ``TORCHDRACO_BENCH_HUGE_N`` (768).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import build_meshes, make_mesh_batch
from .device import resolve

BATCH = int(os.environ.get("TORCHDRACO_BENCH_BATCH", "512"))
N = int(os.environ.get("TORCHDRACO_BENCH_N", "64"))
HUGE_N = int(os.environ.get("TORCHDRACO_BENCH_HUGE_N", "768"))
SLICES = 16
# a trace may miss a run's device events, at times all of them: this many
# traced calls before the line says the card's account is missing
TRACE_ATTEMPTS = 3
TOP_OPS = 5


def _setup(dev: torch.device):
    """The bench's inputs: BATCH grids of N x N (``make_mesh_batch``, seed
    1, the counterpart of ``__graft_entry__._make_mesh_batch``), the
    gathers of their topology as numpy (``gn``) and as tensors on ``dev``,
    as ``torchdraco.entry()`` builds them."""
    from .parallel.batch import (PreparedTopology, gathers_to_torch,
                                 topology_gathers_np)

    positions, faces = make_mesh_batch(batch=BATCH, n=N, seed=1)
    mesh0 = build_meshes(positions[:1], faces)[0]
    gn = topology_gathers_np(PreparedTopology(mesh0),
                             mesh0.position_attribute())
    return positions, faces, gn, gathers_to_torch(gn, dev)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    limit = smi.stdout.strip().splitlines()[0].rsplit(",", 1)[1].split()[0]
    return {"platform": "gpu", "name": torch.cuda.get_device_name(index),
            "count": torch.cuda.device_count(),
            "power_limit_w": float(limit)}


def _named(metric: str, dev: torch.device) -> dict:
    """A line's metric and the device it was measured on; a CPU run's
    metric takes the prefix ``rehearsal_`` and the line says so."""
    if dev.type == "cuda":
        return {"metric": metric, "device": _card(
            torch.cuda.current_device() if dev.index is None else dev.index)}
    return {"metric": "rehearsal_" + metric, "device": {"platform": "cpu"},
            "rehearsal": True}


def _result(metric: str, value: float, unit: str, baseline: float,
            dev: torch.device) -> dict:
    """``bench.py``'s line, with the device it was measured on."""
    return {**_named(metric, dev), "value": round(value, 2), "unit": unit,
            "baseline_measured": round(baseline, 2),
            "vs_baseline": round(value / baseline, 3)}


# ------------------------------------------------------------- timing ----


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall(fn, dev: torch.device) -> float:
    """Host seconds of one call of ``fn``, the card synchronised before
    each clock read."""
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def _best_in_turns(fns, trials: int, dev: torch.device) -> list[float]:
    """The least of ``trials`` walls of each function, the functions run
    in turns, so that their ratio is taken in one window."""
    best = [float("inf")] * len(fns)
    for _ in range(trials):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], _wall(fn, dev))
    return best


def _launches() -> dict:
    from .ops import KERNEL_WRAPPERS

    return {fn.__name__: fn.n_launches for fn in KERNEL_WRAPPERS}


def _launched_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _busy_us(spans) -> float:
    """The union of device intervals ``(start, end)`` in microseconds."""
    busy, edge = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    return busy


def _device_events(fn, dev: torch.device):
    """One call of ``fn`` under a CUDA trace: (its wall in seconds, the
    trace's device events: kernels, copies and fills, as written to a
    Chrome trace, where a copy carries its bytes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = _wall(fn, dev)
    tmp = tempfile.mkdtemp(prefix="torchdraco_bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return wall, [e for e in events if e.get("ph") == "X" and e.get("cat")
                  in ("kernel", "gpu_memcpy", "gpu_memset")]


def _trace(fn, dev: torch.device, detail: bool = False) -> dict:
    """The card's own account of one warm call of ``fn``: its busy time
    (the union of the device events) and the idle share of the call's
    wall; with ``detail`` also the megabytes copied each way and the
    TOP_OPS device operations that took the most time, by name. None where
    the device is the CPU, or where the trace lost every event
    TRACE_ATTEMPTS times over."""
    out = {"device_busy_ms": None, "device_idle_share": None}
    if detail:
        out.update(traced_h2d_mb=None, d2h_mb=None, device_top_ops=None)
    if dev.type != "cuda":
        return out
    fn()
    for _ in range(TRACE_ATTEMPTS):
        wall, events = _device_events(fn, dev)
        if events:
            break
    else:
        return out
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    out.update(device_busy_ms=busy,
               device_idle_share=1 - busy / (wall * 1e3))
    if detail:
        copied = {"HtoD": 0, "DtoH": 0}
        by_name: dict = {}
        for e in events:
            for way in copied:
                if e["cat"] == "gpu_memcpy" and way in e["name"]:
                    copied[way] += int(e.get("args", {}).get("bytes", 0))
            ms, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
        out.update(traced_h2d_mb=copied["HtoD"] / 1e6,
                   d2h_mb=copied["DtoH"] / 1e6,
                   device_top_ops=[{"name": name[:120], "ms": ms, "calls": n}
                                   for name, (ms, n) in top])
    return out


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"torchdraco.bench: {what}")


# ---------------------------------------------------------------- step ----


def _host_step_once(pos, gn, bits=11):
    """Per-mesh numpy fused step (quantize -> predict -> residual ->
    zigzag -> histogram), the host pipeline of the fused step, one mesh
    at a time (``bench.py``'s, which returns nothing). Returns the
    histograms, one a mesh."""
    hist_bins = 1 << (bits + 1)
    hists = []
    for b in range(pos.shape[0]):
        v = pos[b]
        mins = np.minimum(v.min(axis=0), 0).astype(np.float32)
        maxs = np.maximum(v.max(axis=0), 0).astype(np.float32)
        delta = np.float32((maxs - mins).max())
        scale = np.float32((1 << bits) - 1)
        q = (((v - mins) / delta) * scale + np.float32(0.5)).astype(np.int32)
        a = q[gn["next"]]
        c = q[gn["prev"]]
        d = q[gn["opp"]]
        fb = q[gn["fallback"]]
        para = a + c - d
        preds = np.where(gn["can_para"][:, None], para,
                         np.where(gn["has_fallback"][:, None], fb, 0))
        o = q[gn["order"]]
        vmax = int(q.max())
        vmin = int(q.min())
        max_diff = 1 + vmax - vmin
        max_corr = max_diff // 2 - (1 if max_diff % 2 == 0 else 0)
        val = o - np.clip(preds, vmin, vmax)
        corr = np.where(val > max_corr, val - max_diff,
                        np.where(val < -(max_diff // 2), val + max_diff,
                                 val))
        sym = np.where(corr >= 0, corr << 1, ((-(corr + 1)) << 1) + 1)
        hists.append(np.bincount(sym.ravel(), minlength=hist_bins))
    return hists


def _device_step(pos: torch.Tensor, gathers: dict, bits: int = 11):
    """The fused step on float positions (B, V, 3) resident on the device:
    ``quantize_kernel``, the residual range over q, then K1 and K2
    (``encode_step_from_q_cuda``), the counterpart of
    ``encode_step_pallas``. Returns (symbols, counts)."""
    from .ops import encode_step_from_q_cuda, quantize_kernel

    q, _, _ = quantize_kernel(pos, bits)
    return encode_step_from_q_cuda(q, gathers, q.amin(dim=(1, 2)),
                                   q.amax(dim=(1, 2)), bits=bits)


def bench_step(positions, gn, gathers, dev: torch.device) -> dict:
    """The fused step over SLICES copies of the batch, resident on the
    device, a slice at a time (``bench.py``'s ``lax.map`` over slices):
    CUDA events around 5 steps, the best of 4, against the per-mesh numpy
    step. Slice 0's symbols and counts must equal the plain ``encode_step``
    on the same positions."""
    from .ops import encode_step

    before = _launches()
    pos = torch.from_numpy(positions).to(dev)
    slices = pos.unsqueeze(0).repeat(SLICES, 1, 1, 1)
    syms, counts = _device_step(slices[0], gathers)
    want = encode_step(slices[0], gathers, bits=11)
    _check(torch.equal(syms, want["symbols"])
           and torch.equal(counts, want["counts"]),
           "the fused step's symbols or counts diverge from encode_step")

    def step():
        for s in range(SLICES):
            _device_step(slices[s], gathers)

    iters, trials = 5, 4
    step()  # warm
    dt = float("inf")
    for _ in range(trials):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                step()
            end.record()
            end.synchronize()
            dt = min(dt, start.elapsed_time(end) / 1e3 / iters)
        else:
            dt = min(dt, _wall(lambda: [step() for _ in range(iters)],
                               dev) / iters)
    mbps = positions.nbytes * SLICES / dt / 1e6

    _host_step_once(positions[:8], gn)  # warm
    hb = min(_wall(lambda: _host_step_once(positions, gn), dev)
             for _ in range(2))
    res = _result("device_encode_step_throughput", mbps, "MB/s",
                  positions.nbytes / hb / 1e6, dev)
    res.update(_trace(step, dev), launches=_launched_since(before))
    return res


# ----------------------------------------------------------------- e2e ----


def bench_e2e(positions, faces, dev: torch.device) -> dict:
    """End-to-end device encode: host meshes in, .drc bytes out, through
    ``BatchEncoder.encode_meshes_device`` (host quantize, upload, K1 + K2,
    the device rANS coder K3, readback, host assembly), against the host
    plane writing the same bytes, in turns, the best of 4."""
    from .parallel import BatchEncoder

    before = _launches()
    meshes = build_meshes(positions, faces)
    enc = BatchEncoder(device=dev, route_cache_path=None)
    blobs_d = enc.encode_meshes_device(meshes)  # builds and warms caches
    _check(blobs_d == [enc.encode_mesh(m) for m in meshes],
           "device bytes diverge from encode_mesh")

    def host():
        for m in meshes:
            enc.encode_mesh(m)

    best_d, best_h = _best_in_turns(
        [lambda: enc.encode_meshes_device(meshes), host], 4, dev)
    res = _result("device_encode_e2e_throughput",
                  positions.nbytes / best_d / 1e6, "MB/s",
                  positions.nbytes / best_h / 1e6, dev)
    res.update(_trace(lambda: enc.encode_meshes_device(meshes), dev),
               launches=_launched_since(before))
    return res


def bench_e2e_breakdown(positions, faces, dev: torch.device) -> dict:
    """The e2e wall of the fastest of 3 warm calls by stage
    (``BatchEncoder.timings``, in ms; ``h2d_mb`` the quantized positions
    uploaded), and the card's account of one more: busy ms, idle share,
    the bytes copied each way (``traced_h2d_mb``; ``d2h_mb``) and
    the device operations that took the most time."""
    from .parallel import BatchEncoder

    before = _launches()
    meshes = build_meshes(positions, faces)
    enc = BatchEncoder(device=dev, route_cache_path=None)
    enc.encode_meshes_device(meshes)  # builds and warms caches
    best, stages = float("inf"), {}
    for _ in range(3):
        total = _wall(lambda: enc.encode_meshes_device(meshes), dev)
        if total < best:
            best, stages = total, dict(enc.timings)
    mbps = positions.nbytes / best / 1e6
    return {**_named("device_encode_e2e_breakdown", dev), "value": mbps,
            "unit": "MB/s",
            **{k[:-2] + "_ms": v * 1e3 for k, v in stages.items()
               if k.endswith("_s")},
            "total_ms": best * 1e3, "mbps": mbps, "h2d_mb": stages["h2d_mb"],
            **_trace(lambda: enc.encode_meshes_device(meshes), dev,
                     detail=True),
            "launches": _launched_since(before)}


# --------------------------------------------------------------- decode ----


def bench_decode(positions, gathers, dev: torch.device) -> dict:
    """The lane decoder D1 (``rans_decode_lanes``) against the host's C++
    decoder over the same streams: the fused step's symbols of each mesh
    as one lane, a table a lane normalized at P=12, coded by
    ``rans_encode_lanes`` (K3). The value times what the host decoder
    does, host bytes in and host symbols out (upload, D1, readback; the
    best of 4); ``wrapper_ms`` the wrapper alone on resident streams. The
    round trip must give the symbols back."""
    from .entropy.rans import RansDecoder, normalize_freq_counts
    from .ops import rans_decode_lanes, rans_encode_lanes
    from .wire.byte_io import ByteReader

    before = _launches()
    syms, counts = _device_step(torch.from_numpy(positions).to(dev),
                                gathers)
    syms_np = syms.cpu().numpy()
    counts_np = counts.cpu().numpy()
    B, T, C = syms_np.shape
    n_sym = T * C
    prec = 12
    dists = [normalize_freq_counts(
        counts_np[i][:int(np.flatnonzero(counts_np[i])[-1]) + 1], prec)
        for i in range(B)]
    S = 16
    while S < max(len(d) for d in dists):
        S *= 2
    freqs = np.zeros((B, S), np.uint32)
    cums = np.zeros((B, S), np.uint32)
    for i, d in enumerate(dists):
        freqs[i, :len(d)] = d
        cums[i, 1:len(d)] = np.cumsum(d)[:-1]
    lanes = syms_np.reshape(B, n_sym)[:, ::-1].astype(np.int32)
    bufs, nbytes = rans_encode_lanes(
        torch.from_numpy(lanes).to(dev), freqs, cums,
        np.full(B, n_sym, np.int32), precision=prec)
    cnts = np.full(B, n_sym, np.int64)

    def device_decode():
        return rans_decode_lanes(torch.from_numpy(bufs).to(dev), nbytes,
                                 freqs, cnts, precision=prec).cpu().numpy()

    # decode pops in reverse emission order: the forward stream
    _check(np.array_equal(device_decode(), lanes[:, ::-1]),
           "the lane decoder's round trip diverges")
    best = min(_wall(device_decode, dev) for _ in range(4))
    bufs_dev = torch.from_numpy(bufs).to(dev)
    nbytes_dev, freqs_dev, cnts_dev = (
        torch.from_numpy(a.astype(np.int64)).to(dev)
        for a in (nbytes, freqs, cnts))

    def resident():
        rans_decode_lanes(bufs_dev, nbytes_dev, freqs_dev, cnts_dev,
                          precision=prec)

    resident()
    wrapper_s = min(_wall(resident, dev) for _ in range(4))

    blobs = [bufs[i, :nbytes[i]].tobytes() for i in range(B)]

    def host_decode_all():
        for i in range(B):
            RansDecoder(ByteReader(blobs[i]), len(blobs[i]), dists[i],
                        precision=prec).read_all(n_sym)

    host_decode_all()  # warm (loads the native library)
    hb = min(_wall(host_decode_all, dev) for _ in range(2))
    res = _result("device_rans_decode_throughput", B * n_sym / best / 1e6,
                  "Msym/s", B * n_sym / hb / 1e6, dev)
    res.update(wrapper_ms=wrapper_s * 1e3, lanes=B, symbols_per_lane=n_sym)
    res.update(_trace(resident, dev), launches=_launched_since(before))
    return res


def _same_meshes(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        a is not None and np.array_equal(a.faces, b.faces)
        and len(a.attributes) == len(b.attributes)
        and all(np.array_equal(np.asarray(x.values), np.asarray(y.values))
                for x, y in zip(a.attributes, b.attributes))
        for a, b in zip(got, want))


def bench_decode_corpus(positions, faces, dev: torch.device,
                        n_meshes: int = 128) -> dict:
    """Corpus decode, .drc to mesh, over a shared-topology group through
    ``BatchDecoder.decode_blobs_shared_topology`` (connectivity parsed and
    rebuilt once a group, the rANS stage on the host: ``entropy="host"``,
    the reference's default) against ``decode()`` a blob at a time, in
    turns, the best of 2. Sub-metrics over 64 of the meshes with unit
    normals: the grouped decode with the per-blob host chains
    (``normals_host_mps``) and with the batched normal phase on the device
    (``normals_phased_mps``), whose idle share the line carries. Every
    decode must equal ``decode()``."""
    from .decode import decode as decode_one
    from .parallel import BatchEncoder
    from .parallel.decode_batch import BatchDecoder

    before = _launches()
    meshes = build_meshes(positions[:n_meshes], faces)
    enc = BatchEncoder(route_cache_path=None)
    blobs = [enc.encode_mesh(m) for m in meshes]
    bd = BatchDecoder()
    want = [decode_one(b) for b in blobs]
    _check(_same_meshes(bd.decode_blobs_shared_topology(blobs, device=dev),
                        want), "the grouped decode diverges from decode()")

    def one_by_one():
        for b in blobs:
            decode_one(b)

    best_g, best_n = _best_in_turns(
        [lambda: bd.decode_blobs_shared_topology(blobs, device=dev),
         one_by_one], 2, dev)
    res = _result("decode_corpus_throughput", len(blobs) / best_g,
                  "meshes/s", len(blobs) / best_n, dev)

    nb = min(len(blobs), 64)
    rng = np.random.RandomState(9)
    nrm = rng.randn(nb, positions.shape[1], 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nblobs = [enc.encode_mesh(m) for m in
              build_meshes(positions[np.arange(nb) % len(positions)], faces,
                           normals=nrm)]
    nwant = [decode_one(b) for b in nblobs]
    for normals in ("host", "device"):
        _check(_same_meshes(bd.decode_blobs_shared_topology(
            nblobs, normals=normals, device=dev), nwant),
            f"the grouped decode with normals={normals!r} diverges from "
            f"decode()")

    def phased():
        bd.decode_blobs_shared_topology(nblobs, normals="device",
                                        device=dev)

    best_h, best_d = _best_in_turns(
        [lambda: bd.decode_blobs_shared_topology(nblobs, normals="host",
                                                 device=dev), phased],
        2, dev)
    res["normals_host_mps"] = round(nb / best_h, 1)
    res["normals_phased_mps"] = round(nb / best_d, 1)
    res.update(_trace(phased, dev), launches=_launched_since(before))
    return res


# ------------------------------------------------------- the large mesh ----


def _grid(n: int, seed: int = 3):
    """An n x n grid, vectorized: (positions (n*n, 3) float32 with random
    heights, faces (2 (n-1)^2, 3) int64, the generator, for what is drawn
    after the heights)."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32))
    pos = np.stack([xs.ravel(), ys.ravel(),
                    rng.rand(n * n).astype(np.float32) * 4], axis=1)
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    f1 = np.stack([a, a + 1, a + n], axis=1)
    f2 = np.stack([a + 1, a + n + 1, a + n], axis=1)
    return pos, np.concatenate([f1, f2]).astype(np.int64), rng


def _grid_mesh_single(n: int, seed: int = 3):
    """One n x n grid mesh, positions only."""
    pos, faces, _ = _grid(n, seed)
    return build_meshes(pos[None], faces)[0]


def bench_huge(dev: torch.device, n: int = 1024) -> dict:
    """One n x n grid with unit normals and UVs through the resident
    route ``encode_mesh_device`` (one upload, K1's tiled kernel,
    K2's split row, the NORMAL and TEX_COORD chains, one readback, the
    host's C++ rANS coder) against the host plane, in turns, the best of
    3; the topology is prepared once, untimed, as a long-lived encoder
    keeps it. The bytes must equal the host plane's."""
    from .parallel import BatchEncoder

    before = _launches()
    pos, faces, rng = _grid(n)
    nrm = rng.randn(n * n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = (pos[:, :2] / np.float32(n)).astype(np.float32)
    mesh = build_meshes(pos[None], faces, nrm[None], uv[None])[0]
    raw = pos.nbytes + nrm.nbytes + uv.nbytes

    enc = BatchEncoder(device=dev, route_cache_path=None)
    blob_h = enc.encode_mesh(mesh)           # the topology, the host path
    blob_d = enc.encode_mesh_device(mesh)    # uploads the gathers
    _check(blob_d == blob_h, "resident bytes diverge from encode_mesh")
    _check(enc.n_host_attributes == 0,
           "a chain's guard sent an attribute to the host encoder")
    best_d, best_h = _best_in_turns(
        [lambda: enc.encode_mesh_device(mesh), lambda: enc.encode_mesh(mesh)],
        3, dev)
    res = _result("device_huge_mesh_throughput", raw / best_d / 1e6, "MB/s",
                  raw / best_h / 1e6, dev)
    res.update(_trace(lambda: enc.encode_mesh_device(mesh), dev),
               launches=_launched_since(before))
    return res


# -------------------------------------------------------------- corpus ----


def bench_corpus_auto(positions, faces, dev: torch.device) -> dict:
    """The default metric: a mixed corpus (32 grids of min(63, N)^2, one
    of HUGE_N^2, the BATCH bulk meshes) through
    ``BatchEncoder(use_device="auto")``, the router, which measures each
    topology group on both planes, keeps the faster and caches its
    decision, against the host plane, in turns, the best of 3. Beside it:
    the routing, the cold pass (probes and first calls), a fresh encoder's
    pass from the decision cache on disk, and the bulk group through each
    plane alone (``bulk_device_mbs``, ``bulk_host_mbs``). Every plane's
    bytes must equal the host plane's."""
    from .parallel import BatchEncoder

    before = _launches()
    bulk = build_meshes(positions, faces)
    small = [_grid_mesh_single(min(63, N), s) for s in range(32)]
    huge = [_grid_mesh_single(HUGE_N)]
    corpus = small + huge + bulk
    raw = sum(m.position_attribute().values.nbytes for m in corpus)

    tmp = tempfile.mkdtemp(prefix="torchdraco_bench_")
    try:
        route_cache = os.path.join(tmp, "routes.json")
        auto = BatchEncoder(use_device="auto", device=dev,
                            route_cache_path=route_cache)
        t0 = time.perf_counter()
        blobs_a = auto.encode_meshes_auto(corpus)  # probes, first calls
        _sync(dev)
        cold_s = time.perf_counter() - t0
        host = BatchEncoder(use_device=False, route_cache_path=None)
        host._topo_cache = auto._topo_cache
        blobs_h = [host.encode_mesh(m) for m in corpus]
        _check(blobs_a == blobs_h, "auto bytes diverge from the host plane")

        def host_all():
            for m in corpus:
                host.encode_mesh(m)

        best_a, best_h = _best_in_turns(
            [lambda: auto.encode_meshes_auto(corpus), host_all], 3, dev)
        res = _result("corpus_encode_auto_throughput", raw / best_a / 1e6,
                      "MB/s", raw / best_h / 1e6, dev)
        res["routing"] = [f"{e['plane']}:{e['meshes']}x{e['verts']}v"
                          for e in auto.routing_log[:3]]
        res["auto_cold_s"] = round(cold_s, 3)
        fresh = BatchEncoder(use_device="auto", device=dev,
                             route_cache_path=route_cache)
        res["auto_cold_cached_s"] = round(
            _wall(lambda: fresh.encode_meshes_auto(corpus), dev), 3)
        res["route_cache_hits"] = sum(
            1 for e in fresh.routing_log
            if str(e.get("reason", "")).startswith("cached decision"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the bulk group through each plane alone, in the same window: the
    # device plane's number, which the router's ratio cannot show
    plane = BatchEncoder(device=dev, route_cache_path=None)
    plane._topo_cache = auto._topo_cache
    _check(plane.encode_meshes_device(bulk) == blobs_h[-len(bulk):],
           "device bulk bytes diverge from the host plane")

    def bulk_host():
        for m in bulk:
            host.encode_mesh(m)

    best_bd, best_bh = _best_in_turns(
        [lambda: plane.encode_meshes_device(bulk), bulk_host], 3, dev)
    res["bulk_device_mbs"] = round(positions.nbytes / best_bd / 1e6, 2)
    res["bulk_host_mbs"] = round(positions.nbytes / best_bh / 1e6, 2)
    res.update(_trace(lambda: auto.encode_meshes_auto(corpus), dev),
               launches=_launched_since(before))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchdraco.bench",
        description="Measure torchdraco's production paths on the card; "
                    "one JSON line per metric.")
    ap.add_argument("--metric",
                    choices=("corpus", "e2e", "step", "decode",
                             "decode-corpus", "huge", "all"),
                    default="corpus")
    ap.add_argument("--breakdown", action="store_true",
                    help="print the e2e wall by stage and the card's trace "
                         "of it")
    ap.add_argument("--device", default=None,
                    help="the device to measure (default: the card); 'cpu' "
                         "rehearses the bench on the plain versions, its "
                         "metrics named rehearsal_*")
    args = ap.parse_args(argv)
    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        print(f"torchdraco.bench: {e}. The bench measures the card and "
              f"has no fallback; --device cpu rehearses it on the plain "
              f"versions", file=sys.stderr)
        return 2

    positions, faces, gn, gathers = _setup(dev)
    if args.breakdown:
        print(json.dumps(bench_e2e_breakdown(positions, faces, dev)))
        return 0
    runs = {
        "corpus": lambda: bench_corpus_auto(positions, faces, dev),
        "e2e": lambda: bench_e2e(positions, faces, dev),
        "step": lambda: bench_step(positions, gn, gathers, dev),
        "decode": lambda: bench_decode(positions, gathers, dev),
        "decode-corpus": lambda: bench_decode_corpus(positions, faces, dev),
        "huge": lambda: bench_huge(dev),
    }
    for name, run in runs.items():
        if args.metric in (name, "all"):
            print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

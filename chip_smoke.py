#!/usr/bin/env python3
"""Smoke run of torchdraco on one NVIDIA GPU: builds the CUDA kernels from
this checkout, holds each against its plain PyTorch twin, drives the main
path (BatchEncoder.encode_meshes_device) over 512 grid meshes of 64 x 64
vertices, checks every .drc against the port's own host encoder, and times
the stages (eight meshes also through the entry points without a
``device`` argument, which must reach the card). Then the stream-lane
plane at the same width: the lane coder
through both engines (K3 words, K4 dense) and the lane decoder (D1) over
the fused step's symbols, and BatchDecoder(entropy="device") over the 512
blobs, checked against the port's own host decoder. Then the default
attribute set at the same width (phases 8-11): the card's float32 division,
product-then-sum and square root against numpy bit for bit; the NORMAL and
TEX_COORD chains' kernels (C1 normal encode, C2 normal decode, C3 UV
encode) on the card against their plain versions on the card and on the
CPU, on every output, at the batch's shape, at deep depths, on a ring of
80 slots and on a batch with risky UV meshes, each timed beside its plain
version; encode_meshes_device over 512 meshes with positions, normals and
UVs against the host plane (C1 and C3 launched once); and the phased
decode (normals="device", C2 launched) over those blobs against decode(),
in turns with normals="host". Then one large mesh (phase 12): a 1024 x 1024 grid through
the single-mesh routes, encode_mesh_device with positions, normals and UVs
and encode_mesh_device_chunked with positions, each against encode(), the
resident route's peak card memory on that grid and on grids with UVs and
with one fan vertex against the estimate that the size dispatch
_encode_huge decides by, the dispatch itself, K1 and K2 at the single
row's shapes against their twins, and the chunk quantize against numpy
bit for bit. Then the corpus entry points from files on disk (phase 13):
the router's sweep of encode_meshes_device against the host plane, whose
knobs are printed beside the ones in the code; encode_corpus on the host
plane, the device plane (counted and traced) and the router, with the
knobs in the code, over a mixed corpus of OBJ, PLY and GLB files with a
broken file and a NaN vertex, every .drc equal; a second router pass from
the decision cache
on disk; decode_corpus and transcode_corpus on both planes; and the
torchdraco-corpus CLI in its own process. Then several devices (phase
14), as shards of an axis that names the one card n times (n distinct
cards where the machine has them): the batch cell over axes of 2 and 4
with both coders, K1-K3 once a shard, every blob equal to the unsharded
one; the lane coder over 4 shards; the 1024 x 1024 grid over 4 stream
shards, its summed histogram equal to phase 12's K2 row; phase 13's
corpus in two processes joined by gloo, through encode_corpus_multihost
and the CLI under WORLD_SIZE=2, every file equal to phase 13's; and
torchdraco.dryrun_multichip(4). Then the narrow upload layouts (phase
15): K1 on uint8 and on the 12-bit pack against its twin at the batch
shape and at phase 12's row, timed beside the uint16 layout; the host's
pack and cast and the pageable copy of each layout's bytes;
encode_meshes_device at -qp 8, 11 and 15 with PACKED_UPLOAD on and off,
positions only and with normals and UVs, every blob equal between the
two (and to encode(): all positions-only ones, 8 textured ones a depth);
phase 14's axis at -qp 11 both ways; and
encode_mesh_device on phase 12's grid at -qp 8 and 11. (The main path
itself, at -qp 11, uploads the 12-bit pack.) Then the bench (phase 16):
python -m torchdraco.bench in a process of its own at 64 meshes for each
of corpus, e2e, step, decode and decode-corpus and with --breakdown, and
its bench_huge on a 256 x 256 grid in this process, every line checked
for its metric, a positive value, this card and the card's idle share,
and K1, K2, K3 and D1 launched by them. Then the main path at real mesh
sizes and depths (phase 17): 32 grids of 256 x 256 and 8 of 512 x 512
through encode_meshes_device at -qp 8, 11, 14, 15 and 16, every blob
equal to the host plane and two a depth to encode(), K1's tiled kernel
launched once a call and its direct gather never, K2's wide form at 15
and 16; the tiled K1 in each layout against its plain version, timed
beside the direct gather and over three tile sizes, and at the batch's
own shape beside the rows kernel; K2's wide form on the path's symbols
against its plain version, timed beside torch.bincount; and the -qp 15
batch's position_s split by
stage, with a host profile and a device trace. That the port's host codec
equals tpudraco's is what the CPU tests show
(tests/test_torch_host_codec.py, tests/test_torch_corpus.py); this script
imports nothing of it.

    python3 chip_smoke.py

Exits nonzero on any failure, and without a usable CUDA device. The last
line of standard output is {"ok": true, "device": {...}}; the line before
it lists every kernel with its launches on its path, its error against
its twin, both times, its bound (bytes moved once over 3.35 TB/s, or
integer operations over 67 Tops/s, whichever is larger) and, for the
histogram, the time of the one PyTorch call that computes the same
function; the lines before that hold phase 13's walls, sweep and knobs
(``corpus``), the three chain kernels' and their plain versions' device
times, launches, peak memory, bounds and shares and the end-to-end times
of phases 10-11 (``chains``), phase
12's (``single_mesh``) and phase 14's walls, launches and checks
(``sharded``), phase 15's (``narrow``) and phase 17's (``real_size``),
then phase 16's bench lines,
as the bench prints them; each kernel's entry also
counts its launches on the corpus (``launches_corpus``) and over the shard
axis of 4 (``launches_sharded``). K1 has an entry a layout:
``predict_residual`` (uint16, launched on the batch path at -qp 15),
``predict_residual_p12`` (the main path) and ``predict_residual_u8``
(-qp 8), each also at phase 12's row (``*_long_row``, the tiled
kernel), and phase 17's ``predict_residual_tiled*`` (a layout and a
batch shape each) and ``histogram_wide*`` entries. K1's and K2's
times are medians of BATCHES batches of 50 launches; K4's twin runs
once, over the path's 512 lanes and 512 lanes of random (freq, cum) pairs
together, which take the kernel's exact path.
The full report (ptxas resources, every timing run, the device trace
summary) goes to standard error as one JSON line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, GRID, SEED, BITS = 512, 64, 1, 11
K3_LANES, K3_T = 512, 2048
LANE_P = 12  # bench.py bench_decode: per-lane tables at precision 12
BATCHES = 7  # timing batches of the kernels that take tens of microseconds
# published peaks of one H100 SXM: device memory, and float32 outside the
# tensor cores, which stands in for the int32 rate of these integer kernels
HBM_BYTES_S, ALU_OPS_S = 3.35e12, 67e12
# integer operations a kernel does per element, counted from its source
NORMAL_BITS, UV_BITS = 8, 10     # the default -qn and -qt
DEEP_BATCH, DEEP_QP, DEEP_QN, DEEP_QT = 32, 18, 16, 16
FLOAT_CASES = 1 << 22
# phase 12: one grid of HUGE_GRID x HUGE_GRID vertices (above the 2^19
# vertices at which the reference's router calls a lone mesh huge),
# streamed in chunks of HUGE_CHUNK rows
HUGE_GRID, HUGE_CHUNK = 1024, 1 << 15
# and a FAN_GRID x FAN_GRID grid with one vertex of valence FAN (a CAD
# tessellation's fan cap), which widens every normal ring to FAN slots:
# the widest ring the device chain takes at -qp 11 is 85
FAN_GRID, FAN = 512, 80
# phase 9 holds C1-C3 to their plain versions also on FAN_BATCH grids of
# (FAN + 1)^2 with a fan vertex of valence FAN, and on RISKY_BATCH meshes
# of the batch with positions and UVs past the UV chain's int64 headroom
FAN_BATCH, RISKY_BATCH = 16, 32
# phase 13: the corpus on disk. The batch cell's BATCH meshes with normals
# and UVs (GLB), CORPUS_GROUPS topologies of CORPUS_GROUP_N meshes of
# CORPUS_GRID x CORPUS_GRID (PLY), CORPUS_SINGLES single meshes of as many
# grid sizes (OBJ) and one LONE_GRID x LONE_GRID grid, positions only, above
# the lone-mesh threshold of the router (PLY); CORPUS_WORKERS file threads.
# The router's sweep runs encode_meshes_device at 1, 2, 4 ... SWEEP_MAX
# meshes; the transcode corpus is TRANSCODE_FILES GLBs of 2-4 primitives
# drawn from TRANSCODE_TOPOLOGIES grids; phase 13.6 runs the CLI with
# CLI_DEVICE_ARGS (none: the card).
CORPUS_GROUPS, CORPUS_GROUP_N, CORPUS_GRID = 7, 32, 32
CORPUS_SINGLES, LONE_GRID, CORPUS_WORKERS = 24, 768, 8
SWEEP_MAX, SWEEP_HOST_MESHES = 512, 16
TRANSCODE_FILES, TRANSCODE_TOPOLOGIES, TRANSCODE_POOL = 64, 8, 16
CLI_DEVICE_ARGS: list = []
# phase 14: shard axes of SHARDS entries for the batch cell (the card
# repeated where the machine has fewer cards), STREAM_SHARDS for the
# single mesh, and the corpus in two processes on MH_DEVICE (None: each
# rank's card) with a timeout of MH_TIMEOUT_S each
SHARDS, STREAM_SHARDS = (2, 4), 4
MH_DEVICE, MH_TIMEOUT_S = None, 300
ROUTER_KNOBS = ("MIN_DEVICE_GROUP", "PROBE_SKIP_S", "PROBE_CHUNK")
# a knob the sweep puts beyond this factor of the code's value is flagged
# as drifted on the corpus line
KNOB_DRIFT = 2.0
# phase 16: torchdraco.bench in its own process at BENCH_BATCH meshes, once
# a metric of BENCH_METRICS and once with --breakdown, each within
# BENCH_TIMEOUT_S, and bench_huge in this process on a BENCH_HUGE_N grid
BENCH_BATCH, BENCH_HUGE_N, BENCH_TIMEOUT_S = 64, 256, 300
BENCH_METRICS = ("corpus", "e2e", "step", "decode", "decode-corpus")
# phase 17: the main path at real mesh sizes and depths: batches of
# (meshes, grid) at each -qp of REAL_QP (8: uint8, 11: the pack, 14:
# uint16, 15-16: K2's wide bins), K1's tile sizes swept, and the -qp 15
# batch's position_s split by stage and host profile
REAL_BATCHES = ((32, 256), (8, 512))
REAL_QP = (8, 11, 14, 15, 16)
TILE_SWEEP = (1024, 2048, 4096)
OPS = {"predict_residual": 12, "histogram": 2, "rans_words_scan": 30,
       "rans_scan_dense": 30, "rans_decode_lanes": 30}


def _busy_us(spans) -> float:
    """The union of a trace's device intervals ((start, end, ...) in us)."""
    busy, edge = 0.0, float("-inf")
    for a, b, *_ in sorted(spans):
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    return busy


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import torchdraco
    from torchdraco import native
    from torchdraco.decode import decode
    from torchdraco.encode import encode
    from torchdraco.entropy.rans import (RansDecoder, RansEncoder,
                                         normalize_freq_counts,
                                         normalize_freq_counts_batch)
    from torchdraco.ops import _build, reset_launch_counts
    from torchdraco.ops import device as tdev
    from torchdraco.ops import rans_lanes as trl
    from torchdraco.parallel import batch as tbatch
    from torchdraco.parallel import decode_batch as tdb
    from torchdraco.wire.byte_io import ByteReader

    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    report: dict = {}

    def cuda_ms(fn, reps: int) -> float:
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def cuda_ms_batches(fn, reps: int = 50) -> dict:
        """Median, least and most of BATCHES means of ``reps`` launches."""
        runs = sorted(cuda_ms(fn, reps) for _ in range(BATCHES))
        return {"median": runs[len(runs) // 2], "min": runs[0],
                "max": runs[-1]}

    def wall_s(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def max_abs_err(a, b) -> int:
        _check(a.shape == b.shape, f"shape {tuple(a.shape)} vs "
               f"{tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max().item()) if d.numel() else 0

    def kernel_only_ms(fn, name: str, reps: int = 3) -> float:
        """Device time of the CUDA kernel whose name holds ``name``, per
        call of ``fn``, from a profiler trace: the wrapper's tensor
        operations and readbacks around the launch are left out."""
        fn()
        sync()
        for attempt in range(5):  # a trace may miss launches, at times all
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps * (attempt + 1)):
                    fn()
                sync()
            us = [e.time_range.end - e.time_range.start
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and name in e.name]
            if us:
                return sum(us) / 1e3 / len(us)
        # the tracer lost this kernel five times over: the wrapper's time
        # by CUDA events stands in (an upper bound), and the report says so
        report.setdefault("kernel_only_ms_from_events", []).append(name)
        return cuda_ms(fn, reps)

    def nbytes(*tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def bound(moved_bytes: int, operations: int) -> dict:
        """The least time the card could take: each input byte read once
        and each output byte written once at HBM_BYTES_S, or the integer
        operations at ALU_OPS_S, whichever is larger."""
        b_ms = moved_bytes / HBM_BYTES_S * 1e3
        o_ms = operations / ALU_OPS_S * 1e3
        return {"bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "bytes": int(moved_bytes), "operations": int(operations)}

    # ---- phase 1: the card, the stack, the kernel build -----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    t_start = time.perf_counter()
    _, build_s = wall_s(_build.load)
    ptxas = [ln.strip() for ln in _build.build_info.get("ptxas", "")
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    report["card"] = smi_line
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    report["kernel_build_s"] = build_s
    report["ptxas"] = ptxas
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; kernels built and loaded in "
          f"{build_s:.2f} s")

    # ---- slice data: 512 meshes of 64 x 64, one topology ---------------
    positions, faces = torchdraco.make_mesh_batch(BATCH, GRID, SEED)
    meshes = torchdraco.build_meshes(positions, faces)
    mb_in = positions.nbytes / 1e6
    topo = tbatch.PreparedTopology(meshes[0])
    pos_att = meshes[0].position_attribute()
    g_np = tbatch.topology_gathers_np(topo, pos_att)
    gathers = tbatch.gathers_to_torch(g_np, dev)
    q_up, _, _, vmin, vmax = native.quantize_batch(positions, BITS)
    q_dev = torch.from_numpy(q_up).to(dev)
    vmin_dev = torch.from_numpy(vmin).to(dev)
    vmax_dev = torch.from_numpy(vmax).to(dev)
    bins = tdev.default_hist_bins(BITS)

    # ---- phase 2: each kernel against its twin, exact -------------------
    errs = {}
    sym = tdev.predict_residual(q_dev, gathers, vmin_dev, vmax_dev)
    sync()
    errs["predict_residual"] = max_abs_err(
        sym, tdev.predict_residual_ref(q_dev, gathers, vmin_dev, vmax_dev))
    q_i32 = q_dev.to(torch.int32)
    k1_errs = [errs["predict_residual"], max_abs_err(
        tdev.predict_residual(q_i32, gathers, vmin_dev, vmax_dev), sym)]
    del q_i32
    rng_k1 = np.random.default_rng(SEED + 1)
    big_v = 1 << 17  # 768 KB of uint16 q a mesh: the tiled kernel
    _check(tdev.predict_fits_smem(q_dev.shape[1], 3, 2)
           and tdev.predict_fits_smem(q_dev.shape[1], 3, 4)
           and tdev.predict_form(big_v, 3, 2) == "tiled", "K1 kernel choice")
    big_q = torch.from_numpy(rng_k1.integers(
        0, 1 << BITS, size=(8, big_v, 3)).astype(np.uint16)).to(dev)
    big_g = {name: torch.from_numpy(rng_k1.integers(
        0, big_v, size=g.numel()).astype(np.int32)).to(dev)
        if g.dtype == torch.int32 else g for name, g in gathers.items()}
    big_lo = torch.zeros(8, dtype=torch.int32, device=dev)
    big_hi = torch.full((8,), (1 << BITS) - 1, dtype=torch.int32, device=dev)
    k1_errs.append(max_abs_err(
        tdev.predict_residual(big_q, big_g, big_lo, big_hi),
        tdev.predict_residual_ref(big_q, big_g, big_lo, big_hi)))
    del big_q, big_g
    errs["predict_residual"] = max(k1_errs)
    flat = sym.view(BATCH, -1)
    h_errs = [max_abs_err(tdev.histogram(flat, bins),
                          tdev.bincount_kernel(flat, bins))]
    rng = np.random.default_rng(SEED)
    wide = tdev.default_hist_bins(16)  # past shared memory: global atomics
    _check(bins <= tdev.HIST_SMEM_MAX_BINS < wide, "histogram paths")
    rnd = torch.from_numpy(rng.integers(-9, wide + 9, size=(BATCH, 12288),
                                        dtype=np.int32)).to(dev)
    h_errs.append(max_abs_err(tdev.histogram(rnd, wide),
                              tdev.bincount_kernel(rnd, wide)))
    drop = torch.tensor([[-3, 0, 0, 5, wide + 7, wide - 1, -1, wide]],
                        dtype=torch.int32, device=dev)
    _check(tdev.histogram(drop, wide).sum().item() == 4
           and tdev.histogram(drop, 4096).sum().item() == 3,
           "histogram must drop out-of-range symbols")
    errs["histogram"] = max(h_errs)
    k3_syms = (rng.integers(0, 40, size=(K3_LANES, K3_T)) ** 2
               % 3000).astype(np.int32)
    k3_prec = (12 + np.arange(K3_LANES) % 9).astype(np.int32)
    k3_counts = np.stack([np.bincount(r, minlength=3000) for r in k3_syms])
    k3_dist, _ = normalize_freq_counts_batch(k3_counts, k3_prec)
    k3_cums = np.zeros_like(k3_dist)
    k3_cums[:, 1:] = np.cumsum(k3_dist[:, :-1], axis=1)
    k3_len = rng.integers(0, K3_T + 1, size=K3_LANES).astype(np.int32)
    k3_len[::7] = K3_T
    k3_args = [torch.from_numpy(a.astype(np.int32)).to(dev)
               for a in (k3_syms, k3_dist, k3_cums, k3_prec, k3_len)]
    words, meta = trl.rans_words_scan(*k3_args)
    sync()
    ref_w, ref_m = trl.rans_words_scan_ref(*k3_args)
    errs["rans_words_scan"] = max(max_abs_err(meta, ref_m),
                                  max_abs_err(words, ref_w))
    report["max_abs_err"] = errs
    _check(all(v == 0 for v in errs.values()), f"kernel != twin: {errs}")
    print(f"phase 2: kernels equal their twins exactly: K1 at "
          f"({BATCH}, {q_dev.shape[1]}, 3) uint16 and int32 (q rows in "
          f"shared memory) and at V={big_v} (tiled, random gathers); K2 at "
          f"{bins} bins (shared) and {wide} (wide) + drop case; K3 at "
          f"L={K3_LANES}, T={K3_T}, precisions {k3_prec.min()}-{k3_prec.max()}, ragged lengths")

    # ---- phase 3: the main path, counted --------------------------------
    enc = tbatch.BatchEncoder()
    patho0 = trl.encode_group_entropy_device.n_patho_lanes
    reset_launch_counts()
    blobs = enc.encode_meshes_device(meshes, entropy="device", device=dev)
    sync()
    launches = {fn.__name__: fn.n_launches for fn in
                (tdev.predict_residual, tdev.histogram, trl.rans_words_scan)}
    n_patho = trl.encode_group_entropy_device.n_patho_lanes - patho0
    report["launches"] = launches
    # K1 by upload layout: the main path's -qp 11 crosses as the 12-bit pack
    main_layouts = dict(tdev.predict_residual.n_launches_by_layout)
    report["k1_launches_by_layout"] = main_layouts
    _check(main_layouts["pack12"] == launches["predict_residual"] > 0,
           f"K1 on the main path did not read the 12-bit pack: "
           f"{main_layouts}")
    report["patho_lanes"] = n_patho
    _check(all(n > 0 for n in launches.values()),
           f"a kernel of the main path never launched: {launches}")
    # the entry points without ``device``: the card is the default
    reset_launch_counts()
    few = tbatch.BatchEncoder().encode_meshes_device(meshes[:8])
    few_dec = tdb.BatchDecoder().decode_blobs_shared_topology(
        blobs[:8], entropy="device")
    sync()
    default_launches = {fn.__name__: fn.n_launches for fn in (
        tdev.predict_residual, tdev.histogram, trl.rans_words_scan,
        trl.rans_decode_lanes)}
    report["launches_without_device_argument"] = default_launches
    _check(all(n > 0 for n in default_launches.values()),
           f"an entry point called without device did not reach its "
           f"kernel: {default_launches}")
    _check(few == blobs[:8] and all(
        np.array_equal(np.asarray(g.attributes[0].values),
                       np.asarray(decode(b).attributes[0].values))
        for g, b in zip(few_dec, blobs[:8])),
        "the default-device calls disagree with the main path")
    host_blobs = [tbatch.encode_with_topology(m, topo) for m in meshes]
    _check(len(blobs) == BATCH and all(isinstance(b, bytes) and len(b) > 0
                                       for b in blobs), "missing blobs")
    bad = [i for i, (a, b) in enumerate(zip(blobs, host_blobs)) if a != b]
    _check(not bad, f"{len(bad)} blobs differ from the host plane "
           f"(first {bad[:5]})")
    sample = list(range(0, BATCH, BATCH // 32))
    bad = [i for i in sample if blobs[i] != encode(meshes[i])]
    _check(not bad, f"blobs differ from the port's host encode(): {bad[:5]}")
    out_bytes = sum(len(b) for b in blobs)
    print(f"phase 3: {BATCH} meshes of {GRID}x{GRID} ({mb_in:.1f} MB f32 "
          f"positions) -> {out_bytes} B of .drc; all equal the host plane, "
          f"{len(sample)} sampled equal the port's host encode(); launches "
          f"{launches}; pathological lanes {n_patho}; 8 meshes encoded and "
          f"decoded without a device argument launched {default_launches}")

    # ---- phase 4: times --------------------------------------------------
    t = {}
    t["step_ms"] = cuda_ms(lambda: tdev.encode_step_from_q_cuda(
        q_dev, gathers, vmin_dev, vmax_dev, bits=BITS), reps=50)
    syms_dev, counts_dev = tdev.encode_step_from_q_cuda(
        q_dev, gathers, vmin_dev, vmax_dev, bits=BITS)
    ent = [wall_s(lambda: trl.encode_group_entropy_device(
        syms_dev, counts_dev))[1] for _ in range(3)]
    t["entropy_s"] = ent
    dev_runs, host_runs = [], []
    for _ in range(2):  # interleaved: device, host, device, host
        dev_runs.append(wall_s(lambda: enc.encode_meshes_device(
            meshes, device=dev))[1])
        host_runs.append(wall_s(lambda: [tbatch.encode_with_topology(m, topo)
                                         for m in meshes])[1])
    t["e2e_s"], t["host_plane_s"] = dev_runs, host_runs
    t["e2e_mb_s"] = mb_in / min(dev_runs)
    t["host_plane_mb_s"] = mb_in / min(host_runs)
    # where the e2e time goes, one group through the public pieces
    sig_s = wall_s(lambda: [tbatch.topology_signature(m)
                            for m in meshes])[1]
    quant_s = wall_s(lambda: native.quantize_batch(positions,
                                                         BITS))[1]
    dev_c, step_s = wall_s(lambda: tbatch.device_encode_group(
        positions, topo, pos_att, bits=BITS, device=dev))
    _, ent_s = wall_s(lambda: trl.encode_group_entropy_device(
        dev_c["symbols"][0], dev_c["counts"][0]))
    t["breakdown_s"] = {
        "topology_signatures": sig_s, "host_quantize": quant_s,
        "quantize_upload_step": step_s, "entropy": ent_s,
        "assembly_and_rest": min(dev_runs) - sig_s - step_s - ent_s}
    # kernels against their twins at the main path's shapes
    k = {}

    def run_k1():
        return tdev.predict_residual(q_dev, gathers, vmin_dev, vmax_dev)
    k1_runs = cuda_ms_batches(run_k1)
    k["predict_residual"] = (
        k1_runs["median"],
        cuda_ms(lambda: tdev.predict_residual_ref(q_dev, gathers, vmin_dev,
                                                  vmax_dev), 10))
    flat = syms_dev.view(BATCH, -1)
    k2_runs = cuda_ms_batches(lambda: tdev.histogram(flat, bins))
    k["histogram"] = (k2_runs["median"],
                      cuda_ms(lambda: tdev.bincount_kernel(flat, bins), 10))
    alone = {"predict_residual": kernel_only_ms(run_k1, "predict_rows_kernel",
                                                reps=20),
             "histogram": kernel_only_ms(
                 lambda: tdev.histogram(flat, bins), "histogram_smem_kernel",
                 reps=20)}
    t["k1_ms_runs"], t["k2_ms_runs"] = k1_runs, k2_runs
    t["kernel_only_ms"] = dict(alone)
    bounds = {"predict_residual": bound(
        nbytes(q_dev, vmin_dev, vmax_dev, syms_dev, *gathers.values()),
        OPS["predict_residual"] * syms_dev.numel())}
    bounds["histogram"] = bound(nbytes(flat, counts_dev),
                                OPS["histogram"] * flat.numel())
    # the one PyTorch call that computes K2's function: a bincount of
    # symbols offset by row * bins (timed here, used nowhere in the port)
    row_off = (torch.arange(BATCH, device=dev) * bins)[:, None]

    def library_histogram():
        return torch.bincount((flat + row_off).view(-1),
                              minlength=BATCH * bins).view(BATCH, bins)
    _check(torch.equal(library_histogram(),
                       tdev.histogram(flat, bins).to(torch.int64)),
           "torch.bincount disagrees with K2 on the main path's symbols")
    library_ms = {"histogram": cuda_ms(library_histogram, 20)}
    dist, cums, prec, _ = trl.normalize_tables(counts_dev, flat.shape[1])
    lengths = torch.full((BATCH,), flat.shape[1], dtype=torch.int32,
                         device=dev)
    k3_ms = cuda_ms(lambda: trl.rans_words_scan(flat, dist, cums, prec,
                                                lengths), 5)
    (ref_w, ref_m), k3_ref_s = wall_s(lambda: trl.rans_words_scan_ref(
        flat, dist, cums, prec, lengths))
    w3, m3 = trl.rans_words_scan(flat, dist, cums, prec, lengths)
    _check(torch.equal(w3, ref_w) and torch.equal(m3, ref_m),
           "K3 != twin at the slice shape")
    k["rans_words_scan"] = (k3_ms, k3_ref_s * 1e3)
    bounds["rans_words_scan"] = bound(
        nbytes(flat, dist, cums, prec, lengths, m3)
        + 4 * int(m3[:, 0].sum().item()),
        OPS["rans_words_scan"] * int(lengths.sum().item()))
    k3_prec_range = (int(prec.min().item()), int(prec.max().item()))
    t["kernel_ms"] = k
    report["times"] = t
    print(f"phase 4: fused step on resident data {t['step_ms']:.3f} ms; "
          f"entropy stage {min(ent) * 1e3:.1f} ms; e2e "
          f"{t['e2e_mb_s']:.1f} MB/s (runs {[round(x, 3) for x in dev_runs]}"
          f" s) vs host plane {t['host_plane_mb_s']:.1f} MB/s (runs "
          f"{[round(x, 3) for x in host_runs]} s); breakdown "
          f"{ {a: round(b, 4) for a, b in t['breakdown_s'].items()} }; "
          f"kernel/twin ms { {a: (round(b, 4), round(c, 4)) for a, (b, c) in k.items()} }"
          f"; K1 median of {BATCHES} x 50 launches {k1_runs['median']:.4f} "
          f"({k1_runs['min']:.4f}-{k1_runs['max']:.4f}) ms, alone "
          f"{alone['predict_residual']:.4f} ms; K2 {k2_runs['median']:.4f} "
          f"({k2_runs['min']:.4f}-{k2_runs['max']:.4f}) ms, alone "
          f"{alone['histogram']:.4f} ms")

    # ---- phase 5: device trace of one warm e2e run ----------------------
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_wall = wall_s(lambda: enc.encode_meshes_device(meshes,
                                                               device=dev))
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    busy_us = _busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    report["trace"] = {"wall_ms": prof_wall * 1e3, "device_busy_ms":
                       busy_us / 1e3, "n_device_events": len(spans),
                       "top_device_ms": top}
    idle = (f"{1 - busy_us / 1e3 / (prof_wall * 1e3):.4f}" if spans
            else "not measured (the trace holds no device events)")
    print(f"phase 5: traced e2e {prof_wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms over {len(spans)} device events, idle "
          f"share {idle}; top device ms "
          f"{[(n[:40], round(v, 3)) for n, v in top[:5]]}")

    # ---- phase 6: the lane coder (K3, K4) and decoder (D1), full width --
    # bench_decode's recipe: the fused step's symbols, one table per lane
    # at precision 12, lanes fed reversed, every lane at full length
    flat_np = syms_dev.view(BATCH, -1).cpu().numpy()
    n_sym = flat_np.shape[1]
    cnt_np = counts_dev.cpu().numpy()
    dists = [normalize_freq_counts(c[:np.flatnonzero(c)[-1] + 1],
                                         LANE_P) for c in cnt_np]
    s6 = 16
    while s6 < max(len(d) for d in dists):
        s6 *= 2
    freqs6 = np.zeros((BATCH, s6), np.int32)
    cums6 = np.zeros((BATCH, s6), np.int32)
    for i, d in enumerate(dists):
        freqs6[i, :len(d)] = d
        cums6[i, 1:len(d)] = np.cumsum(d)[:-1]
    lanes_np = np.ascontiguousarray(flat_np[:, ::-1]).astype(np.int32)
    lanes_dev = torch.from_numpy(lanes_np).to(dev)
    f6, c6 = (torch.from_numpy(a).to(dev) for a in (freqs6, cums6))
    len6 = torch.full((BATCH,), n_sym, dtype=torch.int32, device=dev)
    cnt6 = torch.full((BATCH,), n_sym, dtype=torch.int32, device=dev)
    reset_launch_counts()
    (bufs_d, nb_d), dense_s = wall_s(lambda: trl.rans_encode_lanes(
        lanes_dev, f6, c6, len6, precision=LANE_P, dense=True))
    (bufs_w, nb_w), words_s = wall_s(lambda: trl.rans_encode_lanes(
        lanes_dev, f6, c6, len6, precision=LANE_P))
    bufs6 = torch.from_numpy(bufs_d).to(dev)
    nb6 = torch.from_numpy(nb_d).to(dev)
    out6, d1_first_s = wall_s(lambda: trl.rans_decode_lanes(
        bufs6, nb6, f6, cnt6, precision=LANE_P))
    launches6 = {fn.__name__: fn.n_launches for fn in
                 (trl.rans_words_scan, trl.rans_scan_dense,
                  trl.rans_decode_lanes)}
    report["launches_phase6"] = launches6
    _check(all(n > 0 for n in launches6.values()),
           f"a kernel of the lane path never launched: {launches6}")
    _check(np.array_equal(bufs_d, bufs_w) and np.array_equal(nb_d, nb_w),
           "the dense (K4) and words (K3) engines differ")
    host_blobs6, host_enc_s = wall_s(lambda: [
        _host_rans_encode(RansEncoder, d, lane)
        for d, lane in zip(dists, lanes_np)])
    bad = [i for i in range(BATCH)
           if bufs_d[i, :nb_d[i]].tobytes() != host_blobs6[i]]
    _check(not bad, f"{len(bad)} lanes differ from the host RansEncoder "
           f"(first {bad[:5]})")
    _check(np.array_equal(out6.cpu().numpy().astype(np.int64), flat_np),
           "D1 did not give every lane back")

    def host_decode_lanes():
        for i in range(BATCH):
            blob = host_blobs6[i]
            RansDecoder(ByteReader(blob), len(blob), dists[i],
                        precision=LANE_P).read_all(n_sym)
    # D1 with its copies: streams up as numpy, symbols back as numpy
    d1_copies = [wall_s(lambda: trl.rans_decode_lanes(
        torch.from_numpy(bufs_d).to(dev), nb_d, f6, cnt6,
        precision=LANE_P).cpu().numpy())[1] for _ in range(3)]
    d1_s = min(d1_copies)
    host_decode_lanes()  # warm: loads the native library
    host_dec_s = min(wall_s(host_decode_lanes)[1] for _ in range(2))
    # K4 and D1 against their twins on the inputs of the runs above
    # the dense engine's own pre-gather: int32 (freq, cum) a symbol
    fs_full, cs_full = trl.lane_tables_gather(lanes_dev, f6, c6,
                                              dtype=torch.int32)
    # one call of each over 2 x BATCH lanes: the path's own, then random
    # (freq, cum) pairs with frequency 0 on every 17th step and ragged
    # lengths, under which the state leaves the coder's range and the
    # kernel must take its exact path. The twin's time is that of its
    # n_sym steps, whatever the lanes.
    rng4 = np.random.default_rng(SEED + 4)
    fs_rand = (rng4.integers(0, 1 << LANE_P, size=(BATCH, n_sym))
               // rng4.integers(1, 300, size=(BATCH, n_sym))).astype(np.int32)
    fs_rand[:, ::17] = 0
    cs_rand = rng4.integers(0, 1 << LANE_P, size=(BATCH, n_sym),
                            dtype=np.int32)
    len_rand = rng4.integers(-3, n_sym + 5, size=BATCH).astype(np.int32)
    fs_both = torch.cat([fs_full, torch.from_numpy(fs_rand).to(dev)])
    cs_both = torch.cat([cs_full, torch.from_numpy(cs_rand).to(dev)])
    len_both = torch.cat([len6, torch.from_numpy(len_rand).to(dev)])
    del fs_rand, cs_rand
    guard = torch.full((2 * BATCH,), -1, dtype=torch.int32, device=dev)
    guard_ref = torch.empty_like(guard)
    k4 = trl.rans_scan_dense(fs_both, cs_both, len_both, LANE_P,
                             guard_steps=guard)
    sync()
    k4_ref, k4_full_ref_s = wall_s(lambda: trl.rans_scan_dense_ref(
        fs_both, cs_both, len_both, LANE_P, guard_steps=guard_ref))
    k4_full_err = max(max_abs_err(a[:BATCH], b[:BATCH])
                      for a, b in zip(k4, k4_ref))
    k4_rand_err = max([max_abs_err(a[BATCH:], b[BATCH:])
                       for a, b in zip(k4, k4_ref)]
                      + [max_abs_err(guard, guard_ref)])
    k4_guard = {"path_lanes": int(guard[:BATCH].sum().item()),
                "random_pair_lanes": int(guard[BATCH:].sum().item()),
                "random_pair_steps": int(np.clip(len_rand, 0, n_sym).sum())}
    _check(k4_guard["path_lanes"] == 0 and k4_guard["random_pair_lanes"] > 0,
           f"K4's exact path: {k4_guard}")
    del k4, k4_ref, fs_both, cs_both
    d1_ref, d1_full_ref_s = wall_s(lambda: trl.rans_decode_lanes_ref(
        bufs6, nb6, f6, cnt6, precision=LANE_P))
    _check(out6.dtype == d1_ref.dtype, f"D1 dtype {out6.dtype} vs twin "
           f"{d1_ref.dtype} (full shape)")
    d1_full_err = max_abs_err(out6, d1_ref)
    del d1_ref
    # K3 at one precision for every lane (the lane coder's call)
    prec_full = torch.full((BATCH,), LANE_P, dtype=torch.int32, device=dev)
    flipped = lanes_dev.flip(1)
    k3_full = trl.rans_words_scan(flipped, f6, c6, prec_full, len6)
    sync()
    k3_full_ref, k3_full_ref_s = wall_s(lambda: trl.rans_words_scan_ref(
        flipped, f6, c6, prec_full, len6))
    k3_full_err = max(max_abs_err(a, b)
                      for a, b in zip(k3_full, k3_full_ref))
    del k3_full, k3_full_ref
    errs["rans_words_scan"] = max(errs["rans_words_scan"], k3_full_err)
    _check(k4_full_err == 0 and k4_rand_err == 0 and d1_full_err == 0
           and k3_full_err == 0,
           f"kernel != twin at the lane shape: K4 {k4_full_err} (random "
           f"pairs {k4_rand_err}), D1 {d1_full_err}, K3 {k3_full_err}")
    # edge cases at T = K3_T: ragged and zero lengths, D1 through the
    # packed dtypes (P = 12) and the generic ones (P = 20, one shared table)
    rng6 = np.random.default_rng(SEED + 6)
    short = lanes_dev[:, :K3_T].contiguous()
    ln_s = rng6.integers(0, K3_T + 1, size=BATCH).astype(np.int32)
    ln_s[::5], ln_s[1::5] = K3_T, 0
    ln_dev = torch.from_numpy(ln_s).to(dev)
    fs_s, cs_s = trl.lane_tables_gather(short, f6, c6, dtype=torch.int32)
    k4 = trl.rans_scan_dense(fs_s, cs_s, ln_dev, LANE_P)
    sync()
    k4_ref, k4_ref_s = wall_s(lambda: trl.rans_scan_dense_ref(
        fs_s, cs_s, ln_dev, LANE_P))
    errs["rans_scan_dense"] = max([k4_full_err, k4_rand_err] + [
        max_abs_err(a, b) for a, b in zip(k4, k4_ref)])
    d1_cases = {}
    b12, n12 = trl.rans_encode_lanes(short, f6, c6, ln_dev, precision=LANE_P)
    d1_cases["p12"] = ((torch.from_numpy(b12).to(dev), n12, f6, ln_s),
                       LANE_P)
    wide = rng6.integers(0, 3000, size=(BATCH, K3_T)) ** 2 % 3000
    d20 = normalize_freq_counts(np.bincount(wide.ravel(),
                                                  minlength=3000), 20)
    c20 = np.concatenate([[0], np.cumsum(d20)[:-1]])
    b20, n20 = trl.rans_encode_lanes(
        torch.from_numpy(wide.astype(np.int32)).to(dev), d20, c20, ln_s,
        precision=20)
    d1_cases["p20"] = ((torch.from_numpy(b20).to(dev), n20, d20, ln_s), 20)
    d1_err, d1_ref_s, d1_dtypes = d1_full_err, {}, {}
    for name, (args, prec) in d1_cases.items():
        got = trl.rans_decode_lanes(*args, precision=prec)
        sync()
        want, d1_ref_s[name] = wall_s(lambda: trl.rans_decode_lanes_ref(
            *args, precision=prec))
        _check(got.dtype == want.dtype, f"D1 dtype {got.dtype} vs twin "
               f"{want.dtype} ({name})")
        d1_dtypes[name] = str(got.dtype)
        d1_err = max(d1_err, max_abs_err(got, want))
    errs["rans_decode_lanes"] = d1_err
    _check(errs["rans_scan_dense"] == 0 and d1_err == 0,
           f"kernel != twin: {errs}")
    # card times: the two engines end to end, in turns; full shape
    # (kernels) and the twins' shape
    engine_s: dict = {"dense": [], "words": []}
    for order in (("dense", "words"), ("words", "dense")):
        for eng in order:
            engine_s[eng].append(wall_s(lambda: trl.rans_encode_lanes(
                lanes_dev, f6, c6, len6, precision=LANE_P,
                dense=eng == "dense"))[1])
    t6 = {
        "k4_full_ms": cuda_ms(lambda: trl.rans_scan_dense(
            fs_full, cs_full, len6, LANE_P), 5),
        "k3_full_ms": cuda_ms(lambda: trl.rans_words_scan(
            flipped, f6, c6, prec_full, len6), 5),
        "d1_full_ms": cuda_ms(lambda: trl.rans_decode_lanes(
            bufs6, nb6, f6, cnt6, precision=LANE_P), 5),
        "kernel_only_ms": {
            "rans_words_kernel": kernel_only_ms(lambda: trl.rans_words_scan(
                flipped, f6, c6, prec_full, len6), "rans_words_kernel"),
            "rans_dense_kernel": kernel_only_ms(lambda: trl.rans_scan_dense(
                fs_full, cs_full, len6, LANE_P), "rans_dense_kernel"),
            "rans_decode_kernel": kernel_only_ms(
                lambda: trl.rans_decode_lanes(
                    bufs6, nb6, f6, cnt6, precision=LANE_P),
                "rans_decode_kernel")},
        "k3_twin_full_ms": k3_full_ref_s * 1e3,
        "k4_short_ms": cuda_ms(lambda: trl.rans_scan_dense(
            fs_s, cs_s, ln_dev, LANE_P), 10),
        "d1_short_ms": cuda_ms(lambda: trl.rans_decode_lanes(
            *d1_cases["p12"][0], precision=LANE_P), 10),
        "zero_freq_check_ms": cuda_ms(lambda: trl.zero_frequency_hit(
            lanes_dev, f6, len6), 20),
        "zero_freq_check_wall_ms": 1e3 * min(wall_s(lambda: bool(
            trl.zero_frequency_hit(lanes_dev, f6, len6)))[1]
            for _ in range(20)),
        "k4_twin_full_ms": k4_full_ref_s * 1e3,
        "d1_twin_full_ms": d1_full_ref_s * 1e3,
        "k4_twin_short_ms": k4_ref_s * 1e3,
        "d1_twin_short_ms": {a: b * 1e3 for a, b in d1_ref_s.items()},
        "encode_lanes_dense_s": [dense_s] + engine_s["dense"],
        "encode_lanes_words_s": [words_s] + engine_s["words"],
        "decode_lanes_first_call_s": d1_first_s,
        "decode_lanes_with_copies_s": d1_copies,
        "host_rans_encode_s": host_enc_s,
        "host_rans_decode_s": host_dec_s}
    report["phase6"] = {**t6, "d1_dtypes": d1_dtypes, "lane_alphabet": s6,
                        "k4_exact_path_steps": k4_guard}
    alone.update(rans_words_scan=t6["kernel_only_ms"]["rans_words_kernel"],
                 rans_scan_dense=t6["kernel_only_ms"]["rans_dense_kernel"])
    k["rans_scan_dense"] = (t6["k4_full_ms"], t6["k4_twin_full_ms"])
    coded = int(len6.sum().item())
    bounds["rans_scan_dense"] = bound(
        2 * 4 * fs_full.numel() + nbytes(len6) + 2 * 3 * fs_full.numel()
        + 4 * BATCH, OPS["rans_scan_dense"] * coded)
    bounds["rans_words_scan_p12"] = bound(
        nbytes(flipped, f6, c6, prec_full, len6) + 4 * 5 * BATCH
        + 4 * (int(nb_w.sum()) // 4), OPS["rans_words_scan"] * coded)
    # D1's own inputs and outputs: the streams' bytes, one table a lane
    # (the frequencies), the per-lane scalars, the symbols
    bounds["rans_decode_lanes_p12"] = bound(
        int(nb_d.sum()) + nbytes(f6, nb6, cnt6, out6),
        (OPS["rans_decode_lanes"] + (s6 - 1).bit_length()) * coded)
    report["phase6"]["bounds"] = {
        a: bounds[a] for a in ("rans_words_scan_p12",
                               "rans_decode_lanes_p12")}
    print(f"phase 6: {BATCH} lanes x {n_sym} symbols at P={LANE_P} "
          f"(alphabet {s6}): K4 and K3 engines give identical buffers, "
          f"all equal the host RansEncoder, D1 gives every lane back, K4 "
          f"and D1 equal their twins there and at T={K3_T} (ragged, zero, "
          f"P=20 shared); K4 equals its twin on {BATCH} lanes of random "
          f"pairs, {k4_guard['random_pair_lanes']} of "
          f"{k4_guard['random_pair_steps']} steps on its exact path (0 on "
          f"the path's lanes); launches {launches6}; K4/K3/D1 at full shape "
          f"{t6['k4_full_ms']:.3f} / {t6['k3_full_ms']:.3f} / "
          f"{t6['d1_full_ms']:.3f} ms, twins K4 "
          f"{t6['k4_twin_full_ms']:.1f} / K3 {t6['k3_twin_full_ms']:.1f} / "
          f"D1 {t6['d1_twin_full_ms']:.1f} ms; bounds K3 "
          f"{bounds['rans_words_scan_p12']['bound_ms']:.4f} / D1 "
          f"{bounds['rans_decode_lanes_p12']['bound_ms']:.4f} ms; the "
          f"kernels alone (device trace) "
          f"{ {a: round(b, 3) for a, b in t6['kernel_only_ms'].items()} } ms"
          f"; zero-frequency check {t6['zero_freq_check_ms']:.4f} ms "
          f"(with its readback {t6['zero_freq_check_wall_ms']:.4f} ms); "
          f"at L={BATCH}, T={K3_T} K4 "
          f"{t6['k4_short_ms']:.3f} ms vs twin {k4_ref_s * 1e3:.1f} ms, D1 "
          f"{t6['d1_short_ms']:.3f} ms vs twin "
          f"{ {a: round(b * 1e3, 1) for a, b in d1_ref_s.items()} } ms "
          f"(dtypes {d1_dtypes}); rans_encode_lanes dense "
          f"{[round(x * 1e3, 1) for x in t6['encode_lanes_dense_s']]} ms, "
          f"words {[round(x * 1e3, 1) for x in t6['encode_lanes_words_s']]}"
          f" ms; D1 with its copies "
          f"{[round(x * 1e3, 1) for x in d1_copies]} ms (its first call, "
          f"resident inputs, {d1_first_s * 1e3:.1f} ms); host RansEncoder "
          f"{host_enc_s:.3f} s, RansDecoder {host_dec_s:.3f} s over the "
          f"same lanes")

    # ---- phase 7: BatchDecoder(entropy="device") over phase 3's blobs ---
    bd = tdb.BatchDecoder()
    d1_calls = []  # (args, kwargs, output) of every D1 call of the run
    real_d1 = tdb.rans_decode_lanes

    def recorded_d1(*a, **kw):
        out = real_d1(*a, **kw)
        d1_calls.append((a, kw, out))
        return out
    tdb.rans_decode_lanes = recorded_d1
    reset_launch_counts()
    try:
        decoded, dev_dec_s = wall_s(lambda: bd.decode_blobs_shared_topology(
            blobs, entropy="device", device=dev))
    finally:
        tdb.rans_decode_lanes = real_d1
    launches7 = {fn.__name__: fn.n_launches for fn in
                 (trl.rans_decode_lanes,)}
    report["launches_phase7"] = launches7
    _check(launches7["rans_decode_lanes"] > 0,
           "BatchDecoder(entropy='device') never launched D1")
    _check(bd.n_host_blobs == 0, f"{bd.n_host_blobs} blobs went to the host")
    stages7 = dict(bd.timings)
    # D1 against its twin on each call's own per-lane P = 19-20 tables
    chunks7 = []
    for a, kw, got in d1_calls:
        prec = kw["precision"]
        d1_ms = cuda_ms(lambda: real_d1(*a, **kw), 3)
        want, twin_s = wall_s(lambda: trl.rans_decode_lanes_ref(*a, **kw))
        _check(got.dtype == want.dtype, f"D1 dtype {got.dtype} vs twin "
               f"{want.dtype} (P={prec}, phase 7)")
        err = max_abs_err(got, want)
        lanes7, S7 = int(a[0].shape[0]), int(a[2].shape[-1])
        n7 = int(np.asarray(a[3]).sum())
        alone_ms = kernel_only_ms(lambda: real_d1(*a, **kw),
                                  "rans_decode_kernel")
        chunks7.append({"precision": prec, "lanes": lanes7,
                        "T": int(got.shape[1]), "S": S7,
                        "per_lane": a[2].dim() == 2,
                        "max_abs_err": err, "ms": d1_ms,
                        "kernel_only_ms": alone_ms,
                        "twin_ms": twin_s * 1e3,
                        **bound(int(np.asarray(a[1]).sum())
                                + nbytes(a[2], got) + 2 * 4 * lanes7,
                                (OPS["rans_decode_lanes"]
                                 + (S7 - 1).bit_length()) * n7)})
        errs["rans_decode_lanes"] = max(errs["rans_decode_lanes"], err)
        del want
    del d1_calls
    _check(errs["rans_decode_lanes"] == 0,
           f"D1 != twin on phase 7's streams: {chunks7}")
    refs, host_ref_s = wall_s(lambda: [decode(b) for b in blobs])
    bad = [i for i, (g, r) in enumerate(zip(decoded, refs))
           if g is None or not np.array_equal(g.faces, r.faces)
           or len(g.attributes) != len(r.attributes)
           or not all(np.array_equal(np.asarray(a.values),
                                     np.asarray(b.values))
                      for a, b in zip(g.attributes, r.attributes))]
    _check(not bad, f"{len(bad)} decoded meshes differ from "
           f"the port's host decode() (first {bad[:5]})")
    dev_runs7, host_runs7 = [dev_dec_s], []
    stages_runs7 = [stages7]
    for _ in range(3):  # in turns: host, device, host, device, ...
        host_runs7.append(wall_s(lambda: tdb.BatchDecoder()
                                 .decode_blobs_shared_topology(blobs))[1])
        dev_runs7.append(wall_s(lambda: bd.decode_blobs_shared_topology(
            blobs, entropy="device", device=dev))[1])
        stages_runs7.append(dict(bd.timings))
    # D1's line in the table: the group decode's largest call
    main7 = max(chunks7, key=lambda c: c["lanes"] * c["T"])
    k["rans_decode_lanes"] = (main7["ms"], main7["twin_ms"])
    alone["rans_decode_lanes"] = main7["kernel_only_ms"]
    bounds["rans_decode_lanes"] = {a: main7[a] for a in (
        "bound_ms", "bound_by", "bytes", "operations")}
    report["phase7"] = {"device_s": dev_runs7, "host_s": host_runs7,
                        "per_blob_decode_s": host_ref_s,
                        "stages_by_device_run_s": stages_runs7,
                        "d1_calls": chunks7}
    print(f"phase 7: BatchDecoder(entropy='device') decoded {BATCH} blobs, "
          f"all equal the port's host decode(), 0 host blobs, no slot table "
          f"built or uploaded, launches "
          f"{launches7}; D1 equals its twin on every call's per-lane tables "
          f"{[(c['precision'], c['lanes'], c['S'], round(c['ms'], 3), round(c['kernel_only_ms'], 3), round(c['twin_ms'], 1), round(c['bound_ms'], 4)) for c in chunks7]}"
          f" (P, lanes, S, wrapper ms, kernel alone ms, twin ms, bound "
          f"ms); device entropy "
          f"{[round(x, 3) for x in dev_runs7]} "
          f"s vs host entropy {[round(x, 3) for x in host_runs7]} s "
          f"(per-blob decode() {host_ref_s:.3f} s); stages "
          f"{ {a: round(b, 4) for a, b in bd.timings.items()} }")

    # ---- phase 8: the card's float32 arithmetic against numpy, bitwise ----
    from torchdraco.ops import normals as tnorm
    from torchdraco.ops import texcoords as ttex

    rng8 = np.random.default_rng(SEED + 8)

    def spread(n, lo, hi):
        return rng8.standard_normal(n) * 2.0 ** rng8.integers(lo, hi, n)
    half_k = rng8.integers(0, 1 << 15, 1 << 16) + 0.5  # k + .5 over scales
    half_s = rng8.choice([63.0, 127.0, 2047.0, 16383.0, 32767.0], 1 << 16)
    ints_a = rng8.integers(-(1 << 29), 1 << 29, 1 << 18)   # ring totals
    ints_b = rng8.integers(1, 1 << 30, 1 << 18)
    pw = 2.0 ** rng8.integers(-60, 61, 1 << 12)
    fa = np.concatenate([spread(FLOAT_CASES, -30, 31), half_k, half_k,
                         spread(1 << 14, -126, -110), ints_a, pw,
                         [0.0, -0.0, 1.0, 3.0, 2.0 ** -149]])
    fb = np.concatenate([spread(FLOAT_CASES, -30, 31), half_s, 1.0 / half_s,
                         spread(1 << 14, 10, 20), ints_b, pw[::-1],
                         [5.0, 7.0, 3.0, 1.0, 3.0]])
    fa, fb = fa.astype(np.float32), fb.astype(np.float32)
    fb[fb == 0] = np.float32(1.0)
    fc = np.roll(fa, 7)
    ta, tb, tc = (torch.from_numpy(x).to(dev) for x in (fa, fb, fc))

    def bits_differ(got, want) -> int:
        got = got.cpu().numpy()
        _check(got.dtype == np.float32 and want.dtype == np.float32
               and not np.isnan(want).any(), "float phase operands")
        return int((got.view(np.int32) != want.view(np.int32)).sum())
    with np.errstate(all="ignore"):
        n_sub = int(((np.abs(fa / fb) < 2.0 ** -126) & (fa != 0)).sum())
        float_errs = {
            "div": bits_differ(ta / tb, fa / fb),
            "mul": bits_differ(ta * tb, fa * fb),
            "mul_then_add": bits_differ((ta * tb) + tc, (fa * fb) + fc),
            "sqrt": bits_differ(torch.sqrt(ta.abs()), np.sqrt(np.abs(fa))),
            "chain_div": bits_differ(tnorm._f32_div(ta, tb), fa / fb),
            "chain_sqrt": bits_differ(tnorm._f32_sqrt(ta.abs()),
                                      np.sqrt(np.abs(fa)))}
    report["phase8"] = {"values": int(fa.size), "subnormal_quotients": n_sub,
                        "bit_mismatches": float_errs}
    _check(fa.size >= FLOAT_CASES and n_sub > 1000
           and all(v == 0 for v in float_errs.values()),
           f"the card's float32 arithmetic differs from numpy: {float_errs}")
    del ta, tb, tc
    print(f"phase 8: float32 /, * then +, and sqrt on the card equal numpy "
          f"bit for bit on {fa.size} values ({n_sub} subnormal quotients, "
          f"{half_k.size * 2} quotients and products of k + .5 by the chains' "
          f"scales, "
          f"powers of two, integers to 2^29): mismatches {float_errs}")

    def traced(fn) -> dict:
        """One call of ``fn`` under a device trace: device events (kernel
        launches and copies), their busy time, and the peak of allocated
        device memory above what was held before. The tracer loses a
        short window's events at times: a trace under a second that
        caught none is taken again over 2, 4 ... 32 calls, each call's
        result dropped before the next, and its counts and times are a
        call's (``traced_calls`` says how many there were; None where
        every try lost every event)."""
        def calls_of(n):
            for _ in range(n):
                fn()
        fn()
        sync()
        for calls in (1, 2, 4, 8, 16, 32):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, wall = wall_s(lambda: calls_of(calls))
            peak = torch.cuda.max_memory_allocated() - base
            spans = [(e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if spans or wall > 1.0:
                break
        busy = _busy_us(spans)
        copies = sum(1 for _, _, name in spans
                     if "memcpy" in name.lower() or "memset" in name.lower())
        return {"wall_ms": wall * 1e3 / calls, "busy_ms": busy / 1e3 / calls,
                "launches": (len(spans) - copies) / calls if spans else None,
                "copies": copies / calls, "peak_bytes": int(peak),
                "traced_calls": calls if spans else None,
                "idle_share": (1 - busy / 1e3 / (wall * 1e3)) if spans
                else None}

    # ---- phase 9: C1-C3 against their plain versions, on the card and CPU
    normals3, uvs3 = torchdraco.make_normal_uv_batch(positions, GRID,
                                                     SEED + 2)
    meshes3 = torchdraco.build_meshes(positions, faces, normals3, uvs3)
    topo3 = tbatch.PreparedTopology(meshes3[0])
    T3 = len(topo3.rings_for(1)["tip_pt"])
    chains, k9 = _phase9(torch, np, torchdraco, native, tdev, tnorm, ttex,
                         tbatch, dev, sync, wall_s, cuda_ms, kernel_only_ms,
                         max_abs_err, nbytes, bound, traced, smi_line,
                         positions, q_up, normals3, uvs3, meshes3, topo3)
    errs.update({name: e["max_abs_err"] for name, e in k9.items()})
    torch.cuda.empty_cache()

    # ---- phase 10: encode_meshes_device, positions + normals + UVs -------
    mb_in3 = (positions.nbytes + normals3.nbytes + uvs3.nbytes) / 1e6
    enc3 = tbatch.BatchEncoder()
    reset_launch_counts()
    blobs3, enc3_first_s = wall_s(lambda: enc3.encode_meshes_device(meshes3))
    launches10 = {fn.__name__: fn.n_launches for fn in
                  (tdev.predict_residual, tdev.histogram, trl.rans_words_scan,
                   tnorm.normal_encode_cuda, ttex.uv_encode_cuda)}
    report["launches_phase10"] = launches10
    _check(all(n == 1 for n in launches10.values()),
           f"one chunk of {BATCH} meshes launches K1, K2, K3, C1 and C3 once "
           f"each: {launches10}")
    _check(enc3.n_host_attributes == 0,
           f"{enc3.n_host_attributes} attributes went to the host encoder")
    host_blobs3, host3_s = wall_s(lambda: [
        tbatch.encode_with_topology(m, topo3) for m in meshes3])
    bad = [i for i, (x, y) in enumerate(zip(blobs3, host_blobs3)) if x != y]
    _check(len(blobs3) == BATCH and not bad, f"{len(bad)} pos+normal+UV "
           f"blobs differ from the host plane (first {bad[:5]})")
    bad = [i for i in sample if blobs3[i] != encode(meshes3[i])]
    _check(not bad, f"pos+normal+UV blobs differ from encode(): {bad[:5]}")
    dev_runs10, host_runs10, stages10 = [], [host3_s], []
    for turn in range(2):  # in turns: device, host, device
        dev_runs10.append(wall_s(lambda: enc3.encode_meshes_device(
            meshes3))[1])
        stages10.append(dict(enc3.timings))
        if turn == 0:
            host_runs10.append(wall_s(lambda: [
                tbatch.encode_with_topology(m, topo3) for m in meshes3])[1])
    trace10 = traced(lambda: enc3.encode_meshes_device(meshes3))
    # the host's share of the attribute stages: the payloads of the chains'
    # symbols, which the device path also codes on the host
    extra3 = tbatch._device_extra_attribute_entries(
        meshes3, list(range(BATCH)), topo3, bits=BITS)
    _check(all(set(extra3.get(k, {})) == {1, 2} for k in range(BATCH)),
           "a chain entry is missing")
    sym_probe = np.random.default_rng(SEED).integers(
        0, 255, size=(64, T3, 2))
    _, payload_s = wall_s(lambda: [tbatch._direct_coded_payload(x)
                                   for x in sym_probe])
    # and the transform metadata: a mesh's flip bits (none set on this
    # data) and its orientation bits (about half set), 64 meshes of each
    from torchdraco.shared.prediction import (write_normal_flips,
                                              write_tex_orientations)
    from torchdraco.wire.byte_io import ByteWriter
    bit_probe = (np.random.default_rng(SEED).random((64, T3)) < 0.5).tolist()
    _, meta_s = wall_s(lambda: [
        (write_normal_flips([False] * T3, ByteWriter()),
         write_tex_orientations(row, ByteWriter())) for row in bit_probe])
    chains["encode"] = {
        "mb_in": mb_in3, "bytes_out": sum(len(b) for b in blobs3),
        "device_s": dev_runs10, "first_call_s": enc3_first_s,
        "host_plane_s": host_runs10, "stages_s": stages10,
        "payload_s_per_1024_streams": payload_s * 16,
        "metadata_s_per_512_meshes": meta_s * 8,
        "trace": trace10, "n_host_attributes": enc3.n_host_attributes,
        "launches": launches10}
    print(f"phase 10: {BATCH} meshes with positions, normals and UVs "
          f"({mb_in3:.1f} MB f32) -> {chains['encode']['bytes_out']} B of "
          f".drc without a device argument; all equal the host plane, "
          f"{len(sample)} sampled equal encode(); 0 host attributes; "
          f"launches {launches10}; device path "
          f"{[round(x, 3) for x in dev_runs10]} s (first call "
          f"{enc3_first_s:.3f}) vs host plane "
          f"{[round(x, 3) for x in host_runs10]} s; stages "
          f"{ {k: round(v, 4) for k, v in stages10[-1].items()} }; the "
          f"1024 host payloads about {payload_s * 16:.3f} s and the flip "
          f"and orientation bits about {meta_s * 8:.3f} s of chains_s; "
          f"traced run {trace10['wall_ms']:.1f} ms, device busy "
          f"{trace10['busy_ms']:.2f} ms over {trace10['launches']} launches "
          f"and {trace10['copies']} copies, idle share "
          f"{trace10['idle_share']}")

    # ---- phase 11: the phased decode over phase 10's blobs ---------------
    def same_mesh(g, r) -> bool:
        return (g is not None and np.array_equal(g.faces, r.faces)
                and len(g.attributes) == len(r.attributes)
                and all(np.array_equal(np.asarray(x.values),
                                       np.asarray(y.values))
                        for x, y in zip(g.attributes, r.attributes)))
    bd3 = tdb.BatchDecoder()
    reset_launch_counts()
    dec3, dec3_first_s = wall_s(lambda: bd3.decode_blobs_shared_topology(
        blobs3, entropy="device", normals="device"))
    launches11 = {"rans_decode_lanes": trl.rans_decode_lanes.n_launches,
                  "normal_decode_cuda": tnorm.normal_decode_cuda.n_launches}
    _check(all(n > 0 for n in launches11.values())
           and "normals_s" in bd3.timings,
           f"the phased decode did not reach the card: {launches11}, "
           f"{bd3.timings}")
    _check(bd3.n_host_blobs == 0, f"{bd3.n_host_blobs} blobs went to the host")
    refs3, decode3_s = wall_s(lambda: [decode(b) for b in blobs3])
    bad = [i for i, (g, r) in enumerate(zip(dec3, refs3))
           if not same_mesh(g, r)]
    _check(not bad, f"{len(bad)} phased-decoded meshes differ from decode() "
           f"(first {bad[:5]})")
    runs11 = {"device": [], "host": []}
    stages11 = []
    for _ in range(3):  # in turns: normals host, device, host, device, ...
        for mode in ("host", "device"):
            out11, s11 = wall_s(lambda: bd3.decode_blobs_shared_topology(
                blobs3, entropy="device", normals=mode))
            runs11[mode].append(s11)
            if mode == "device":
                stages11.append(dict(bd3.timings))
    _check(all(same_mesh(g, r) for g, r in zip(out11, refs3)),
           "a later phased decode differs from decode()")
    host_ent, host_ent_s = wall_s(lambda: bd3.decode_blobs_shared_topology(
        blobs3, entropy="host", normals="device"))
    _check(all(same_mesh(g, r) for g, r in zip(host_ent, refs3))
           and bd3.n_host_blobs == 0,
           "entropy='host', normals='device' differs from decode()")
    trace11 = traced(lambda: bd3.decode_blobs_shared_topology(
        blobs3, entropy="device", normals="device"))
    trace7 = traced(lambda: bd.decode_blobs_shared_topology(
        blobs, entropy="device"))
    chains["decode"] = {
        "normals_device_s": runs11["device"], "normals_host_s": runs11["host"],
        "first_call_s": dec3_first_s, "per_blob_decode_s": decode3_s,
        "entropy_host_normals_device_s": host_ent_s,
        "stages_by_device_run_s": stages11, "trace": trace11,
        "trace_positions_only_group_decode": trace7,
        "launches": launches11}
    print(f"phase 11: decode_blobs_shared_topology(entropy='device', "
          f"normals='device') without a device argument decoded {BATCH} "
          f"blobs, all equal decode(), 0 host blobs (also with "
          f"entropy='host': {host_ent_s:.3f} s); normals='device' "
          f"{[round(x, 3) for x in runs11['device']]} s vs normals='host' "
          f"{[round(x, 3) for x in runs11['host']]} s in turns (per-blob "
          f"decode() {decode3_s:.3f} s); stages "
          f"{ {k: round(v, 4) for k, v in stages11[-1].items()} }; traced "
          f"run {trace11['wall_ms']:.1f} ms, device busy "
          f"{trace11['busy_ms']:.2f} ms over {trace11['launches']} launches "
          f"and {trace11['copies']} copies, idle share "
          f"{trace11['idle_share']}; the positions-only group decode of "
          f"phase 7 traced: busy {trace7['busy_ms']:.2f} of "
          f"{trace7['wall_ms']:.1f} ms, idle share {trace7['idle_share']}")

    # ---- phase 12: one large mesh through the single-mesh routes -------
    torch.cuda.empty_cache()
    single, k12, reuse12 = _phase12(torch, np, torchdraco, encode, tdev,
                                    tbatch,
                           reset_launch_counts, dev, sync, wall_s, cuda_ms,
                           cuda_ms_batches, kernel_only_ms, max_abs_err,
                           nbytes, bound, traced, fa, half_k, smi_line,
                           alone["rans_words_scan"] * 1e6 / n_sym)
    errs.update({name: e["max_abs_err"] for name, e in k12.items()})

    # ---- phase 13: the corpus entry points, from files on disk ----------
    # ---- phase 14: several devices, as shards on the one card -----------
    # (14.4 reads phase 13's corpus and files; the directory goes after)
    import shutil
    import tempfile
    torch.cuda.empty_cache()
    corpus_root = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        corpus = _phase13(torch, torchdraco, encode, tdev, trl, tbatch, tdb,
                          reset_launch_counts, dev, sync, wall_s, smi_line,
                          meshes, meshes3, corpus_root)
        torch.cuda.empty_cache()
        sharded = _phase14(torch, np, torchdraco, tdev, trl, tbatch,
                           reset_launch_counts, wall_s, cuda_ms,
                           kernel_only_ms, smi_line, meshes3,
                           blobs3, dev_runs10,
                           (lanes_dev, f6, c6, len6, bufs_d, nb_d),
                           reuse12, corpus_root)
    finally:
        shutil.rmtree(corpus_root, ignore_errors=True)

    # ---- phase 15: the narrow upload layouts ---------------------------
    torch.cuda.empty_cache()
    narrow, k15 = _phase15(torch, np, native, tdev, tbatch, encode,
                           reset_launch_counts, dev, sync, wall_s, cuda_ms,
                           cuda_ms_batches, kernel_only_ms, max_abs_err,
                           nbytes, bound, smi_line, positions, gathers,
                           meshes, meshes3, blobs, blobs3, enc, enc3,
                           reuse12, main_layouts)
    errs.update({name: e["max_abs_err"] for name, e in k15.items()})

    # ---- phase 16: the bench, python -m torchdraco.bench -----------------
    torch.cuda.empty_cache()
    bench_lines = _phase16(torch, dev, wall_s)

    # ---- phase 17: the main path at real mesh sizes and depths ----------
    torch.cuda.empty_cache()
    real, k17 = _phase17(torch, np, native, tdev, tbatch, trl, encode,
                         reset_launch_counts, dev, sync, wall_s, cuda_ms,
                         cuda_ms_batches, kernel_only_ms, max_abs_err,
                         nbytes, bound, traced, smi_line, positions, gathers,
                         meshes)
    errs.update({name: e["max_abs_err"] for name, e in k17.items()})

    # the launches of phase 13's counted path: the device plane of
    # encode_corpus over the mixed corpus, and its decode_corpus
    corpus_launches = {**corpus["encode"]["launches_manual"],
                       "rans_decode_lanes": corpus["decode"]["d1_launches"]}
    src = "torchdraco/ops/csrc/"
    # K1's row is the uint16 layout's: its launches are those of the path
    # that uploads uint16, the batch path at -qp 15 (phase 15.4)
    table = [
        ("predict_residual", "predict_residual.cu",
         "tpudraco/ops/pallas_kernels.py:174",
         {"predict_residual": narrow["u16_launches"]}),
        ("histogram", "histogram.cu", "tpudraco/ops/pallas_kernels.py:71",
         launches),
        ("rans_words_scan", "rans_words.cu",
         "tpudraco/ops/pallas_kernels.py:399", launches),
        ("rans_scan_dense", "rans_dense.cu",
         "tpudraco/ops/pallas_kernels.py:274", launches6),
        ("rans_decode_lanes", "rans_decode.cu",
         "tpudraco/ops/rans_lanes.py:813,:889 (XLA lax.scan in the "
         "reference, not Pallas)", launches7),
    ]
    kernels = [{"name": name, "route": "cuda", "source": src + f,
                "replaces": rep, "launches": counts[name],
                "max_abs_err": errs[name], "ms": k[name][0],
                "plain_ms": k[name][1],
                "bound_ms": bounds[name]["bound_ms"],
                "bound_by": bounds[name]["bound_by"],
                "library_ms": library_ms.get(name),
                "bytes": bounds[name]["bytes"],
                "share_of_bound": bounds[name]["bound_ms"] / k[name][0],
                "kernel_only_ms": alone[name],
                "launches_corpus": corpus_launches.get(name, 0),
                "launches_sharded": sharded["launches"].get(name, 0)}
               for name, f, rep, counts in table]
    kernels += [{"name": name, "route": "cuda", "source": src + e["file"],
                 "replaces": e["replaces"],
                 **{key: e[key] for key in (
                     "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms", "bytes", "share_of_bound",
                     "kernel_only_ms", "shape")}}
                for name, e in k12.items()]
    # C1 and C3 launched by phase 10's encode, C2 by phase 11's decode
    kernels += [{"name": name, "route": "cuda", "source": src + e["file"],
                 "replaces": e["replaces"],
                 "launches": {**launches10, **launches11}[name],
                 **{key: e[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "bytes", "share_of_bound",
                     "kernel_only_ms", "shape")},
                 "launches_sharded": sharded["launches"].get(name, 0)}
                for name, e in k9.items()]
    kernels[0]["layout"] = "u16"
    kernels += [{"name": name, "route": "cuda", "source": src + e["file"],
                 **{key: e[key] for key in (
                     "replaces", "layout", "launched_on", "launches",
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "bytes", "share_of_bound",
                     "kernel_only_ms", "shape")}}
                for name, e in k15.items()]
    kernels += [{"name": name, "route": "cuda", "source": src + e["file"],
                 **{key: e[key] for key in (
                     "replaces", "launched_on", "launches", "max_abs_err",
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "bytes", "share_of_bound", "kernel_only_ms", "shape",
                     "form")},
                 **{key: e[key] for key in ("layout", "gather_kernel_only_ms",
                                            "tile_sweep_kernel_only_ms",
                                            "bank_replays", "tables", "bins",
                                            "splits")
                    if key in e}}
                for name, e in k17.items()]
    _check(all(e["launches"] > 0 and e["max_abs_err"] == 0
               for e in (*k12.values(), *k15.values(), *k17.values())),
           f"a long-row, narrow-layout or real-size kernel: {k12} {k15} "
           f"{k17}")
    _check(all(e["launches"] > 0 for e in kernels if e["name"] in (
        "predict_residual", "histogram", "rans_words_scan",
        *k9)), "a kernel of the main path, of the attribute chains or of "
        "the -qp 15 path never launched")
    print("chip_smoke details: " + json.dumps({**report, "chains": chains,
                                               "single_mesh": single,
                                               "corpus": corpus,
                                               "sharded": sharded,
                                               "narrow": narrow,
                                               "real_size": real,
                                               "kernels": kernels}),
          file=sys.stderr)
    report["run_s"] = time.perf_counter() - t_start
    print(f"chip_smoke: phases 1-17 in {report['run_s']:.1f} s")
    print(json.dumps({"single_mesh": single}))
    print(json.dumps({"chains": chains}))
    print(json.dumps({"corpus": corpus}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"narrow": narrow}))
    print(json.dumps({"real_size": real}))
    for line in bench_lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _phase9(torch, np, torchdraco, native, tdev, tnorm, ttex, tbatch, dev,
            sync, wall_s, cuda_ms, kernel_only_ms, max_abs_err, nbytes,
            bound, traced, smi_line, positions, q_up, normals3, uvs3,
            meshes3, topo3):
    """C1 (normal encode), C2 (normal decode) and C3 (UV encode) on the
    card through the public chains, against their plain versions called
    by name on the card and against the CPU's, on every output, at the
    batch's full shape, at the deep depths, on a ring of FAN slots and on
    a batch with risky UV meshes; then each kernel timed beside its plain
    version at the full shape (CUDA events, a device trace's launches,
    busy time and peak memory, the kernel alone) with its bound. Returns
    (the ``chains`` record, {kernel line name: entry})."""
    ring_keys = ("tip_pt", "next_pt", "prev_pt", "mask")
    uv_names = ("symbols", "vmin", "vmax", "orient_vals", "orient_flags",
                "risky")

    def chain_case(mesh0, topo, q_pos_np, nrm_np, q_uv_np, where):
        """The chains' arguments for meshes of ``mesh0``'s topology on
        ``where``: q as uploaded and widened (``q32``), as the callers
        hand it to C1 and C3."""
        def up(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(where)
        pa = mesh0.position_attribute()
        uo_pos = pa.unique_indices().astype(np.int64)
        rings_np = topo.rings_for(1)
        rings = tnorm.rings_to_torch(rings_np, where)
        rows = tnorm.rings_to_torch(rings_np, where, rows=uo_pos)
        q, q_uv = up(q_pos_np), up(q_uv_np)
        return {"q_pos": q, "q32": tdev.int32_values(q), "nrm": up(nrm_np),
                "q_uv": q_uv, "q_uv32": tdev.int32_values(q_uv),
                "uo_pos": up(uo_pos),
                "uo_nrm": up(mesh0.attributes[1].unique_indices()
                             .astype(np.int64)),
                "uo_uv": up(mesh0.attributes[2].unique_indices()
                            .astype(np.int64)),
                "rings": [rings[k] for k in ring_keys],
                "rows": [rows[k] for k in ring_keys],
                "uvg": ttex.uv_gathers_to_torch(
                    topo.uv_gathers_for(2, pa.num_points), where)}

    def run_chains(a, qn, plain):
        """(normal symbols, flips, decoded normals, the UV chain's six),
        through the public chains (the kernels on the card) or the plain
        versions by name."""
        enc = (tnorm.normal_encode_chain_ref if plain
               else tnorm.normal_encode_chain)
        dec = (tnorm.normal_decode_chain_ref if plain
               else tnorm.normal_decode_chain)
        uv = ttex.uv_encode_chain_ref if plain else ttex.uv_encode_chain
        sym, flips = enc(a["q_pos"], a["nrm"], *a["rings"], a["uo_pos"],
                         a["uo_nrm"], bits=qn)
        back = dec(a["q_pos"], sym, flips, *a["rows"], bits=qn)
        uvo = uv(a["q_pos"], a["q_uv"], a["uvg"], a["uo_pos"], a["uo_uv"],
                 device=a["q_pos"].device)
        sync()
        return sym, flips, back, uvo

    errs = dict.fromkeys(("normal_encode_cuda", "normal_decode_cuda",
                          "uv_encode_cuda"), 0)

    def chains_equal(got, want, what):
        """Equal on every output; the largest differences go to errs."""
        for name, g, w in zip(("normal symbols", "normal flips",
                               "decoded normals"), got[:3], want[:3]):
            _check(g.dtype == w.dtype and g.shape == w.shape,
                   f"{name} ({what}): {g.dtype} {tuple(g.shape)} against "
                   f"{w.dtype} {tuple(w.shape)}")
            key = "normal_decode_cuda" if name == "decoded normals" \
                else "normal_encode_cuda"
            errs[key] = max(errs[key], max_abs_err(g.cpu(), w.cpu()))
            _check(torch.equal(g.cpu(), w.cpu()),
                   f"{name} differ ({what})")
        for name, g, w in zip(uv_names, got[3], want[3]):
            _check(g.dtype == w.dtype and g.shape == w.shape,
                   f"UV {name} ({what}): {g.dtype} {g.shape} against "
                   f"{w.dtype} {w.shape}")
            errs["uv_encode_cuda"] = max(errs["uv_encode_cuda"], max_abs_err(
                torch.from_numpy(g.astype(np.int64)),
                torch.from_numpy(w.astype(np.int64))))
            _check(np.array_equal(g, w), f"UV {name} differ ({what})")

    # the four cases: the batch at -qp 11 -qn 8 -qt 10; the deep depths
    # (ring sums past 2^31, 16-bit normals); a fan ring; risky UV meshes
    q_uv_full = tbatch._host_quantize(uvs3, UV_BITS)[0]
    deep_pos = (positions[:DEEP_BATCH] * np.float32(1e4)).astype(np.float32)
    q_deep = tbatch.quantize_positions_host(deep_pos, DEEP_QP)[0]
    _check(int(np.abs(np.diff(q_deep.astype(np.int64), axis=1)).max()) ** 2
           > 1 << 31, "the deep case does not pass int32")
    n_fan = FAN + 1
    posf, facesf = torchdraco.make_mesh_batch(FAN_BATCH, n_fan, SEED + 9,
                                              fan=FAN)
    nrmf, uvf = torchdraco.make_normal_uv_batch(posf, n_fan, SEED + 10)
    meshesf = torchdraco.build_meshes(posf, facesf, nrmf, uvf)
    topof = tbatch.PreparedTopology(meshesf[0])
    _check(topof.rings_for(1)["next_pt"].shape[1] == FAN,
           "the fan case's rings are not FAN wide")
    rng = np.random.default_rng(SEED + 9)
    q_risky = q_up[:RISKY_BATCH].astype(np.int32)
    q_uv_risky = q_uv_full[:RISKY_BATCH].astype(np.int32)
    q_risky[1] = rng.integers(0, (1 << 31) - 1, size=q_risky[1].shape)
    q_risky[3] = rng.integers(0, 1 << 19, size=q_risky[3].shape)
    q_uv_risky[3] = rng.integers(0, 1 << 30, size=q_uv_risky[3].shape)
    q_risky[5] = rng.integers(0, 1 << 21, size=q_risky[5].shape)
    cases = {
        "full": (meshes3[0], topo3, q_up, normals3, q_uv_full, NORMAL_BITS),
        "deep": (meshes3[0], topo3, q_deep, normals3[:DEEP_BATCH],
                 tbatch._host_quantize(uvs3[:DEEP_BATCH], DEEP_QT)[0],
                 DEEP_QN),
        "fan": (meshesf[0], topof,
                native.quantize_batch(posf, BITS)[0], nrmf,
                tbatch._host_quantize(uvf, UV_BITS)[0], NORMAL_BITS),
        "risky": (meshes3[0], topo3, q_risky, normals3[:RISKY_BATCH],
                  q_uv_risky, NORMAL_BITS)}
    rec = {"card": smi_line, "cases": {}}
    full = None
    for what, (m0, topo, qp_np, nrm_np, quv_np, qn) in cases.items():
        a = chain_case(m0, topo, qp_np, nrm_np, quv_np, dev)
        got = run_chains(a, qn, plain=False)
        plain = run_chains(a, qn, plain=True)
        chains_equal(got, plain, f"{what}: the kernels against the plain "
                                 f"versions on the card")
        cpu, cpu_s = wall_s(lambda: run_chains(
            chain_case(m0, topo, qp_np, nrm_np, quv_np, "cpu"), qn,
            plain=True))
        chains_equal(got, cpu, f"{what}: the kernels against the CPU")
        # C2 on symbols and flips of its own, beside the encoder's
        rng_d = np.random.default_rng(qn)
        sym_r = torch.from_numpy(rng_d.integers(
            0, (1 << qn) - 1, size=tuple(got[0].shape)).astype(np.int32)
        ).to(dev)
        flips_r = torch.from_numpy(rng_d.random(tuple(got[1].shape)) < 0.5
                                   ).to(dev)
        dk = tnorm.normal_decode_chain(a["q32"], sym_r, flips_r, *a["rows"],
                                       bits=qn)
        dp = tnorm.normal_decode_chain_ref(a["q_pos"], sym_r, flips_r,
                                           *a["rows"], bits=qn)
        errs["normal_decode_cuda"] = max(errs["normal_decode_cuda"],
                                         max_abs_err(dk, dp))
        _check(torch.equal(dk, dp), f"{what}: C2 differs from its plain "
               f"version on random symbols and flips")
        T, R = topo.rings_for(1)["next_pt"].shape
        rec["cases"][what] = {
            "meshes": int(qp_np.shape[0]), "steps": int(T), "ring": int(R),
            "normal_bits": qn, "cpu_plain_s": cpu_s,
            "risky_meshes": np.flatnonzero(got[3][5]).tolist(),
            "geo_steps": int(got[3][4].sum())}
        if what == "full":
            full = (a, got)
        else:
            del a
        del got, plain, cpu
    a, got_full = full
    # the decode chain gives the quantized normals back, but for the
    # corner (max, max), which the transform folds onto the corners near 0
    q_n = tnorm.oct_quantize_faithful_device(a["nrm"], NORMAL_BITS)
    orig_n = q_n[:, a["uo_nrm"][a["rings"][0]], :]
    folded = (orig_n == (1 << NORMAL_BITS) - 1).all(-1)
    back_err = ((got_full[2] != orig_n).any(-1) & ~folded)
    _check(not back_err.any().item() and folded.sum().item() < 64,
           "decode chain does not invert encode")
    _check(not got_full[3][5].any(), "a UV row of the slice is risky")
    flagged = rec["cases"]["risky"]["risky_meshes"]
    _check({1, 3} <= set(flagged) and 0 not in flagged,
           f"the risky batch flagged meshes {flagged}, not 1 and 3")

    # timing at the full shape: each kernel's wrapper and the chain call
    # as the callers make it, beside its plain version
    sym_n, flips_n = got_full[0], got_full[1]
    uv_i64 = [a["q_pos"].to(torch.int64), a["q_uv"].to(torch.int64)]
    g_list = [a["uvg"][k] for k in ttex._UV_INDEX_KEYS + ttex._UV_MASK_KEYS]
    kernel_fns = {
        "normal_encode_cuda": lambda: tnorm.normal_encode_cuda(
            a["q32"], a["nrm"], *a["rings"], a["uo_pos"], a["uo_nrm"],
            bits=NORMAL_BITS),
        "normal_decode_cuda": lambda: tnorm.normal_decode_cuda(
            a["q32"], sym_n, flips_n, *a["rows"], bits=NORMAL_BITS),
        "uv_encode_cuda": lambda: ttex.uv_encode_cuda(
            a["q32"], a["q_uv32"], a["uvg"], a["uo_pos"], a["uo_uv"])}
    chain_calls = {
        "normal_encode_cuda": lambda: tnorm.normal_encode_chain(
            a["q32"], a["nrm"], *a["rings"], a["uo_pos"], a["uo_nrm"],
            bits=NORMAL_BITS),
        "normal_decode_cuda": lambda: tnorm.normal_decode_chain(
            a["q32"], sym_n, flips_n, *a["rows"], bits=NORMAL_BITS),
        "uv_encode_cuda": lambda: ttex.uv_encode_chain(
            a["q32"], a["q_uv32"], a["uvg"], a["uo_pos"], a["uo_uv"],
            device=dev)}
    plain_fns = {
        "normal_encode_cuda": lambda: tnorm.normal_encode_chain_ref(
            a["q_pos"], a["nrm"], *a["rings"], a["uo_pos"], a["uo_nrm"],
            bits=NORMAL_BITS),
        "normal_decode_cuda": lambda: tnorm.normal_decode_chain_ref(
            a["q_pos"], sym_n, flips_n, *a["rows"], bits=NORMAL_BITS),
        "uv_encode_cuda": lambda: ttex._uv_chain_impl(
            *uv_i64, a["uo_pos"], a["uo_uv"], *g_list)}
    device_kernels = {"normal_encode_cuda": ("normal_encode_kernel",),
                      "normal_decode_cuda": ("normal_decode_kernel",),
                      "uv_encode_cuda": ("uv_range_kernel",
                                         "uv_step_kernel")}
    B, T = sym_n.shape[0], sym_n.shape[1]
    R = a["rings"][1].shape[1]
    tables = nbytes(*a["rings"])
    moved = {
        "normal_encode_cuda": nbytes(a["q32"], a["nrm"], a["uo_pos"],
                                     a["uo_nrm"], sym_n, flips_n) + tables,
        "normal_decode_cuda": nbytes(a["q32"], sym_n, flips_n,
                                     got_full[2]) + tables,
        "uv_encode_cuda": nbytes(a["q32"], a["q_uv32"], a["uo_pos"],
                                 a["uo_uv"], *g_list)
        + B * T * (2 * 4 + 2) + B * (4 + 4 + 1)}
    # operations counted from the sources, for this run's data: 45 a ring
    # slot the mask keeps (two edges, the cross product, the sum) and 250
    # for the rest of a normal step; 250 a UV step, and about 36 rounds of
    # 8 where the integer square root runs (the steps the geometric
    # predictor takes)
    valid_slots = int(a["rings"][3].sum())
    geo_steps = rec["cases"]["full"]["geo_steps"]
    ops = {"normal_encode_cuda": B * (45 * valid_slots + 250 * T),
           "normal_decode_cuda": B * (45 * valid_slots + 250 * T),
           "uv_encode_cuda": B * T * 250 + geo_steps * 36 * 8}
    rec["shape"] = {"meshes": B, "steps": T, "ring": R,
                    "valid_slots": valid_slots,
                    "bits": [BITS, NORMAL_BITS, UV_BITS]}
    entries = {}
    files = {"normal_encode_cuda": "normal_chains.cu",
             "normal_decode_cuda": "normal_chains.cu",
             "uv_encode_cuda": "uv_chain.cu"}
    replaces = {
        "normal_encode_cuda": "tpudraco/ops/normals.py:259-260 "
                              "(normal_encode_chain's jax.jit; XLA in the "
                              "reference, not Pallas)",
        "normal_decode_cuda": "tpudraco/ops/normals.py:292 "
                              "(_normal_decode_chain_jit; XLA, not Pallas)",
        "uv_encode_cuda": "tpudraco/ops/texcoords.py:191 (_uv_chain_x64's "
                          "jax.jit; XLA, not Pallas)"}
    from torch.profiler import ProfilerActivity, profile

    def launches_a_call(fn) -> float:
        """Kernel launches a call of ``fn``: the most seen a call over
        device traces of 1, 2, 4 ... 32 calls. The tracer loses events at
        times, whole windows or part of one, and never adds any."""
        most = 0.0
        for calls in (1, 2, 4, 8, 16, 32):
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                sync()
            names = [e.name.lower() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            kernels = sum(1 for n in names
                          if "memcpy" not in n and "memset" not in n)
            most = max(most, kernels / calls)
        return most

    for name, fn in kernel_fns.items():
        k_ms = cuda_ms(fn, 20)
        p_ms = cuda_ms(plain_fns[name], 3)
        alone = sum(kernel_only_ms(fn, kn) for kn in device_kernels[name])
        k_tr, call_tr, p_tr = (traced(f) for f in (fn, chain_calls[name],
                                                   plain_fns[name]))
        for tr in (k_tr, call_tr, p_tr):
            del tr["idle_share"]
        call_tr["launches"] = launches_a_call(chain_calls[name])
        _check(call_tr["launches"] <= 3,
               f"{name}: a chain call made {call_tr['launches']} launches")
        if call_tr["launches"] == 0:  # every trace lost them
            rec.setdefault("traces_lost", []).append(name)
        b = bound(moved[name], ops[name])
        rec[name] = {"kernel": {"ms": k_ms, "alone_ms": alone, **k_tr},
                     "chain_call": call_tr, "plain": {"ms": p_ms, **p_tr},
                     **b, "share": b["bound_ms"] / k_ms,
                     "share_alone": b["bound_ms"] / alone}
        entries[name] = {
            "file": files[name], "replaces": replaces[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None, "bytes": b["bytes"],
            "share_of_bound": b["bound_ms"] / k_ms,
            "kernel_only_ms": alone, "shape": rec["shape"]}
    print(f"phase 9: C1, C2 and C3 equal their plain versions on the card "
          f"and the CPU's on every output at ({B}, {T}, ring {R}) -qp {BITS} "
          f"-qn {NORMAL_BITS} -qt {UV_BITS}, at -qp {DEEP_QP} -qn {DEEP_QN} "
          f"-qt {DEEP_QT}, on a ring of {FAN} and on a batch with risky "
          f"UV meshes {flagged} "
          f"(the CPU's runs "
          f"{ {k: round(v['cpu_plain_s'], 1) for k, v in rec['cases'].items()} }"
          f" s); kernel ms / alone / launches / peak MB against plain ms / "
          f"launches / peak MB, bound ms: "
          f"{ {n: (round(rec[n]['kernel']['ms'], 4), round(rec[n]['kernel']['alone_ms'], 4), rec[n]['chain_call']['launches'], round(rec[n]['kernel']['peak_bytes'] / 1e6, 1), round(rec[n]['plain']['ms'], 2), rec[n]['plain']['launches'], round(rec[n]['plain']['peak_bytes'] / 1e6), round(rec[n]['bound_ms'], 4)) for n in kernel_fns} }")
    return rec, entries


def _phase12(torch, np, torchdraco, encode, tdev, tbatch,
             reset_launch_counts, dev, sync, wall_s, cuda_ms,
             cuda_ms_batches, kernel_only_ms, max_abs_err, nbytes, bound,
             traced, fa, half_k, smi_line, k3_ns_per_step):
    """One HUGE_GRID x HUGE_GRID mesh through encode_mesh_device (with
    normals and UVs), encode_mesh_device_chunked (positions) and
    _encode_huge, each against encode(); K1 and K2 at the single row's
    shapes against their twins; the chunk quantize against numpy. Returns
    (the phase's record, {kernel line name: entry}, what phase 14.3
    reuses)."""
    t_phase = time.perf_counter()
    n = HUGE_GRID
    V = n * n
    (pos, faces), make_s = wall_s(lambda: torchdraco.make_mesh_batch(
        1, n, SEED))
    nrm, uvs = torchdraco.make_normal_uv_batch(pos, n, SEED + 3)
    (mesh3,), build_s = wall_s(lambda: torchdraco.build_meshes(
        pos, faces, nrm, uvs))
    (mesh1,) = torchdraco.build_meshes(pos, faces)
    F = len(faces)
    one = {"card": smi_line, "vertices": V, "faces": F,
           "mesh_build_s": make_s + build_s}
    counted = (tdev.predict_residual, tdev.histogram)

    def peak_of(fn):
        """(fn's result, its wall s, the peak of allocated card memory
        above what was held before)."""
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, secs = wall_s(fn)
        return out, secs, torch.cuda.max_memory_allocated() - base

    # 12.1: the resident route, positions + normals + UVs
    enc = tbatch.BatchEncoder()
    reset_launch_counts()
    blob_r, first_s, peak = peak_of(lambda: enc.encode_mesh_device(mesh3))
    launches_r = {fn.__name__: fn.n_launches for fn in counted}
    stages_first = dict(enc.timings)
    _check(launches_r == {"predict_residual": 1, "histogram": 1},
           f"the resident route launches K1 and K2 once each: {launches_r}")
    _check(enc.n_host_attributes == 0,
           f"{enc.n_host_attributes} attributes went to the host encoder")
    ref3, host3_s = wall_s(lambda: encode(mesh3))
    _check(blob_r == ref3, "encode_mesh_device differs from encode()")
    blob, s = wall_s(lambda: enc.encode_mesh_device(mesh3))
    _check(blob == ref3, "a warm encode_mesh_device differs")
    warm, stages = [s], [dict(enc.timings)]
    trace_r = traced(lambda: enc.encode_mesh_device(mesh3))
    stages.append(dict(enc.timings))  # the traced run's
    host3_runs = [host3_s]
    one["resident"] = {
        "first_call_s": first_s, "first_call_stages_s": stages_first,
        "warm_s": warm, "warm_stages_s": stages, "host_encode_s": host3_runs,
        "peak_bytes": int(peak), "peak_bytes_per_vertex": peak / V,
        "table_bytes": enc._topo_for(mesh3)[1].device_bytes(),
        "trace": trace_r, "launches": launches_r, "bytes_out": len(ref3)}
    print(f"phase 12.1: encode_mesh_device, {n}x{n} grid ({V} vertices, "
          f"{F} faces) with positions, normals and UVs -> {len(ref3)} B, "
          f"equal to encode(); 0 host attributes; launches {launches_r}; "
          f"first call {first_s:.3f} s "
          f"{ {k: round(v, 3) for k, v in stages_first.items()} }, warm "
          f"{[round(x, 3) for x in warm]} s "
          f"{ {k: round(v, 3) for k, v in stages[-1].items()} }; host "
          f"encode() {[round(x, 3) for x in host3_runs]} s; peak card "
          f"memory {peak / 1e6:.1f} MB ({peak / V:.1f} B a vertex); traced "
          f"warm run {trace_r['wall_ms']:.1f} ms, device busy "
          f"{trace_r['busy_ms']:.2f} ms over {trace_r['launches']} launches "
          f"and {trace_r['copies']} copies, idle share "
          f"{trace_r['idle_share']}")

    # 12.2: the chunked route, positions only; every segment's counts
    # are recorded to hold their sum to T x 3
    seg_counts = []
    real_step = tbatch.encode_step_chunk

    def recorded(*a, **kw):
        sym, cnt = real_step(*a, **kw)
        seg_counts.append(int(cnt.sum()))
        return sym, cnt
    tbatch.encode_step_chunk = recorded
    reset_launch_counts()
    try:
        blob_c, chunked_first_s = wall_s(
            lambda: enc.encode_mesh_device_chunked(mesh1, chunk=HUGE_CHUNK))
    finally:
        tbatch.encode_step_chunk = real_step
    launches_c = {fn.__name__: fn.n_launches for fn in counted}
    stages_c = [dict(enc.timings)]
    ref1, host1_s = wall_s(lambda: encode(mesh1))
    T = mesh1.position_attribute().num_points  # a grid: T = V
    n_seg = -(-T // HUGE_CHUNK)
    _check(blob_c == ref1, "encode_mesh_device_chunked differs from encode()")
    _check(len(seg_counts) == n_seg and sum(seg_counts) == T * 3
           and launches_c["histogram"] == n_seg,
           f"chunked histogram: {len(seg_counts)} segments summing to "
           f"{sum(seg_counts)} of {T * 3}, launches {launches_c}")
    blob, s = wall_s(lambda: enc.encode_mesh_device_chunked(
        mesh1, chunk=HUGE_CHUNK))
    _check(blob == ref1, "a warm encode_mesh_device_chunked differs")
    chunked_warm = [s]
    stages_c.append(dict(enc.timings))
    resident1, res1_s, peak1 = peak_of(lambda: enc.encode_mesh_device(mesh1))
    _check(resident1 == ref1, "encode_mesh_device (positions) differs")
    res1_warm = wall_s(lambda: enc.encode_mesh_device(mesh1))[1]
    one["chunked"] = {"first_call_s": chunked_first_s, "warm_s": chunked_warm,
                      "stages_s": stages_c, "segments": n_seg,
                      "launches": launches_c, "host_encode_s": host1_s,
                      "resident_positions_only_s": [res1_s, res1_warm],
                      "bytes_out": len(ref1)}
    print(f"phase 12.2: encode_mesh_device_chunked, positions only, chunk "
          f"{HUGE_CHUNK}: {n_seg} segments whose counts sum to T x 3 = "
          f"{T * 3}, -> {len(ref1)} B equal to encode(); first call "
          f"{chunked_first_s:.3f} s, warm {[round(x, 3) for x in chunked_warm]}"
          f" s, passes {[{k: round(v, 3) for k, v in st.items()} for st in stages_c]}"
          f"; host encode() {host1_s:.3f} s; the resident route on the same "
          f"mesh {res1_s:.3f} / {res1_warm:.3f} s")

    # 12.3: the size dispatch. The resident route's peak card memory on
    # the grid with and without normals and UVs, on a grid with UVs alone
    # and on a grid with one fan vertex, against the estimate _encode_huge decides by; then
    # _encode_huge on both sides of a RESIDENT_MAX_BYTES lowered to the
    # positions-only grid's estimate
    posf, facesf = torchdraco.make_mesh_batch(1, FAN_GRID, SEED, fan=FAN)
    nrmf, uvsf = torchdraco.make_normal_uv_batch(posf, FAN_GRID, SEED + 3)
    (meshf,) = torchdraco.build_meshes(posf, facesf, nrmf, uvsf)
    enc_f = tbatch.BatchEncoder()
    blob_f, fan_s, peak_f = peak_of(lambda: enc_f.encode_mesh_device(meshf))
    ref_f, host_f_s = wall_s(lambda: encode(meshf))
    _check(blob_f == ref_f, "encode_mesh_device on the fan mesh differs")
    _check(enc_f.n_host_attributes == 0,
           f"the fan mesh sent {enc_f.n_host_attributes} attributes to the "
           f"host encoder")
    # the UV chain without the normal chain: a grid with positions and UVs
    posu, facesu = torchdraco.make_mesh_batch(1, FAN_GRID, SEED)
    (meshu,) = torchdraco.build_meshes(
        posu, facesu, None, torchdraco.make_normal_uv_batch(
            posu, FAN_GRID, SEED + 3)[1])
    enc_u = tbatch.BatchEncoder()
    peak_u = peak_of(lambda: enc_u.encode_mesh_device(meshu))[2]
    _check(enc_u.n_host_attributes == 0, "the UVs went to the host encoder")
    peaks = {}
    for name, m, e, p in (("grid, positions", mesh1, enc, peak1),
                          (f"grid {FAN_GRID}^2, positions + UVs", meshu,
                           enc_u, peak_u),
                          ("grid, positions + normals + UVs", mesh3, enc,
                           peak),
                          (f"grid {FAN_GRID}^2 + fan {FAN}, positions + "
                           f"normals + UVs", meshf, enc_f, peak_f)):
        _, topo_m = e._topo_for(m)
        rings = [int(topo_m.rings_for(i)["next_pt"].shape[1])
                 for i, a in enumerate(m.attributes)
                 if a.att_type == tbatch.AttributeType.NORMAL]
        est = e._resident_peak_bytes(m)
        peaks[name] = {"vertices": m.position_attribute().num_points,
                       "ring_width": rings, "peak_bytes": int(p),
                       "estimate_bytes": est, "estimate_over_peak": est / p}
    _check(all(v["estimate_over_peak"] >= 1 for v in peaks.values()),
           f"_resident_peak_bytes under a measured peak: {peaks}")
    limit = enc._resident_peak_bytes(mesh1)
    old = tbatch.BatchEncoder.RESIDENT_MAX_BYTES
    taken = []
    for cap in (limit - 1, limit):
        tbatch.BatchEncoder.RESIDENT_MAX_BYTES = cap
        try:
            blob, s = wall_s(lambda: enc._encode_huge(mesh1))
        finally:
            tbatch.BatchEncoder.RESIDENT_MAX_BYTES = old
        _check(blob == ref1, f"_encode_huge (limit {cap}) differs")
        taken.append(("chains_s" not in enc.timings, s))
    _check([c for c, _ in taken] == [True, False],
           f"_encode_huge took the wrong route: {taken}")
    one["resident_peaks"] = peaks
    one["fan"] = {"first_call_s": fan_s, "host_encode_s": host_f_s,
                  "bytes_out": len(ref_f)}
    one["dispatch_s"] = {"chunked": taken[0][1], "resident": taken[1][1]}
    print(f"phase 12.3: the resident route's peak card memory against "
          f"_resident_peak_bytes: " + "; ".join(
              f"{k} ({v['vertices']} vertices, rings {v['ring_width']}): "
              f"{v['peak_bytes'] / 1e6:.1f} MB, estimate "
              f"{v['estimate_bytes'] / 1e6:.1f} MB "
              f"(x{v['estimate_over_peak']:.2f})" for k, v in peaks.items())
          + f"; the fan mesh equals encode() ({fan_s:.3f} s, host encode() "
          f"{host_f_s:.3f} s); _encode_huge with RESIDENT_MAX_BYTES "
          f"{limit - 1} took the chunked route ({taken[0][1]:.3f} s), with "
          f"{limit} the resident one ({taken[1][1]:.3f} s): both equal "
          f"encode()")

    # 12.4: K1 and K2 at the single row's shapes against their twins
    _, topo = enc._topo_for(mesh1)
    pos_att = mesh1.position_attribute()
    dev_c = tbatch.device_encode_group(pos, topo, pos_att, bits=BITS,
                                       device=dev)
    # the uint16 row, as before the narrow layouts (the resident route
    # uploads the 12-bit pack at -qp 11: phase 15.1 times each layout)
    q = torch.from_numpy(dev_c["q"]).to(dev)
    g = tbatch._device_gathers(topo, pos_att, dev, V)
    tiles = tbatch._device_tiles(topo, pos_att, dev, V)
    lo = torch.from_numpy(dev_c["vmin"]).to(dev)
    hi = torch.from_numpy(dev_c["vmax"]).to(dev)
    _check(tdev.predict_form(V, 3, q.element_size()) == "tiled",
           "K1 should take its tiled kernel at this row")
    sym = tdev.predict_residual(q, g, lo, hi, tiles)
    sync()
    k1_err = max_abs_err(sym, tdev.predict_residual_ref(q, g, lo, hi))
    flat = sym.view(1, -1)
    bins = tdev.default_hist_bins(BITS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = tdev.histogram_splits(1, flat.shape[1], bins, sms)
    _check(splits > 1, f"K2 does not split the long row ({splits})")
    counts = tdev.histogram(flat, bins)
    sync()
    k2_err = max_abs_err(counts, tdev.bincount_kernel(flat, bins))
    rng = np.random.default_rng(SEED + 12)
    wide = 1 << 17
    rnd = torch.from_numpy(rng.integers(-9, wide + 9, size=(1, flat.shape[1]),
                                        dtype=np.int32)).to(dev)
    _check(wide > tdev.HIST_SMEM_MAX_BINS, "the wide case is in shared memory")
    k2_wide_err = max_abs_err(tdev.histogram(rnd, wide),
                              tdev.bincount_kernel(rnd, wide))
    # the row a full segment of the chunked route hands K2: its first
    # HUGE_CHUNK steps' symbols
    seg = flat[:, :HUGE_CHUNK * 3].contiguous()
    k2_seg_err = max_abs_err(tdev.histogram(seg, bins),
                             tdev.bincount_kernel(seg, bins))
    # the position symbols form one rANS stream: K3 would code it on one
    # lane, a dependent step a symbol, where the route uses the host coder
    from torchdraco.entropy.symbol_coding import DIRECT_CODED, encode_symbols
    from torchdraco.wire.byte_io import ByteWriter
    sym_np = sym[0].cpu().numpy().astype(np.uint64)
    _, coder_s = wall_s(lambda: encode_symbols(sym_np.ravel(), 3,
                                               DIRECT_CODED, ByteWriter()))
    one_lane = {"symbols": int(sym_np.size), "k3_ns_per_step": k3_ns_per_step,
                "k3_one_lane_s_estimated": sym_np.size * k3_ns_per_step / 1e9,
                "host_coder_s": coder_s}
    one["one_lane_rans"] = one_lane
    print(f"phase 12.4: one rANS lane of {sym_np.size} symbols: K3 at "
          f"{k3_ns_per_step:.1f} ns a step (phase 6, kernel alone) would take "
          f"about {one_lane['k3_one_lane_s_estimated']:.3f} s; the host's C++ "
          f"coder took {coder_s:.3f} s")
    _check(k1_err == 0 and k2_err == 0 and k2_wide_err == 0
           and k2_seg_err == 0,
           f"long-row kernel != twin: K1 {k1_err}, K2 {k2_err} (wide "
           f"{k2_wide_err}, segment {k2_seg_err})")
    # one block a row, as before the split: the same wrapper with the
    # split forced to 1 (its output checked too)
    real_splits = tdev.histogram_splits
    tdev.histogram_splits = lambda *a: 1
    try:
        k2_err1 = max_abs_err(tdev.histogram(flat, bins), counts)
        one_block = cuda_ms_batches(lambda: tdev.histogram(flat, bins))
        one_block_alone = kernel_only_ms(lambda: tdev.histogram(flat, bins),
                                         "histogram_smem_kernel", reps=10)
        one_block_wide = cuda_ms(lambda: tdev.histogram(rnd, wide), 10)
    finally:
        tdev.histogram_splits = real_splits
    _check(k2_err1 == 0, "K2 on one block a row disagrees")

    def k2_lib():
        return torch.bincount(flat.view(-1), minlength=bins)
    _check(torch.equal(k2_lib()[:bins], counts[0].to(torch.int64)),
           "torch.bincount disagrees with K2 on the long row")

    def seg_lib():
        return torch.bincount(seg.view(-1), minlength=bins)

    # the 2^17-bin row: torch.bincount over its in-range values (K2 drops
    # the rest; the mask is taken once, outside the timing)
    rnd_in = rnd[(rnd >= 0) & (rnd < wide)].contiguous()

    def wide_lib():
        return torch.bincount(rnd_in, minlength=wide)
    _check(torch.equal(wide_lib(), tdev.histogram(rnd, wide)[0].to(
        torch.int64)), "torch.bincount disagrees with K2 at 2^17 bins")
    k2_runs = cuda_ms_batches(lambda: tdev.histogram(flat, bins))
    seg_runs = cuda_ms_batches(lambda: tdev.histogram(seg, bins))
    k1_runs = cuda_ms_batches(lambda: tdev.predict_residual(q, g, lo, hi,
                                                            tiles))
    k12 = {
        "predict_residual_long_row": {
            "file": "predict_residual.cu",
            "replaces": "tpudraco/ops/pallas_kernels.py:174",
            "shape": [1, V, 3], "launches": launches_r["predict_residual"],
            "max_abs_err": k1_err, "ms": k1_runs["median"],
            "ms_runs": k1_runs,
            "plain_ms": cuda_ms(lambda: tdev.predict_residual_ref(
                q, g, lo, hi), 5),
            "kernel_only_ms": kernel_only_ms(
                lambda: tdev.predict_residual(q, g, lo, hi, tiles),
                "predict_tiled_kernel", reps=10),
            "library_ms": None, "form": "tiled",
            **bound(nbytes(q, lo, hi, sym, tiles.verts, tiles.off,
                           tiles.local), 12 * sym.numel())},
        "histogram_long_row": {
            "file": "histogram.cu",
            "replaces": "tpudraco/ops/pallas_kernels.py:71",
            "shape": [1, int(flat.shape[1]), bins], "splits": splits,
            "launches": launches_r["histogram"], "max_abs_err": k2_err,
            "ms": k2_runs["median"], "ms_runs": k2_runs,
            "plain_ms": cuda_ms(lambda: tdev.bincount_kernel(flat, bins), 5),
            "kernel_only_ms": kernel_only_ms(
                lambda: tdev.histogram(flat, bins), "histogram_smem_kernel",
                reps=10),
            "library_ms": cuda_ms(k2_lib, 20),
            "one_block_ms": one_block["median"],
            "one_block_ms_runs": one_block,
            "one_block_kernel_only_ms": one_block_alone,
            "wide_bins": wide, "wide_ms": cuda_ms(
                lambda: tdev.histogram(rnd, wide), 10),
            "wide_kernel_only_ms": kernel_only_ms(
                lambda: tdev.histogram(rnd, wide), "histogram_smem_kernel",
                reps=10),
            "wide_library_ms": cuda_ms(wide_lib, 20),
            "wide_plain_ms": cuda_ms(
                lambda: tdev.bincount_kernel(rnd, wide), 5),
            "wide_one_block_ms": one_block_wide,
            "wide_splits": tdev.histogram_splits(1, flat.shape[1], wide,
                                                sms),
            "wide_max_abs_err": k2_wide_err,
            **bound(nbytes(flat, counts), 2 * flat.numel())},
        "histogram_chunk_row": {
            "file": "histogram.cu",
            "replaces": "tpudraco/ops/pallas_kernels.py:71",
            "shape": [1, int(seg.shape[1]), bins],
            "splits": tdev.histogram_splits(1, seg.shape[1], bins, sms),
            "launches": launches_c["histogram"], "max_abs_err": k2_seg_err,
            "ms": seg_runs["median"], "ms_runs": seg_runs,
            "plain_ms": cuda_ms(lambda: tdev.bincount_kernel(seg, bins), 10),
            "kernel_only_ms": kernel_only_ms(
                lambda: tdev.histogram(seg, bins), "histogram_smem_kernel",
                reps=10),
            "library_ms": cuda_ms(seg_lib, 20),
            **bound(nbytes(seg) + 4 * bins, 2 * seg.numel())}}
    for e in k12.values():
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
    h = k12["histogram_long_row"]
    print(f"phase 12.4: K1 at (1, {V}, 3) (tiled) and K2 at (1, "
          f"{flat.shape[1]}) {bins} bins on {splits} blocks, at {wide} bins "
          f"(wide) and at a segment's (1, {seg.shape[1]}) equal their "
          f"twins; K2 {h['ms']:.4f} ms (alone {h['kernel_only_ms']:.4f}) "
          f"against {h['one_block_ms']:.4f} (alone "
          f"{h['one_block_kernel_only_ms']:.4f}) on one block, bound "
          f"{h['bound_ms']:.4f}, torch.bincount {h['library_ms']:.4f}, wide "
          f"{h['wide_ms']:.4f} (alone {h['wide_kernel_only_ms']:.4f}, "
          f"torch.bincount {h['wide_library_ms']:.4f}, plain "
          f"{h['wide_plain_ms']:.4f}) against "
          f"{h['wide_one_block_ms']:.4f}; K1 "
          f"{k12['predict_residual_long_row']['ms']:.4f} ms (alone "
          f"{k12['predict_residual_long_row']['kernel_only_ms']:.4f}), bound "
          f"{k12['predict_residual_long_row']['bound_ms']:.4f}")

    # 12.5: the chunk quantize on the card against numpy, bit for bit:
    # the mesh's rows against its own range, and edge values (k + .5
    # over several scales, phase 8's spread values) against theirs
    def numpy_rows(rows, mins, delta, bits):
        diff = (rows - mins).astype(np.float32)
        norm = diff if delta == 0 else (diff / delta).astype(np.float32)
        prod = (norm * np.float32((1 << bits) - 1)).astype(np.float32)
        return (prod + np.float32(0.5)).astype(np.float32).astype(np.int32)
    finite = fa[np.isfinite(fa) & (np.abs(fa) < 1e30)]
    cases = [("mesh rows", pos[0], BITS), ("mesh rows", pos[0], 16)]
    for bits in (11, 14, 16):
        top = np.float32((1 << bits) - 1)
        cases.append((f"k + .5 at {bits} bits", np.concatenate(
            [half_k[half_k < top], [top]]).astype(np.float32)[:, None], bits))
    cases.append(("phase 8 values", finite[:, None].astype(np.float32), 16))
    quant = []
    for name, rows, bits in cases:
        mins = np.minimum(rows.min(axis=0), np.float32(0)).astype(np.float32)
        maxs = np.maximum(rows.max(axis=0), np.float32(0)).astype(np.float32)
        delta = np.float32(np.max(maxs - mins))
        want = numpy_rows(rows, mins, delta, bits)
        rows_dev = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        mins_dev = torch.from_numpy(mins).to(dev)
        got = tdev.quantize_rows_kernel(rows_dev, mins_dev,
                                        torch.tensor(delta, device=dev), bits)
        # the same formula dividing by a CPU scalar (a reciprocal multiply
        # on the card): what the rule against it protects
        scalar = (((rows_dev - mins_dev) / float(delta))
                  * float((1 << bits) - 1) + 0.5).to(torch.int32)
        quant.append({"case": name, "values": int(rows.size), "bits": bits,
                      "mismatches": int((got.cpu().numpy() != want).sum()),
                      "cpu_scalar_divisor_mismatches": int(
                          (scalar.cpu().numpy() != want).sum())})
    q_res, mins_r, dm_r = tdev.quantize_kernel(
        torch.from_numpy(pos).to(dev), BITS)
    hq, hmins, hdm = tbatch.quantize_positions_host(pos, BITS)
    resident_ok = (np.array_equal(q_res.cpu().numpy(), hq)
                   and np.array_equal(mins_r.cpu().numpy().view(np.int32),
                                      hmins.view(np.int32))
                   and np.array_equal(dm_r.cpu().numpy().view(np.int32),
                                      hdm.view(np.int32)))
    one["quantize_vs_numpy"] = quant
    _check(all(c["mismatches"] == 0 for c in quant) and resident_ok,
           f"the card's quantize differs from numpy: {quant}, resident "
           f"{resident_ok}")
    print(f"phase 12.5: quantize_rows_kernel on the card equals numpy bit "
          f"for bit in every case "
          f"{[(c['case'], c['bits'], c['values']) for c in quant]}, and "
          f"quantize_kernel equals the host quantize on the mesh; dividing "
          f"by a CPU scalar instead would miss "
          f"{[c['cpu_scalar_divisor_mismatches'] for c in quant]}")
    one["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 12: {one['phase_s']:.1f} s")
    # what phase 14.3 shards over the stream axis: the encoder with the
    # grid's topology cached, the grid, its encode(), and 12.4's row
    reuse = {"enc": enc, "mesh": mesh1, "blob": ref1, "q": q, "gathers": g,
             "tiles": tiles,
             "vmin": lo, "vmax": hi, "symbols": sym, "counts": counts}
    return one, k12, reuse


def _phase15(torch, np, native, tdev, tbatch, encode, reset_launch_counts,
             dev, sync, wall_s, cuda_ms, cuda_ms_batches, kernel_only_ms,
             max_abs_err, nbytes, bound, smi_line, positions, gathers,
             meshes, meshes3, blobs, blobs3, enc, enc3, reuse12,
             main_layouts):
    """The narrow upload layouts: uint8 at -qp <= 8 and the 12-bit pack at
    <= 12 (``parallel/batch.py`` ``upload_layout``). 15.1: K1 on each
    layout against its twin at the batch shape and at phase 12's row,
    with its times beside the uint16 layout's; 15.2: the host's pack and
    cast; 15.3: the copy of each layout's bytes from pageable numpy
    buffers; 15.4: encode_meshes_device at -qp 8, 11 and 15 with
    PACKED_UPLOAD on and off, positions only and with normals and UVs,
    every blob equal between the two, the positions-only ones to encode()
    (the textured ones: 8 a depth, and at -qp 11 all to phase 10's);
    15.5: phase 14's
    axis of SHARDS[-1] shards at -qp 11, both ways, equal to phase 10;
    15.6: encode_mesh_device on phase 12's grid at -qp 8 and 11, both
    ways, equal to the host plane. Returns (the phase's record, {kernel
    line name: entry})."""
    from torchdraco.encode import Config
    from torchdraco.models import AttributeType

    t_phase = time.perf_counter()
    rec = {"card": smi_line}

    def by_layout():
        return dict(tdev.predict_residual.n_launches_by_layout)

    def upload(q_host, layout):
        if layout == "u8":
            return torch.from_numpy(q_host.astype(np.uint8)).to(dev)
        if layout == "pack12":
            return tuple(torch.from_numpy(a).to(dev)
                         for a in native.pack12(q_host))
        return torch.from_numpy(q_host).to(dev)

    # 15.1: K1 on each layout, at the batch shape and at one row, where
    # the tiled kernel is timed over TILE_SWEEP too
    k1 = {}
    row_pos = np.ascontiguousarray(
        reuse12["mesh"].position_attribute().values, np.float32)[None]
    sweep = {t: tdev.predict_tiles(reuse12["gathers"], t)
             for t in TILE_SWEEP}
    for where, pos_f, g, tiles, kernel in (
            ("batch", positions, gathers, None, "predict_rows_kernel"),
            ("row", row_pos, reuse12["gathers"], reuse12["tiles"],
             "predict_tiled_kernel")):
        sym11 = None
        for layout, qp in (("u16", 11), ("pack12", 11), ("u8", 8)):
            q_host, _, _, vmin, vmax = native.quantize_batch(pos_f, qp)
            lo = torch.from_numpy(vmin).to(dev)
            hi = torch.from_numpy(vmax).to(dev)
            up = upload(q_host, layout)
            parts = up if isinstance(up, tuple) else (up,)
            staged = 1 if layout == "u8" else 2
            _check(tdev.predict_fits_smem(pos_f.shape[1], 3, staged)
                   == (where == "batch"),
                   f"15.1: K1's kernel choice for {layout} at the {where}")
            sym = tdev.predict_residual(up, g, lo, hi, tiles)
            sync()
            err = max_abs_err(sym, tdev.predict_residual_ref(up, g, lo, hi))
            if qp == 11:  # the pack reads the same values as uint16
                if sym11 is None:
                    sym11 = sym
                else:
                    err = max(err, max_abs_err(sym, sym11))
            runs = cuda_ms_batches(lambda: tdev.predict_residual(up, g, lo,
                                                                 hi, tiles))
            ops = 12 * sym.numel() + (6 * q_host.size if layout == "pack12"
                                      else 0)
            # what the kernel reads beside q: the gathers or the tables
            reads = (g.values() if tiles is None
                     else (tiles.verts, tiles.off, tiles.local))
            k1.setdefault(where, {})[layout] = {
                "shape": list(q_host.shape), "qp": qp,
                "max_abs_err": err, "ms": runs["median"], "ms_runs": runs,
                "plain_ms": cuda_ms(lambda: tdev.predict_residual_ref(
                    up, g, lo, hi), 5),
                "kernel_only_ms": kernel_only_ms(
                    lambda: tdev.predict_residual(up, g, lo, hi, tiles),
                    kernel, reps=10),
                **bound(nbytes(*parts, lo, hi, sym, *reads), ops)}
            if tiles is not None:
                k1[where][layout]["tile_sweep_kernel_only_ms"] = {
                    t: kernel_only_ms(lambda: tdev.predict_residual(
                        up, g, lo, hi, sweep[t]), kernel, reps=10)
                    for t in TILE_SWEEP}
            del up, parts, sym
        del sym11
    del sweep
    rec["k1"] = k1
    errs = [e["max_abs_err"] for w in k1.values() for e in w.values()]
    _check(all(e == 0 for e in errs), f"15.1: K1 on a layout differs from "
           f"its twin: {errs}")
    print("phase 15.1: K1 equals its twin on each layout (the pack also "
          "the uint16 layout's symbols); wrapper ms (median of "
          f"{BATCHES} x 50), alone ms, bound ms: " + "; ".join(
              f"{w} {lay} {e['ms']:.4f}, {e['kernel_only_ms']:.4f}, "
              f"{e['bound_ms']:.4f} ({e['bytes'] / 1e6:.2f} MB)"
              for w, d in k1.items() for lay, e in d.items())
          + "; the row's tiles " + "/".join(map(str, TILE_SWEEP))
          + " alone: " + ", ".join(
              f"{lay} " + "/".join(f"{v:.4f}" for v in
                                   e["tile_sweep_kernel_only_ms"].values())
              for lay, e in k1["row"].items()))

    # 15.2-15.3: the host's share and the copy, on the batch's values
    q11 = native.quantize_batch(positions, 11)[0]
    q8 = native.quantize_batch(positions, 8)[0]

    def host_ms(fn, reps=5):
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        return sorted(runs)[reps // 2]
    host = {"quantize_11_ms": host_ms(lambda: native.quantize_batch(
                positions, 11)),
            "pack12_ms": host_ms(lambda: native.pack12(q11)),
            "u8_cast_ms": host_ms(lambda: q8.astype(np.uint8))}
    bufs = {"u16": (q11,), "pack12": native.pack12(q11),
            "u8": (q8.astype(np.uint8),)}
    h2d = {k: [] for k in bufs}
    order = list(bufs)
    for r in range(6):  # in turns, the order reversed every other round
        for k in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sync()
            start.record()
            moved = [torch.from_numpy(a).to(dev) for a in bufs[k]]
            end.record()
            end.synchronize()
            h2d[k].append(start.elapsed_time(end))
            del moved
    copy = {k: {"mb": sum(a.nbytes for a in bufs[k]) / 1e6,
                "ms_runs": v, "ms": sorted(v)[len(v) // 2]}
            for k, v in h2d.items()}
    for v in copy.values():
        v["gb_s"] = v["mb"] / v["ms"]
    rec["host"], rec["h2d"] = host, copy
    print(f"phase 15.2: host ms on {q11.size} values: quantize (-qp 11) "
          f"{host['quantize_11_ms']:.2f}, pack12 {host['pack12_ms']:.2f}, "
          f"uint8 cast {host['u8_cast_ms']:.2f}")
    print("phase 15.3: pageable H2D (CUDA events, median of 6 in turns): "
          + "; ".join(f"{k} {v['mb']:.2f} MB {v['ms']:.3f} ms "
                      f"({v['gb_s']:.1f} GB/s)" for k, v in copy.items()))
    del bufs, q11, q8

    # 15.4: the batch path at three depths, both ways
    e2e, path_launches = {}, {}
    knobs = {"positions": (True, False, False, True),
             "textured": (True, False)}
    try:
        for qp, layout in ((8, "u8"), (11, "pack12"), (15, "u16")):
            cfg = Config(quant_bits={AttributeType.POSITION: qp})
            for name, encoder, ms_ in (("positions", enc, meshes),
                                       ("textured", enc3, meshes3)):
                runs, got_by = {True: [], False: []}, {}
                for knob in knobs[name]:
                    tbatch.PACKED_UPLOAD = knob
                    reset_launch_counts()
                    got, secs = wall_s(lambda: encoder.encode_meshes_device(
                        ms_, bits=qp))
                    lay = by_layout()
                    want_layout = layout if knob else "u16"
                    _check(lay == {k: int(k == want_layout) for k in lay},
                           f"15.4 -qp {qp} {name} knob {knob}: K1 "
                           f"launches by layout {lay}")
                    if knob and name == "positions":
                        path_launches[layout] = lay[layout]
                    _check(got_by.setdefault(knob, got) == got,
                           f"15.4 -qp {qp} {name}: two runs differ")
                    runs[knob].append({
                        "s": secs, "layout": want_layout,
                        **{k: encoder.timings[k] for k in (
                            "position_s", "chains_s", "h2d_mb")}})
                _check(got_by[True] == got_by[False],
                       f"15.4 -qp {qp} {name}: PACKED_UPLOAD on and off "
                       f"differ")
                if qp == 11:
                    _check(got_by[True] == (blobs if name == "positions"
                                            else blobs3),
                           f"15.4 -qp 11 {name}: differs from the main "
                           f"path's blobs")
                # every positions-only blob against encode(); of the
                # textured ones (about 20 ms a mesh on the host) 8, beside
                # their equality to phase 10's, which met the host plane
                sample = (range(len(ms_)) if name == "positions"
                          else range(0, len(ms_), len(ms_) // 8))
                bad = [i for i in sample
                       if got_by[True][i] != encode(ms_[i], cfg=cfg)]
                _check(not bad, f"15.4 -qp {qp} {name}: blobs {bad} differ "
                       f"from encode()")
                share = runs[True][0]["h2d_mb"] / runs[False][0]["h2d_mb"]
                _check(abs(share - {"u8": 0.5, "pack12": 0.75}.get(
                    layout, 1.0)) < 1e-9, f"15.4 -qp {qp}: h2d_mb share "
                       f"{share}")
                e2e[f"qp{qp}_{name}"] = {"layout": layout, "on": runs[True],
                                         "off": runs[False]}
    finally:
        tbatch.PACKED_UPLOAD = True
    rec["encode_meshes_device"] = e2e

    def mean(rs, k):
        return sum(r[k] for r in rs) / len(rs)
    print("phase 15.4: encode_meshes_device, every blob equal with "
          "PACKED_UPLOAD on and off, every positions-only blob and 8 "
          "textured ones at each depth equal to encode(); position_s "
          "on / off (h2d_mb on / off): " + "; ".join(
              f"{k} {mean(v['on'], 'position_s'):.4f} / "
              f"{mean(v['off'], 'position_s'):.4f} "
              f"({v['on'][0]['h2d_mb']:.2f} / {v['off'][0]['h2d_mb']:.2f})"
              for k, v in e2e.items()))

    # 15.5: phase 14's axis at -qp 11, both ways
    n = SHARDS[-1]
    axis = ([torch.device("cuda", i) for i in range(n)]
            if torch.cuda.device_count() >= n else [dev] * n)
    sharded = {}
    try:
        for knob in (True, False):
            tbatch.PACKED_UPLOAD = knob
            enc_n = tbatch.BatchEncoder(mesh_axis=axis)
            reset_launch_counts()
            got, secs = wall_s(lambda: enc_n.encode_meshes_device(meshes3))
            lay = by_layout()
            want_layout = "pack12" if knob else "u16"
            _check(lay[want_layout] == n and sum(lay.values()) == n,
                   f"15.5 knob {knob}: K1 launches by layout {lay}")
            _check(got == blobs3, f"15.5 knob {knob}: the blobs over {n} "
                   f"shards differ from phase 10's")
            sharded["on" if knob else "off"] = {
                "s": secs, "launches": lay,
                **{k: enc_n.timings[k] for k in ("position_s", "h2d_mb")}}
    finally:
        tbatch.PACKED_UPLOAD = True
    rec["sharded"] = sharded
    print(f"phase 15.5: {len(meshes3)} pos+normal+UV meshes over {axis} at "
          f"-qp 11 equal phase 10's with the pack "
          f"({sharded['on']['s']:.3f} s) and without "
          f"({sharded['off']['s']:.3f} s), K1 once a shard in its layout")

    # 15.6: the resident route on phase 12's grid, both ways
    enc12, mesh = reuse12["enc"], reuse12["mesh"]
    single, row_launches = {}, {}
    try:
        for qp in (8, 11):
            cfg = Config(quant_bits={AttributeType.POSITION: qp})
            want = (reuse12["blob"] if qp == 11
                    else enc12.encode_mesh(mesh, cfg=cfg))
            for knob in (True, False):
                tbatch.PACKED_UPLOAD = knob
                reset_launch_counts()
                blob, secs = wall_s(lambda: enc12.encode_mesh_device(
                    mesh, bits=qp))
                lay = by_layout()
                want_layout = tbatch.upload_layout(qp)
                _check(lay == {k: int(k == want_layout) for k in lay},
                       f"15.6 -qp {qp} knob {knob}: launches {lay}")
                _check(blob == want, f"15.6 -qp {qp} knob {knob}: the "
                       f"resident blob differs from the host plane's")
                if knob:
                    row_launches[want_layout] = lay[want_layout]
                single[f"qp{qp}_{'on' if knob else 'off'}"] = {
                    "s": secs, "layout": want_layout,
                    "position_s": enc12.timings["position_s"]}
    finally:
        tbatch.PACKED_UPLOAD = True
    rec["encode_mesh_device"] = single
    print(f"phase 15.6: encode_mesh_device on the "
          f"{mesh.position_attribute().num_points}-vertex grid at -qp 8 "
          f"and 11, the pack on and off, equal to the host plane; "
          + ", ".join(f"{k} {v['s']:.3f} s (position_s "
                      f"{v['position_s']:.4f})" for k, v in single.items()))

    replaces = {
        "u8": "tpudraco/ops/pallas_kernels.py:174 on the uint8 upload of "
              "tpudraco/parallel/batch.py:1587 (_jit_step_pallas_q :1643)",
        "pack12": "tpudraco/ops/pallas_kernels.py:174 after the unpack of "
                  "tpudraco/parallel/batch.py:1739 _jit_step_pallas_p12"}
    entries = {}
    for layout, name, launches in (
            ("u8", "predict_residual_u8", path_launches["u8"]),
            ("pack12", "predict_residual_p12", main_layouts["pack12"])):
        for where, suffix, runs_on in (
                ("batch", "", "phase 15.4 -qp 8" if layout == "u8"
                 else "phase 3, the main path"),
                ("row", "_long_row", "phase 15.6")):
            e = k1[where][layout]
            entries[name + suffix] = {
                "file": "predict_residual.cu", "replaces": replaces[layout],
                "layout": layout, "launched_on": runs_on,
                "launches": (launches if where == "batch"
                             else row_launches[layout]),
                "share_of_bound": e["bound_ms"] / e["ms"],
                "library_ms": None,
                **{k: e[k] for k in ("shape", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "bytes", "kernel_only_ms")}}
    rec["u16_launches"] = path_launches["u16"]
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 15: {rec['phase_s']:.1f} s")
    return rec, entries


def _router_knobs(sweep: dict, chunk: int) -> dict:
    """The router's three knobs from phase 13.2's sweep (rows of B, the
    device plane's wall with each entropy coder, and B times the host
    plane's time a mesh), per attribute set:
    MIN_DEVICE_GROUP: the least B from which the device plane (K3) beats
    the host plane at every larger B, over the sets, at least 2;
    PROBE_CHUNK: the least B at which the device plane's time
    a mesh is within twice its time a mesh at the largest B, over the sets,
    at most 128; PROBE_SKIP_S: the device plane's wall at PROBE_CHUNK, the
    cheaper set's. A crossover the sweep never reaches is 2 x chunk."""
    def least_from(rows, faster):
        best = None
        for r in reversed(rows):
            if not faster(r):
                break
            best = r["B"]
        return best

    never = 2 * chunk
    cross = [least_from(v["rows"], lambda r: r["device_entropy_s"]
                        < r["host_plane_s"]) for v in sweep.values()]
    cross = [c for c in cross if c is not None]
    probe = 1
    for v in sweep.values():
        rows = v["rows"]
        full = rows[-1]["device_entropy_s"] / rows[-1]["B"]
        w = next(r["B"] for r in rows
                 if r["device_entropy_s"] / r["B"] <= 2 * full)
        probe = max(probe, w)
    probe = min(probe, 128)
    skip = min(next(r["device_entropy_s"] for r in v["rows"]
                    if r["B"] >= probe) for v in sweep.values())
    return {"MIN_DEVICE_GROUP": max(2, min(cross)) if cross else never,
            "PROBE_SKIP_S": skip, "PROBE_CHUNK": probe}


def _phase13(torch, torchdraco, encode, tdev, trl, tbatch, tdb,
             reset_launch_counts, dev, sync, wall_s, smi_line, meshes,
             meshes3, root):
    """The corpus entry points on the card, from files on disk: the
    router's sweep (13.2, run first; its knobs are compared with the
    code's, which route 13.1 and 13.3), encode_corpus three ways over a
    mixed corpus (13.1), the router's
    decisions reused from disk (13.3), decode_corpus (13.4),
    transcode_corpus (13.5) and the torchdraco-corpus CLI (13.6), in the
    directory ``root`` (the corpus in ``in/``, the device plane's files in
    ``manual/``, which phase 14.4 reads). Returns the phase's record."""
    from torch.profiler import ProfilerActivity, profile
    from torchdraco.io import (DracoTranscoder, load_mesh, save_obj,
                               save_ply, save_scene_glb)
    from torchdraco.models.scene import Scene
    from torchdraco.parallel import transcode_corpus
    from torchdraco.tools.corpus import ENCODE_EXTS, _expand

    t_phase = time.perf_counter()
    Enc = tbatch.BatchEncoder
    knobs0 = {k: getattr(Enc, k) for k in ROUTER_KNOBS}
    corpus = {"card": smi_line, "workers": CORPUS_WORKERS}
    counted = (tdev.predict_residual, tdev.histogram, trl.rans_words_scan)
    # 13.2 first: encode_meshes_device at 1 ... SWEEP_MAX meshes with
    # either coder, against the host plane a mesh (warm)
    widths = [1 << i for i in range(SWEEP_MAX.bit_length())
              if 1 << i <= SWEEP_MAX]
    sweep = {}
    for name, ms in (("positions", meshes),
                     ("positions_normals_uvs", meshes3)):
        enc = Enc(device=dev)
        enc.encode_meshes_device(ms[:1])
        enc.encode_mesh(ms[0])
        k = min(SWEEP_HOST_MESHES, len(ms))
        per_mesh = min(wall_s(lambda: [enc.encode_mesh(m)
                                       for m in ms[:k]])[1]
                       for _ in range(2)) / k
        rows = []
        for B in widths:
            reps = 2 if B <= 64 else 1
            got = {}
            for ent in ("device", "host"):
                runs = []
                for _ in range(reps):
                    got[ent], w = wall_s(
                        lambda: enc.encode_meshes_device(ms[:B],
                                                         entropy=ent))
                    runs.append(w)
                got[ent + "_s"] = min(runs)
            _check(got["device"] == got["host"],
                   f"entropy='host' differs from 'device' at B={B}")
            rows.append({"B": B, "device_entropy_s": got["device_s"],
                         "host_entropy_s": got["host_s"],
                         "host_plane_s": B * per_mesh})
        sweep[name] = {"host_plane_s_per_mesh": per_mesh, "rows": rows}
    knobs = _router_knobs(sweep, Enc.DEVICE_CHUNK)
    drift = sorted(k for k, v in knobs.items()
                   if not knobs0[k] / KNOB_DRIFT <= v
                   <= knobs0[k] * KNOB_DRIFT)
    corpus["sweep"] = sweep
    corpus["knobs_from_sweep"] = knobs
    corpus["knobs_in_code"] = knobs0
    corpus["knobs_drifted"] = drift
    print(f"phase 13.2 (run first; 13.1 and 13.3 route with the knobs "
          f"in the code): "
          f"encode_meshes_device walls s (entropy='device' / 'host') "
          f"against the host plane (B x a mesh, warm), B = {widths}: "
          + "; ".join(
              f"{name}: host {v['host_plane_s_per_mesh'] * 1e3:.3f} ms "
              f"a mesh, " + ", ".join(
                  f"{r['B']}: {r['device_entropy_s']:.4f} / "
                  f"{r['host_entropy_s']:.4f} vs "
                  f"{r['host_plane_s']:.4f}" for r in v["rows"])
              for name, v in sweep.items())
          + f"; knobs from the sweep {knobs}, in the code {knobs0}; "
          f"drifted beyond {KNOB_DRIFT}x: {drift or 'none'}")

    # 13.1: the mixed corpus, written with the port's writers
    src = os.path.join(root, "in")
    os.makedirs(src)
    _, write_s = wall_s(lambda: _write_corpus(
        torchdraco, Scene, save_obj, save_ply, save_scene_glb, meshes3,
        src))
    inputs = _expand([src], ENCODE_EXTS)
    n_groups = 1 + CORPUS_GROUPS + CORPUS_SINGLES + 1
    _check(LONE_GRID ** 2 >= Enc.CHUNKED_MIN_VERTS << 2,
           "the lone grid is below the router's lone-mesh threshold")
    _check(len(inputs) <= Enc.DEVICE_CORPUS_WINDOW,
           "the corpus spans windows")
    cache = os.path.join(root, "route_cache.json")

    def run(plane, out, enc=None):
        enc = enc or Enc(use_device=plane, device=dev,
                         route_cache_path=cache)
        rep, secs = wall_s(lambda: enc.encode_corpus(
            inputs, os.path.join(root, out), resume=False,
            workers=CORPUS_WORKERS))
        return enc, rep, secs

    _, rep_h, host_s = run(False, "host")
    # the device plane, counted and traced (the trace costs it about
    # 5% of its wall): the device's busy time and idle share
    reset_launch_counts()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        enc_m, rep_m, manual_s = run(True, "manual")
    launches_m = {fn.__name__: fn.n_launches for fn in counted}
    spans = [(e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(spans)
    trace_m = {"wall_s": manual_s, "busy_s": busy / 1e6,
               "device_events": len(spans),
               "idle_share": (1 - busy / 1e6 / manual_s) if spans
               else None}
    enc_a = Enc(use_device="auto", device=dev, route_cache_path=cache)
    huge_calls = []
    real_huge = enc_a._encode_huge

    def huge_spy(mesh, device=None):
        huge_calls.append(mesh.position_attribute().num_points)
        return real_huge(mesh, device=device)
    enc_a._encode_huge = huge_spy
    _, rep_a, auto_s = run("auto", "auto", enc_a)

    def drc_files(out):
        d = os.path.join(root, out)
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d)) if f.endswith(".drc")}
    files = {out: drc_files(out) for out in ("host", "manual", "auto")}
    _check(len(files["host"]) == rep_h["encoded"] and all(
        files[o] == files["host"] for o in ("manual", "auto")),
        "the three encode planes disagree on the .drc files")
    _check(all(r["encoded"] == rep_h["encoded"]
               and r["failed"] == rep_h["failed"]
               for r in (rep_m, rep_a)),
           "the reports disagree on encoded or failed")
    failed = sorted(os.path.basename(f["path"]) for f in rep_h["failed"])
    _check(failed == ["b0_nan.ply", "broken.glb", "s00.ply"]
           and "non-finite" in str(rep_h["failed"]),
           f"the broken file, the NaN vertex and the collision: "
           f"{rep_h['failed']}")
    _check(all(n == n_groups for n in launches_m.values()),
           f"K1, K2 and K3 launch once per device chunk "
           f"({n_groups}): {launches_m}")
    by_name = {os.path.splitext(os.path.basename(p))[0] + ".drc": p
               for p in reversed(inputs)}
    names = sorted(files["manual"])
    sample = names[::max(1, len(names) // 32)][:32]
    bad = [n for n in sample
           if encode(load_mesh(by_name[n])) != files["manual"][n]]
    _check(not bad, f"corpus blobs differ from encode(): {bad[:5]}")
    routing = rep_a["routing"]
    lone = [e for e in routing if e["verts"] == LONE_GRID ** 2]
    _check(len(routing) == n_groups and len(lone) == 1
           and lone[0]["plane"] == "device"
           and huge_calls == [LONE_GRID ** 2],
           f"the router: {len(routing)} entries for {n_groups} groups, "
           f"lone {lone}, _encode_huge calls {huge_calls}")
    mb_in = rep_h["total_in_bytes"] / 1e6
    mb_out = rep_h["total_out_bytes"] / 1e6
    corpus["encode"] = {
        "files": len(inputs), "groups": n_groups, "write_s": write_s,
        "mb_in": mb_in, "mb_out": mb_out, "host_s": host_s,
        "manual_s": manual_s, "auto_s": auto_s,
        "stages_s": {"host": rep_h["stages_s"],
                     "manual": rep_m["stages_s"],
                     "auto": rep_a["stages_s"]},
        "manual_device_stages_s": dict(enc_m.timings),
        "launches_manual": launches_m, "routing": routing,
        "trace_manual": trace_m, "failed": rep_h["failed"]}
    print(f"phase 13.1: encode_corpus over {len(inputs)} files "
          f"({n_groups} topology groups, {mb_in:.1f} MB in, "
          f"{mb_out:.2f} MB of .drc out, {CORPUS_WORKERS} workers; "
          f"written in {write_s:.1f} s): host-only {host_s:.2f} s "
          f"{rep_h['stages_s']}, use_device=True (traced) "
          f"{manual_s:.2f} s {rep_m['stages_s']} (the device plane's "
          f"{ {k: round(v, 3) for k, v in enc_m.timings.items()} }), "
          f"use_device='auto' "
          f"{auto_s:.2f} s {rep_a['stages_s']}; every .drc equal across "
          f"the three, "
          f"{len(sample)} sampled equal encode(); failed "
          f"{failed}; launches {launches_m}; routing "
          f"{[(e['meshes'], e['plane'], e.get('reason', 'probe')) for e in routing if e['meshes'] > 1 or e is lone[0]]}"
          f"; the lone mesh through _encode_huge; the traced manual "
          f"run's device busy {busy / 1e6:.3f} s over {len(spans)} "
          f"device events, idle share {trace_m['idle_share']}")

    # 13.3: the decisions reused by a fresh encoder from the disk
    enc_b = Enc(use_device="auto", device=dev, route_cache_path=cache)
    _, rep_b, auto2_s = run("auto", "auto2", enc_b)
    static = ("cached decision (disk)", "small group",
              "single mesh (static)")
    probed = [e for e in rep_b["routing"]
              if "host_s_per_mesh" in e
              or not str(e.get("reason", "")).startswith(static)
              and not str(e.get("reason", "")).startswith(
                  "single mesh (measured")]
    _check(not probed, f"the second auto pass probed: {probed}")
    _check(drc_files("auto2") == files["auto"],
           "the second auto pass differs from the first")
    corpus["reuse"] = {"auto2_s": auto2_s, "auto_s": auto_s,
                       "host_s": host_s, "routing": rep_b["routing"]}
    print(f"phase 13.3: a fresh encoder on the same route cache: "
          f"{len(rep_b['routing'])} groups, reasons "
          f"{sorted({e['reason'] for e in rep_b['routing']})}, no probe;"
          f" bytes equal 13.1's; auto {auto_s:.2f} s then "
          f"{auto2_s:.2f} s against host-only {host_s:.2f} s")

    # 13.4: decode_corpus over 13.1's .drc files, device and host
    drcs = [os.path.join(root, "manual", n) for n in names]
    bd = tdb.BatchDecoder()
    reset_launch_counts()
    rep_dd, dec_dev_s = wall_s(lambda: bd.decode_corpus(
        drcs, os.path.join(root, "dec_dev"), fmt="ply",
        workers=CORPUS_WORKERS, device=dev))
    d1 = trl.rans_decode_lanes.n_launches
    rep_dh, dec_host_s = wall_s(lambda: tdb.BatchDecoder().decode_corpus(
        drcs, os.path.join(root, "dec_host"), fmt="ply",
        workers=CORPUS_WORKERS, use_device=False))

    def ply_files(out):
        d = os.path.join(root, out)
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d)) if f.endswith(".ply")}
    plys = ply_files("dec_dev")
    _check(len(plys) == len(drcs) and plys == ply_files("dec_host")
           and rep_dd["failed"] == [] and rep_dh["failed"] == [],
           "decode_corpus: the device and host planes disagree")
    _check(d1 > 0 and bd.n_host_blobs == 0,
           f"decode_corpus: D1 launches {d1}, host blobs "
           f"{bd.n_host_blobs}")
    corpus["decode"] = {"device_s": dec_dev_s, "host_s": dec_host_s,
                        "stages_s": {"device": rep_dd["stages_s"],
                                     "host": rep_dh["stages_s"]},
                        "files": len(drcs), "d1_launches": d1,
                        "mb_out": sum(len(v) for v in plys.values())
                        / 1e6}
    print(f"phase 13.4: decode_corpus of {len(drcs)} .drc files to "
          f"PLY: device {dec_dev_s:.2f} s {rep_dd['stages_s']} ({d1} "
          f"D1 launches, 0 host blobs) against host-only "
          f"{dec_host_s:.2f} s; every file equal")

    # 13.5: transcode_corpus over GLBs of shared primitives
    tsrc = os.path.join(root, "glb_in")
    os.makedirs(tsrc)
    glbs = _write_glb_corpus(torchdraco, Scene, save_scene_glb, tsrc)
    tin = glbs + [glbs[0], os.path.join(tsrc, "broken.glb")]
    reset_launch_counts()
    rep_td, tr_dev_s = wall_s(lambda: transcode_corpus(
        tin, os.path.join(root, "tr_dev"), device=dev))
    launches_t = {fn.__name__: fn.n_launches for fn in counted}
    rep_th, tr_host_s = wall_s(lambda: transcode_corpus(
        tin, os.path.join(root, "tr_host"), use_device=False))

    def glb_files(out):
        d = os.path.join(root, out)
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d)) if f.endswith(".glb")}
    out_dev = glb_files("tr_dev")
    one_path = os.path.join(root, "one.glb")
    DracoTranscoder().transcode_file(glbs[0], one_path)
    _check(len(out_dev) == len(glbs) and out_dev == glb_files("tr_host")
           and rep_td["transcoded"] == len(glbs)
           and len(rep_td["failed"]) == 1,
           f"transcode_corpus: the planes disagree ({rep_td})")
    _check(rep_td["encoder_hook_misses"] == 0,
           f"transcode_corpus: hook misses ({rep_td})")
    _check(open(one_path, "rb").read()
           == out_dev[os.path.basename(glbs[0])],
           "transcode_corpus differs from DracoTranscoder")
    _check(min(launches_t.values()) > 0
           and len(set(launches_t.values())) == 1,
           f"transcode launches {launches_t}")
    corpus["transcode"] = {
        "files": len(glbs), "device_s": tr_dev_s, "host_s": tr_host_s,
        "launches": launches_t, "mb_in": rep_td["total_in_bytes"] / 1e6,
        "mb_out": rep_td["total_out_bytes"] / 1e6}
    print(f"phase 13.5: transcode_corpus of {len(glbs)} GLBs (+ a "
          f"duplicate input and a broken file): device {tr_dev_s:.2f} s "
          f"(launches {launches_t}, 0 hook misses) against "
          f"host-only {tr_host_s:.2f} s; every GLB equal, and equal to "
          f"DracoTranscoder")

    # 13.6: the CLI, with no flags: the card
    cli_out = os.path.join(root, "cli")
    proc, cli_s = wall_s(lambda: subprocess.run(
        [sys.executable, "-m", "torchdraco.tools.corpus", "encode",
         "-i", src, "-o", cli_out, *CLI_DEVICE_ARGS],
        capture_output=True, text=True, timeout=600, cwd=ROOT))
    _check(proc.returncode == 1, f"the CLI exits 1 on the three failed "
           f"files: rc {proc.returncode}, "
           f"{proc.stderr[-2000:]}")
    _check(drc_files("cli") == files["manual"],
           "the CLI's .drc files differ from 13.1's")
    corpus["cli_s"] = cli_s
    print(f"phase 13.6: python -m torchdraco.tools.corpus encode "
          f"{' '.join(CLI_DEVICE_ARGS) or '(no flags)'}: {cli_s:.2f} s "
          f"in its own process, rc 1 (the three failed files), every .drc "
          f"equal 13.1's")
    corpus["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13: {corpus['phase_s']:.1f} s")
    return corpus


def _phase14(torch, np, torchdraco, tdev, trl, tbatch, reset_launch_counts,
             wall_s, cuda_ms, kernel_only_ms, smi_line, meshes3, blobs3,
             dev_runs10, lanes6, reuse12, corpus_root):
    """Several devices, as shards of an axis that names the one card
    n times (n distinct cards where the machine has them): the batch cell
    over n = SHARDS (14.1), the lane coder over phase 6's lanes (14.2),
    phase 12's grid over the stream axis (14.3), phase 13's corpus in two
    processes joined by gloo, through the function and the CLI (14.4),
    and dryrun_multichip (14.5). Every result equals its unsharded
    counterpart's. Returns the phase's record."""
    import socket

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()

    def axis_of(n):
        return ([f"cuda:{i}" for i in range(n)] if n_cards >= n
                else ["cuda:0"] * n)
    rec = {"card": smi_line, "cards": n_cards,
           "axes": {n: axis_of(n) for n in (*SHARDS, STREAM_SHARDS)}}
    print(f"phase 14: shard axes {rec['axes']} ({n_cards} card(s))")
    from torchdraco.ops import normals as tnorm
    from torchdraco.ops import texcoords as ttex
    counted = (tdev.predict_residual, tdev.histogram, trl.rans_words_scan,
               tnorm.normal_encode_cuda, ttex.uv_encode_cuda)

    # 14.1: the batch cell, both coders, counted
    batch = {}
    for n in SHARDS:
        for ent in ("device", "host"):
            enc = tbatch.BatchEncoder(mesh_axis=axis_of(n))
            reset_launch_counts()
            got, first_s = wall_s(lambda: enc.encode_meshes_device(
                meshes3, entropy=ent))
            launches = {fn.__name__: fn.n_launches for fn in counted}
            per = n * -(-len(meshes3) // enc.DEVICE_CHUNK)
            want = {"predict_residual": per, "histogram": per,
                    "rans_words_scan": per if ent == "device" else 0,
                    "normal_encode_cuda": per, "uv_encode_cuda": per}
            _check(launches == want, f"14.1 n={n} entropy={ent}: launches "
                   f"{launches}, want {want}")
            _check(enc.n_host_attributes == 0,
                   f"14.1: {enc.n_host_attributes} host attributes")
            bad = [i for i, (a, b) in enumerate(zip(got, blobs3)) if a != b]
            _check(len(got) == len(blobs3) and not bad,
                   f"14.1 n={n} entropy={ent}: {len(bad)} blobs differ from "
                   f"phase 10's (first {bad[:5]})")
            warm, warm_s = wall_s(lambda: enc.encode_meshes_device(
                meshes3, entropy=ent))
            _check(warm == blobs3, f"14.1 n={n}: a warm run differs")
            batch[f"n{n}_{ent}"] = {"first_call_s": first_s,
                                    "warm_s": warm_s, "launches": launches,
                                    "stages_s": dict(enc.timings)}
    rec["batch"] = batch
    rec["launches"] = dict(batch[f"n{SHARDS[-1]}_device"]["launches"])
    print(f"phase 14.1: encode_meshes_device over axes of {SHARDS} on "
          f"{len(meshes3)} pos+normal+UV meshes, both coders: every blob "
          f"equals phase 10's, 0 host attributes, K1/K2/K3/C1/C3 n a chunk; "
          f"warm "
          f"s " + ", ".join(f"{k} {v['warm_s']:.3f} (first "
                            f"{v['first_call_s']:.3f})"
                            for k, v in batch.items())
          + f" against phase 10's unsharded {min(dev_runs10):.3f}")

    # 14.2: the lane coder over phase 6's lanes, both engines, per-lane
    # and shared tables
    lanes_dev, f6, c6, len6, bufs_d, nb_d = lanes6
    axis = axis_of(SHARDS[-1])
    counts = np.bincount(lanes_dev.cpu().numpy().ravel())
    from torchdraco.entropy.rans import normalize_freq_counts
    dist = normalize_freq_counts(counts, LANE_P)
    cums = np.concatenate([[0], np.cumsum(dist)[:-1]])
    shared = trl.rans_encode_lanes(lanes_dev, dist, cums, len6,
                                   precision=LANE_P)
    lanes = {}
    for tables, (f, c), want in (("per_lane", (f6, c6), (bufs_d, nb_d)),
                                 ("shared", (dist, cums), shared)):
        for dense in (False, True):
            reset_launch_counts()
            got, secs = wall_s(lambda: trl.rans_encode_lanes(
                lanes_dev, f, c, len6, precision=LANE_P, dense=dense,
                mesh_axis=axis))
            name = "rans_scan_dense" if dense else "rans_words_scan"
            n_l = getattr(trl, name).n_launches
            _check(n_l == len(axis), f"14.2 {tables} {name}: {n_l} launches")
            _check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                   f"14.2 {tables} dense={dense}: bytes differ")
            lanes[f"{tables}_{name}"] = {"s": secs, "launches": n_l}
            if dense:
                rec["launches"]["rans_scan_dense"] = n_l
    # K3 alone on one shard's lanes against all of them: a lane is a
    # chain of dependent steps, so a quarter of the lanes should take
    # about the whole time, and n shards on one card n times it
    L = lanes_dev.shape[0]
    k3_ms = {}
    for rows in (L // len(axis), L):
        args = (lanes_dev[:rows].to(torch.int32).flip(1).contiguous(),
                f6[:rows].to(torch.int32).contiguous(),
                c6[:rows].to(torch.int32).contiguous(),
                torch.full((rows,), LANE_P, dtype=torch.int32,
                           device=lanes_dev.device),
                len6[:rows].to(torch.int32).contiguous())
        k3_ms[rows] = cuda_ms(lambda: trl.rans_words_scan(*args), 5)
    lanes["k3_ms_by_lanes"] = k3_ms
    rec["lanes"] = lanes
    print(f"phase 14.2: rans_encode_lanes over {len(axis)} shards of "
          f"{L} lanes x {lanes_dev.shape[1]}: per-lane tables equal phase "
          f"6's bytes, the shared table the unsharded call's, both "
          f"engines, one launch a shard; s "
          f"{ {k: round(v['s'], 4) for k, v in lanes.items() if 's' in v} }"
          f"; K3 ms by lanes {k3_ms}")

    # 14.3: phase 12's grid over the stream axis, on its encoder
    enc, mesh = reuse12["enc"], reuse12["mesh"]
    axis = axis_of(STREAM_SHARDS)
    host_blob, host_s = wall_s(lambda: enc.encode_mesh(mesh))
    _check(host_blob == reuse12["blob"], "14.3: encode_mesh differs")
    reset_launch_counts()
    blob, first_s = wall_s(lambda: enc.encode_mesh_device_stream_sharded(
        mesh, axis))
    launches = {fn.__name__: fn.n_launches for fn in counted[:2]}
    _check(blob == host_blob, "14.3: the stream-sharded blob differs from "
           "the host plane's")
    _check(launches == {"predict_residual": len(axis),
                        "histogram": len(axis)},
           f"14.3: launches {launches}")
    warm = []
    for _ in range(2):
        b, secs = wall_s(lambda: enc.encode_mesh_device_stream_sharded(
            mesh, axis))
        _check(b == host_blob, "14.3: a warm run differs")
        warm.append(secs)
    stages = dict(enc.timings)
    parts, summed = tdev.encode_step_stream_sharded(
        reuse12["q"], reuse12["gathers"], reuse12["vmin"], reuse12["vmax"],
        bits=BITS, mesh_axis=axis)
    _check(torch.equal(summed, reuse12["counts"]),
           "14.3: the summed histogram differs from phase 12's K2 row")
    _check(torch.equal(torch.cat(parts, dim=1), reuse12["symbols"]),
           "14.3: the segments differ from phase 12's K1 row")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bins = tdev.default_hist_bins(BITS)
    splits = [tdev.histogram_splits(1, p.numel(), bins, sms) for p in parts]
    # K2 on one segment (fewer blocks than the card has SMs) beside the
    # whole row: by the wrapper (CUDA events) and alone (a trace)
    seg_row = parts[0].reshape(1, -1)
    whole_row = reuse12["symbols"].reshape(1, -1)
    k2_seg = {}
    for name, row in (("segment", seg_row), ("whole_row", whole_row)):
        k2_seg[name] = {
            "symbols": int(row.numel()),
            "blocks": tdev.histogram_splits(1, row.numel(), bins, sms),
            "ms": cuda_ms(lambda: tdev.histogram(row, bins), 20),
            "kernel_only_ms": kernel_only_ms(
                lambda: tdev.histogram(row, bins), "histogram_smem_kernel",
                reps=10)}
    rec["stream"] = {"first_call_s": first_s, "warm_s": warm,
                     "stages_s": stages, "host_plane_s": host_s,
                     "launches": launches, "k2_blocks_a_segment": splits,
                     "k2_blocks_whole_row": tdev.histogram_splits(
                         1, reuse12["symbols"].numel(), bins, sms),
                     "k2_segment_against_row": k2_seg}
    print(f"phase 14.3: encode_mesh_device_stream_sharded, "
          f"{mesh.position_attribute().num_points} vertices over "
          f"{len(axis)} segments: equals encode_mesh ({host_s:.3f} s); "
          f"launches {launches}; the summed histogram equals phase 12's K2 "
          f"row and the segments its K1 row; first call {first_s:.3f} s, "
          f"warm {[round(x, 3) for x in warm]} s "
          f"{ {k: round(v, 3) for k, v in stages.items()} }; K2 blocks a "
          f"segment {splits} against {rec['stream']['k2_blocks_whole_row']} "
          f"for the whole row on {sms} SMs; K2 ms (wrapper, alone) a "
          f"segment {k2_seg['segment']['ms']:.4f}, "
          f"{k2_seg['segment']['kernel_only_ms']:.4f}, the whole row "
          f"{k2_seg['whole_row']['ms']:.4f}, "
          f"{k2_seg['whole_row']['kernel_only_ms']:.4f}")

    # 14.4: phase 13's corpus in two processes joined by gloo on localhost
    src = os.path.join(corpus_root, "in")

    def drc_files(d):
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d)) if f.endswith(".drc")}
    want = drc_files(os.path.join(corpus_root, "manual"))

    def two_ranks(cmd):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                                WORLD_SIZE="2", MASTER_ADDR="localhost",
                                MASTER_PORT=str(port),
                                TORCHDRACO_ROUTE_CACHE=""))
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=MH_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [(p.returncode, *o) for p, o in zip(procs, outs)]

    mh = {}
    out = os.path.join(corpus_root, "multihost")
    code = "\n".join((
        f"import json, sys; sys.path.insert(0, {ROOT!r})",
        "import torch.distributed as dist",
        "from torchdraco.parallel import (encode_corpus_multihost, "
        "init_distributed)",
        "from torchdraco.tools.corpus import ENCODE_EXTS, _expand",
        "init_distributed()",
        f"rep = encode_corpus_multihost(_expand([{src!r}], ENCODE_EXTS), "
        f"{out!r}, workers={CORPUS_WORKERS // 2}, device={MH_DEVICE!r})",
        "print(json.dumps(rep))",
        "dist.destroy_process_group()"))
    for how, cmd, d in (
            ("function", [sys.executable, "-c", code], out),
            ("cli", [sys.executable, "-m", "torchdraco.tools.corpus",
                     "encode", "-i", src, "-o",
                     os.path.join(corpus_root, "multihost_cli"),
                     "--workers", str(CORPUS_WORKERS // 2),
                     *CLI_DEVICE_ARGS],
             os.path.join(corpus_root, "multihost_cli"))):
        runs, secs = wall_s(lambda: two_ranks(cmd))
        reports = []
        for rc, text, err in runs:
            _check(rc in (0, 1), f"14.4 {how}: a rank exited {rc}: "
                   f"{err[-2000:]}")
            try:  # the rank's report: its whole standard output
                reports.append(json.loads(text))
            except ValueError:
                _fail(f"14.4 {how}: no report from a rank: {text[-500:]} "
                      f"{err[-2000:]}")
            _check(rc == (1 if how == "cli" and reports[-1]["failed"]
                          else 0), f"14.4 {how}: rc {rc}, "
                   f"{reports[-1]['failed']}")
        got = drc_files(d)
        _check(got == want, f"14.4 {how}: the two ranks' .drc files differ "
               f"from 13.1's ({len(got)} against {len(want)})")
        _check(all(r["num_hosts"] == 2 and r["encoded"] == len(want)
                   and r["total_out_bytes"] == sum(map(len, want.values()))
                   for r in reports),
               f"14.4 {how}: the merged totals "
               f"{[(r.get('num_hosts'), r['encoded']) for r in reports]}")
        failed = sorted(os.path.basename(f["path"])
                        for r in reports for f in r["failed"])
        _check(failed == ["b0_nan.ply", "broken.glb", "s00.ply"],
               f"14.4 {how}: failed {failed}")
        mh[how] = {"s": secs, "per_rank_s": [r["seconds"] for r in reports],
                   "failed_per_rank": [len(r["failed"]) for r in reports]}
    rec["multihost"] = mh
    print(f"phase 14.4: encode_corpus_multihost, 2 processes on gloo "
          f"(function {mh['function']['s']:.2f} s, ranks "
          f"{mh['function']['per_rank_s']} s; the CLI under WORLD_SIZE=2 "
          f"{mh['cli']['s']:.2f} s, ranks {mh['cli']['per_rank_s']} s): "
          f"{len(want)} .drc files equal 13.1's, both ranks report the "
          f"merged totals with num_hosts 2, the three failed inputs "
          f"reported once")

    # 14.5
    _, dry_s = wall_s(lambda: torchdraco.dryrun_multichip(4))
    rec["dryrun_s"] = dry_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14.5: dryrun_multichip(4) in {dry_s:.2f} s")
    print(f"phase 14: {rec['phase_s']:.1f} s")
    return rec


def _write_corpus(torchdraco, Scene, save_obj, save_ply, save_scene_glb,
                  meshes3, src) -> None:
    """Phase 13.1's inputs in ``src``: the batch meshes as GLB, the
    topology groups as PLY, the single meshes as OBJ, the lone grid as
    PLY, one broken GLB, b0_nan.ply (of group 0's topology, a NaN vertex:
    it loads, and the encoder refuses it), and s00.ply, whose output name
    collides with s00.obj's."""
    for i, m in enumerate(meshes3):
        sc = Scene()
        sc.add_mesh(m)
        save_scene_glb(sc, os.path.join(src, f"a{i:03d}.glb"),
                       compress=False)
    for g in range(CORPUS_GROUPS):  # a fan vertex of valence g + 1 each
        p, f = torchdraco.make_mesh_batch(CORPUS_GROUP_N, CORPUS_GRID,
                                          SEED + g, fan=g + 1)
        group = torchdraco.build_meshes(p, f)
        for i, m in enumerate(group):
            save_ply(m, os.path.join(src, f"b{g}_{i:02d}.ply"))
        if g == 0:
            group[0].position_attribute().values[0, :] = float("nan")
            save_ply(group[0], os.path.join(src, "b0_nan.ply"))
    for j in range(CORPUS_SINGLES):
        p, f = torchdraco.make_mesh_batch(1, 8 + j, SEED + 100 + j)
        save_obj(torchdraco.build_meshes(p, f)[0],
                 os.path.join(src, f"s{j:02d}.obj"))
    p, f = torchdraco.make_mesh_batch(1, LONE_GRID, SEED)
    save_ply(torchdraco.build_meshes(p, f)[0], os.path.join(src, "lone.ply"))
    with open(os.path.join(src, "broken.glb"), "wb") as fh:
        fh.write(b"glTF\x02\x00\x00\x00 not a scene")
    p, f = torchdraco.make_mesh_batch(1, 9, SEED + 200)
    save_ply(torchdraco.build_meshes(p, f)[0], os.path.join(src, "s00.ply"))


def _write_glb_corpus(torchdraco, Scene, save_scene_glb, src) -> list:
    """Phase 13.5's GLBs: file i holds 2 + i % 3 primitives, primitive j
    of topology (i + j) % TRANSCODE_TOPOLOGIES (grids of 16, 17, ...
    vertices a side, normals and UVs), each drawn from a pool of
    TRANSCODE_POOL meshes of that topology, so that primitives repeat
    across files. Returns the paths, and writes a broken GLB beside."""
    pools = []
    for t in range(TRANSCODE_TOPOLOGIES):
        n = 16 + t
        p, f = torchdraco.make_mesh_batch(TRANSCODE_POOL, n, SEED + 300 + t)
        nrm, uvs = torchdraco.make_normal_uv_batch(p, n, SEED + 400 + t)
        pools.append(torchdraco.build_meshes(p, f, nrm, uvs))
    paths = []
    for i in range(TRANSCODE_FILES):
        sc = Scene()
        for j in range(2 + i % 3):
            sc.add_mesh(pools[(i + j) % TRANSCODE_TOPOLOGIES]
                        [(3 * i + j) % TRANSCODE_POOL])
        path = os.path.join(src, f"t{i:02d}.glb")
        save_scene_glb(sc, path, compress=False)
        paths.append(path)
    with open(os.path.join(src, "broken.glb"), "wb") as fh:
        fh.write(b"glTF\x02\x00\x00\x00 not a scene")
    return paths


def _bank_replays(local, itemsize: int) -> float:
    """Shared-memory wavefronts a warp's gather of one index takes in K1's
    tiled kernel, averaged over the warps and the indices a step reads,
    counted from the tile tables' local indices ((5, T), -1 unread). A
    vertex's slot is 4 staged values (``csrc/predict_residual.cu``
    ``Slot``), W = itemsize 32-bit words read by one vector load, which
    the card serves in W phases of 32 / W lanes; in a phase, distinct
    slots whose index agrees modulo 32 / W share banks. W is the least."""
    import numpy as np
    W = itemsize
    group = 32 // W
    T = local.shape[1]
    loc = np.pad(local.astype(np.int64), ((0, 0), (0, -T % 32)),
                 constant_values=-1).reshape(5, -1, 32)
    total, count = 0.0, 0
    for k in range(5):
        waves = np.zeros(loc.shape[1])
        for p in range(W):
            lanes = np.sort(loc[k][:, p * group:(p + 1) * group], axis=1)
            first = np.ones_like(lanes, dtype=bool)
            first[:, 1:] = lanes[:, 1:] != lanes[:, :-1]
            first &= lanes >= 0
            rows = np.repeat(np.arange(lanes.shape[0]), group)
            per = np.bincount(rows * group + lanes.ravel() % group,
                              weights=first.ravel(),
                              minlength=lanes.shape[0] * group)
            waves += per.reshape(-1, group).max(axis=1)
        live = (loc[k] >= 0).any(axis=1)
        total += float(waves[live].sum())
        count += int(live.sum())
    return total / max(count, 1)


def _phase17(torch, np, native, tdev, tbatch, trl, encode,
             reset_launch_counts, dev, sync, wall_s, cuda_ms,
             cuda_ms_batches, kernel_only_ms, max_abs_err, nbytes, bound,
             traced, smi_line, positions64, gathers64, meshes64):
    """The main path at real mesh sizes and depths. 17.1: for each batch of
    REAL_BATCHES (a 32-frame capture of 256 x 256 grids, 8 scan tiles or
    CAD parts of 512 x 512; seed SEED, positions only) and each -qp of
    REAL_QP, ``encode_meshes_device`` on the card (a first call, then one
    counted: K1's tiled kernel once, never the direct gather, K2's wide
    form at 15 and 16, in the layout of the depth), every blob equal to
    the host plane (``encode_meshes``) and the first and last to
    ``encode()``; the 512^2 batch at -qp 11 traced for the idle share.
    17.2: the tiled K1 against its plain version at both batch shapes in
    the pack, uint16 and uint8 layouts, timed beside the direct-gather
    kernel on the same inputs and over TILE_SWEEP, with the bank replays
    of its staged tile; and at the 64 x 64 batch's (512, 4096, 3), where
    the rows kernel runs, the tiled kernel timed beside it. 17.3: K2's
    wide form against its plain version at (512, 12288) on the 64 x 64
    batch's own -qp 15 symbols and at (32, 196608) on the 256^2 batch's
    -qp 15 and 16 symbols (2^16, 2^17 bins) and on uniform ones at 2^17,
    timed beside ``torch.bincount``. 17.4: the -qp 15 batch of 512 64 x 64 meshes:
    ``position_s`` split by stage (the host quantize, the upload, the
    fused step, the entropy stage), a host profile of one call and a
    device trace. Returns (the phase's record, {kernel line name:
    entry})."""
    import cProfile
    import io
    import pstats

    import torchdraco
    from torchdraco.encode import Config
    from torchdraco.models import AttributeType
    from torchdraco.ops import _build

    t_phase = time.perf_counter()
    rec = {"card": smi_line}
    lib = _build.load()

    def counts():
        return (dict(tdev.predict_residual.n_launches_by_form),
                dict(tdev.predict_residual.n_launches_by_layout),
                dict(tdev.histogram.n_launches_by_form))

    def cfg_of(qp):
        return Config(quant_bits={AttributeType.POSITION: qp})

    # 17.1: the batch path at each depth, counted
    runs, path, batches = {}, {}, {}
    for B, n in REAL_BATCHES:
        pos, faces = torchdraco.make_mesh_batch(B, n, SEED)
        meshes = torchdraco.build_meshes(pos, faces)
        batches[n] = (pos, meshes)
        for qp in REAL_QP:
            enc = tbatch.BatchEncoder(cfg=cfg_of(qp))
            _, first_s = wall_s(lambda: enc.encode_meshes_device(meshes,
                                                                 bits=qp))
            first_t = dict(enc.timings)
            reset_launch_counts()
            got, secs = wall_s(lambda: enc.encode_meshes_device(meshes,
                                                                bits=qp))
            k1f, k1l, k2f = counts()
            layout = tbatch.upload_layout(qp)
            k2_form = tdev.histogram_form(tdev.default_hist_bins(qp))
            where = f"17.1 {n}^2 x {B} at -qp {qp}"
            _check(k1f == {"rows": 0, "tiled": 1, "gather": 0},
                   f"{where}: K1 launches by form {k1f}")
            _check(k1l == {k: int(k == layout) for k in k1l},
                   f"{where}: K1 launches by layout {k1l}")
            _check(k2f == {k: int(k == k2_form) for k in k2f}
                   and (qp < 15) == (k2_form == "smem"),
                   f"{where}: K2 launches by form {k2f}")
            path[(n, layout)] = k1f["tiled"]
            path[(n, f"k2_qp{qp}")] = k2f[k2_form]
            host, host_s = wall_s(lambda: tbatch.BatchEncoder(
                cfg=cfg_of(qp), use_device=False).encode_meshes(meshes))
            _check(got == host, f"{where}: blobs "
                   f"{[i for i, (a, b) in enumerate(zip(got, host)) if a != b]}"
                   f" differ from the host plane")
            ref, enc_s = wall_s(lambda: [encode(meshes[i], cfg=cfg_of(qp))
                                         for i in (0, B - 1)])
            _check([got[0], got[-1]] == ref, f"{where}: differs from "
                   f"encode()")
            runs[f"{n}x{B}_qp{qp}"] = {
                "layout": layout, "k2_form": k2_form, "mb_in": pos.nbytes / 1e6,
                "first_s": first_s, "first_timings": first_t, "s": secs,
                "timings": dict(enc.timings), "host_plane_s": host_s,
                "encode_s_per_mesh": enc_s / 2,
                "mb_s": pos.nbytes / 1e6 / secs,
                "host_plane_mb_s": pos.nbytes / 1e6 / host_s}
    B, n = REAL_BATCHES[-1]
    enc_t = tbatch.BatchEncoder(cfg=cfg_of(11))
    tr = rec["trace_qp11"] = {"grid": n, "meshes": B, **traced(
        lambda: enc_t.encode_meshes_device(batches[n][1], bits=11))}
    rec["runs"] = runs
    print("phase 17.1: encode_meshes_device at real sizes, every blob equal "
          "to the host plane and two a depth to encode(), K1 tiled once, K2 "
          "wide at -qp 15-16; s warm (first) / host plane: " + "; ".join(
              f"{k} {v['s']:.3f} ({v['first_s']:.3f}) / "
              f"{v['host_plane_s']:.3f}" for k, v in runs.items())
          + f"; the {n}^2 batch at -qp 11 traced: busy "
          f"{tr['busy_ms']:.2f} of {tr['wall_ms']:.1f} ms, idle share "
          f"{tr['idle_share']}")

    def upload(q_host, layout):
        if layout == "u8":
            return torch.from_numpy(q_host.astype(np.uint8)).to(dev)
        if layout == "pack12":
            return tuple(torch.from_numpy(a).to(dev)
                         for a in native.pack12(q_host))
        return torch.from_numpy(q_host).to(dev)

    # 17.2: the tiled K1 at both batch shapes, each layout
    entries = {}
    replaces = "tpudraco/ops/pallas_kernels.py:174 (past T*V > 256 MiB: " \
               "the XLA gather step, tpudraco/parallel/batch.py:1650)"
    for B, n in REAL_BATCHES:
        pos, meshes = batches[n]
        topo = tbatch.PreparedTopology(meshes[0])
        att = meshes[0].position_attribute()
        V = n * n
        g = tbatch._device_gathers(topo, att, dev, V)
        T = g["order"].numel()
        sweep = {t: tdev.predict_tiles(g, t) for t in TILE_SWEEP}
        tiles = sweep[tdev.PREDICT_TILE]
        local = tiles.local.cpu().numpy()
        for layout, qp in (("pack12", 11), ("u16", 14), ("u8", 8)):
            q_host, _, _, vmin, vmax = native.quantize_batch(pos, qp)
            lo = torch.from_numpy(vmin).to(dev)
            hi = torch.from_numpy(vmax).to(dev)
            up = upload(q_host, layout)
            parts = up if isinstance(up, tuple) else (up,)
            sym = tdev.predict_residual(up, g, lo, hi, tiles)
            sync()
            err = max_abs_err(sym, tdev.predict_residual_ref(up, g, lo, hi))
            out = torch.empty_like(sym)

            def gather_form():
                with tdev._launch_on(parts[0]) as stream:
                    rc = getattr(lib, tdev._K1_ENTRY[layout])(
                        *(t.data_ptr() for t in parts),
                        *(g[k].data_ptr() for k in tdev._GATHER_INDEX),
                        *(g[k].data_ptr() for k in tdev._GATHER_MASK),
                        lo.data_ptr(), hi.data_ptr(), out.data_ptr(), B, V,
                        T, 3, 0, stream)
                    _build.check(rc, "predict_gather_kernel")
            gather_form()
            sync()
            err = max(err, max_abs_err(out, sym))
            k1_runs = cuda_ms_batches(
                lambda: tdev.predict_residual(up, g, lo, hi, tiles))
            ops = 12 * sym.numel() + (6 * q_host.size if layout == "pack12"
                                      else 0)
            staged = 1 if layout == "u8" else 2
            name = "predict_residual_tiled" + {
                "pack12": "_p12", "u16": "", "u8": "_u8"}[layout] + \
                ("" if n == REAL_BATCHES[0][1] else f"_{n}")
            entries[name] = {
                "file": "predict_residual.cu", "replaces": replaces,
                "launched_on": f"phase 17.1, {n}^2 x {B} at -qp {qp}",
                "launches": path[(n, layout)], "form": "tiled",
                "layout": layout, "shape": [B, V, 3], "qp": qp,
                "max_abs_err": err, "ms": k1_runs["median"],
                "ms_runs": k1_runs,
                "plain_ms": cuda_ms(lambda: tdev.predict_residual_ref(
                    up, g, lo, hi), 5),
                "kernel_only_ms": kernel_only_ms(
                    lambda: tdev.predict_residual(up, g, lo, hi, tiles),
                    "predict_tiled_kernel", reps=10),
                "gather_kernel_only_ms": kernel_only_ms(
                    gather_form, "predict_gather_kernel", reps=10),
                "tile_sweep_kernel_only_ms": {
                    t: kernel_only_ms(lambda: tdev.predict_residual(
                        up, g, lo, hi, sweep[t]), "predict_tiled_kernel",
                        reps=10) for t in TILE_SWEEP},
                "bank_replays": _bank_replays(local, staged),
                "library_ms": None,
                "tables": {"tile": tiles.tile, "max_verts": tiles.max_verts,
                           "verts_per_step": tiles.verts.numel() / T,
                           "bytes": tiles.nbytes},
                **bound(nbytes(*parts, lo, hi, sym, tiles.verts, tiles.off,
                               tiles.local), ops)}
            del up, parts, sym, out
        del sweep, tiles, g

    # the tiled kernel at the batch's own shape, where the rows kernel runs
    B, V, _ = positions64.shape
    T = gathers64["order"].numel()
    tiles = tdev.predict_tiles(gathers64)
    at_rows = rec["tiled_at_the_rows_shape"] = {
        "shape": [B, V, 3], "tile": tiles.tile}
    for layout, qp in (("pack12", 11), ("u16", 14), ("u8", 8)):
        q_host, _, _, vmin, vmax = native.quantize_batch(positions64, qp)
        lo = torch.from_numpy(vmin).to(dev)
        hi = torch.from_numpy(vmax).to(dev)
        up = upload(q_host, layout)
        parts = up if isinstance(up, tuple) else (up,)
        _check(tdev.predict_form(V, 3, tdev.STAGED_ITEMSIZE[layout])
               == "rows", f"17.2: the {layout} batch leaves the rows kernel")
        sym = tdev.predict_residual(up, gathers64, lo, hi)
        out = torch.empty_like(sym)

        def tiled_form():
            with tdev._launch_on(parts[0]) as stream:
                rc = getattr(lib, tdev._K1_TILED_ENTRY[layout])(
                    *(t.data_ptr() for t in parts), tiles.verts.data_ptr(),
                    tiles.off.data_ptr(), tiles.local.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), out.data_ptr(), B, V, T,
                    3, tiles.tile, tiles.off.numel() - 1, tiles.max_verts,
                    stream)
                _build.check(rc, "predict_tiled_kernel")
        tiled_form()
        sync()
        _check(torch.equal(out, sym), f"17.2: the tiled kernel differs "
               f"from the rows kernel at the {layout} batch")
        at_rows[layout] = {
            "rows_kernel_only_ms": kernel_only_ms(
                lambda: tdev.predict_residual(up, gathers64, lo, hi),
                "predict_rows_kernel", reps=10),
            "tiled_kernel_only_ms": kernel_only_ms(
                tiled_form, "predict_tiled_kernel", reps=10)}
    del tiles, up, parts, sym, out
    print("phase 17.2: the tiled K1 equals its plain version and the "
          "direct gather in each layout; ms (alone; direct gather alone; "
          "tiles " + "/".join(map(str, TILE_SWEEP)) + " alone), bound: "
          + "; ".join(
              f"{k} {e['ms']:.4f} ({e['kernel_only_ms']:.4f}; "
              f"{e['gather_kernel_only_ms']:.4f}; "
              + "/".join(f"{v:.4f}" for v in
                         e["tile_sweep_kernel_only_ms"].values())
              + f"), {e['bound_ms']:.4f}, bank replays "
              f"{e['bank_replays']:.2f}" for k, e in entries.items())
          + f"; at the batch's {at_rows['shape']}, alone, rows kernel / "
          f"tiled kernel: " + ", ".join(
              f"{k} {v['rows_kernel_only_ms']:.4f} / "
              f"{v['tiled_kernel_only_ms']:.4f}"
              for k, v in at_rows.items() if isinstance(v, dict)))

    # 17.3: K2's wide form on the path's symbols
    q15, _, _, vmin15, vmax15 = native.quantize_batch(positions64, 15)
    sym64 = tdev.predict_residual(
        torch.from_numpy(q15).to(dev), gathers64,
        torch.from_numpy(vmin15).to(dev),
        torch.from_numpy(vmax15).to(dev)).view(len(positions64), -1)
    pos256, meshes256 = batches[REAL_BATCHES[0][1]]
    topo = tbatch.PreparedTopology(meshes256[0])
    g = tbatch._device_gathers(topo, meshes256[0].position_attribute(), dev,
                               pos256.shape[1])
    cases = [("histogram_wide", sym64, 15, "phase 17.4, 64^2 x "
              f"{len(positions64)} at -qp 15", None)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for qp in (15, 16):
        q, _, _, lo_, hi_ = native.quantize_batch(pos256, qp)
        s = tdev.predict_residual(
            torch.from_numpy(q).to(dev), g, torch.from_numpy(lo_).to(dev),
            torch.from_numpy(hi_).to(dev)).view(len(pos256), -1)
        cases.append((f"histogram_wide_{s.shape[1]}_qp{qp}", s, qp,
                      f"phase 17.1, {REAL_BATCHES[0][1]}^2 x "
                      f"{REAL_BATCHES[0][0]} at -qp {qp}",
                      path[(REAL_BATCHES[0][1], f"k2_qp{qp}")]))
    rng = np.random.default_rng(SEED + 17)
    uniform = torch.from_numpy(rng.integers(
        -9, (1 << 17) + 9, size=cases[-1][1].shape, dtype=np.int32)).to(dev)
    def k2_entry(sym, bins):
        keep = (sym >= 0) & (sym < bins)
        flat = (sym.to(torch.int64) + torch.arange(
            sym.shape[0], device=dev)[:, None] * bins)[keep]

        def lib_call():
            return torch.bincount(flat, minlength=sym.shape[0] * bins)
        got = tdev.histogram(sym, bins)
        sync()
        _check(torch.equal(lib_call().view(sym.shape[0], bins),
                           got.to(torch.int64)),
               "torch.bincount disagrees with histogram_smem_kernel")
        runs_ = cuda_ms_batches(lambda: tdev.histogram(sym, bins))
        e = dict(max_abs_err=max_abs_err(got, tdev.bincount_kernel(sym, bins)),
                 ms=runs_["median"], ms_runs=runs_,
                 kernel_only_ms=kernel_only_ms(
                     lambda: tdev.histogram(sym, bins),
                     "histogram_smem_kernel", reps=10))
        e.update(plain_ms=cuda_ms(lambda: tdev.bincount_kernel(sym, bins), 5),
                 library_ms=cuda_ms(lib_call, 10),
                 splits=tdev.histogram_splits(*sym.shape, bins, sms),
                 **bound(nbytes(sym) + 4 * sym.shape[0] * bins,
                         2 * sym.numel()))
        return e

    # 17.4 first: its counted run gives the (512, 12288) entry's launches
    enc15 = tbatch.BatchEncoder(cfg=cfg_of(15))
    enc15.encode_meshes_device(meshes64, bits=15)
    reset_launch_counts()
    got15, s15 = wall_s(lambda: enc15.encode_meshes_device(meshes64,
                                                           bits=15))
    wide_launches = counts()[2]["wide"]
    _check(wide_launches == 1, f"17.4: K2's wide form launched "
           f"{wide_launches} times at -qp 15")
    stages = {"encode_meshes_device_s": s15, "timings": dict(enc15.timings)}
    batch15 = np.stack([m.position_attribute().values.astype(np.float32)
                        for m in meshes64])
    topo64 = enc15._topo_cache[next(iter(enc15._topo_cache))]
    att64 = meshes64[0].position_attribute()
    (q_np, _, _, vmin, vmax), stages["host_quantize_s"] = wall_s(
        lambda: tbatch._host_quantize(batch15, 15))
    (q_up, _), stages["upload_s"] = wall_s(
        lambda: tbatch._upload(q_np, 15, [dev]))
    g64 = tbatch._device_gathers(topo64, att64, dev, batch15.shape[1])
    lo64 = torch.from_numpy(np.asarray(vmin, np.int32)).to(dev)
    hi64 = torch.from_numpy(np.asarray(vmax, np.int32)).to(dev)
    (sym15, cnt15), stages["fused_step_s"] = wall_s(
        lambda: tdev.encode_step_from_q_cuda(q_up[0], g64, lo64, hi64,
                                             bits=15))
    _, stages["entropy_s"] = wall_s(
        lambda: trl.encode_group_entropy_device(sym15, cnt15))
    prof = cProfile.Profile()
    prof.enable()
    enc15.encode_meshes_device(meshes64, bits=15)
    sync()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(12)
    top = [ln.strip() for ln in text.getvalue().splitlines()
           if ln.strip()[:1].isdigit()][:12]
    stages["host_profile_top_tottime"] = top
    stages["trace"] = traced(lambda: enc15.encode_meshes_device(
        meshes64, bits=15))
    rec["qp15_position_split"] = stages
    print(f"phase 17.4: -qp 15, {len(meshes64)} meshes of 64^2: "
          f"encode_meshes_device {s15:.3f} s, position_s "
          f"{stages['timings']['position_s']:.3f}: host quantize "
          f"{stages['host_quantize_s']:.4f}, upload "
          f"{stages['upload_s']:.4f}, fused step "
          f"{stages['fused_step_s']:.4f}, entropy stage "
          f"{stages['entropy_s']:.4f} s; device busy "
          f"{stages['trace']['busy_ms']:.2f} of "
          f"{stages['trace']['wall_ms']:.1f} ms (idle share "
          f"{stages['trace']['idle_share']}); host profile, most time "
          f"first: " + " | ".join(top[:6]))

    k2 = {}
    for name, sym, qp, where, launches in cases:
        bins = tdev.default_hist_bins(qp)
        k2[name] = {"file": "histogram.cu",
                    "replaces": "tpudraco/ops/pallas_kernels.py:71",
                    "launched_on": where, "form": "wide",
                    "launches": wide_launches if launches is None
                    else launches,
                    "shape": list(sym.shape), "bins": bins,
                    **k2_entry(sym, bins)}
    # uniform symbols, on no path: where the forms differ most
    rec["k2_uniform"] = {"shape": list(uniform.shape), "bins": 1 << 17,
                         **k2_entry(uniform, 1 << 17)}
    entries.update(k2)
    print("phase 17.3: K2's wide form equals its plain version; ms "
          "(alone), torch.bincount ms, bound: " + "; ".join(
              f"{k} {e['shape']} x {e['bins']} {e['ms']:.4f} "
              f"({e['kernel_only_ms']:.4f}), {e['library_ms']:.4f}, "
              f"{e['bound_ms']:.4f}" for k, e in (
                  *k2.items(), ("uniform", rec["k2_uniform"]))))
    for e in entries.values():
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17: {rec['phase_s']:.1f} s")
    return rec, entries


def _phase16(torch, dev, wall_s) -> list:
    """The bench: ``python -m torchdraco.bench`` in a process of its own at
    BENCH_BATCH meshes, once for each of BENCH_METRICS and once with
    ``--breakdown``, each to exit 0 with one line; then
    ``bench.bench_huge`` on a BENCH_HUGE_N grid in this process (phase 12
    runs the 1024 x 1024 one). Every line must name its metric, a
    positive value, this card and the card's idle share of its traced
    call, and the lines together must launch K1, K2, K3 and D1. Returns
    the lines."""
    from torchdraco import bench

    t0 = time.perf_counter()
    env = dict(os.environ, TORCHDRACO_BENCH_BATCH=str(BENCH_BATCH))
    lines, walls = [], {}
    for args in ([["--metric", m] for m in BENCH_METRICS]
                 + [["--breakdown"]]):
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torchdraco.bench", *args], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        walls[" ".join(args)] = time.perf_counter() - t1
        _check(proc.returncode == 0, f"16: torchdraco.bench {' '.join(args)}"
               f" exited {proc.returncode}: {proc.stderr[-2000:]}")
        got = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
        _check(len(got) == 1, f"16: torchdraco.bench {' '.join(args)} "
               f"printed {len(got)} lines: {proc.stdout[-2000:]}")
        lines += got
    huge, walls[f"bench_huge(n={BENCH_HUGE_N})"] = wall_s(
        lambda: bench.bench_huge(dev, n=BENCH_HUGE_N))
    lines.append(huge)
    card = torch.cuda.get_device_name(0)
    for line in lines:
        _check(line.get("metric") and line.get("value", 0) > 0
               and not line.get("rehearsal")
               and line["device"].get("name") == card
               and line["device"].get("power_limit_w")
               and line.get("device_idle_share") is not None,
               f"16: a bench line lacks its metric, value, card or idle "
               f"share: {line}")
    launched = {k: sum(line["launches"][k] for line in lines)
                for k in lines[0]["launches"]}
    _check(all(launched[k] > 0 for k in (
        "predict_residual", "histogram", "rans_words_scan",
        "rans_decode_lanes")), f"16: the bench never launched a kernel of "
        f"its paths: {launched}")
    print(f"phase 16: torchdraco.bench at {BENCH_BATCH} meshes, "
          + ", ".join(f"{line['metric']} {line['value']} {line['unit']} "
                      f"(idle {line['device_idle_share']:.4f})"
                      for line in lines)
          + f"; launches {launched}; walls "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; {time.perf_counter() - t0:.1f} s")
    return lines


def _host_rans_encode(coder, dist, lane) -> bytes:
    enc = coder(dist, precision=LANE_P)
    enc.write_all(lane)
    return enc.flush()


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of torchdraco on one NVIDIA GPU: builds the CUDA kernels from
this checkout, holds each against its plain PyTorch twin, drives the main
path (BatchEncoder.encode_meshes_device) over 512 grid meshes of 64 x 64
vertices, checks every .drc against the host encoder, and times the stages.

    python3 chip_smoke.py

Exits nonzero on any failure, and without a usable CUDA device. The last
line of standard output is {"ok": true, "device": {...}}; the line before
it lists every kernel with its launches on the main path, its error
against its twin and both times. The full report (ptxas resources, every
timing run, the device trace summary) goes to standard error as one
JSON line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, GRID, SEED, BITS = 512, 64, 1, 11
K3_LANES, K3_T = 512, 2048


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
    from torchdraco import _host
    from torchdraco.ops import _build, reset_launch_counts
    from torchdraco.ops import device as tdev
    from torchdraco.ops import rans_lanes as trl
    from torchdraco.parallel import batch as tbatch

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

    # ---- phase 1: the card, the stack, the kernel build -----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
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
    q_up, _, _, vmin, vmax = _host.native.quantize_batch(positions, BITS)
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
    k3_dist, _ = _host.normalize_freq_counts_batch(k3_counts, k3_prec)
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
          f"({BATCH}, {q_dev.shape[1]}, 3); K2 at {bins} bins (shared) and "
          f"{wide} (global) + drop case; K3 at L={K3_LANES}, T={K3_T}, "
          f"precisions {k3_prec.min()}-{k3_prec.max()}, ragged lengths")

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
    report["patho_lanes"] = n_patho
    _check(all(n > 0 for n in launches.values()),
           f"a kernel of the main path never launched: {launches}")
    host_blobs = [tbatch.encode_with_topology(m, topo) for m in meshes]
    _check(len(blobs) == BATCH and all(isinstance(b, bytes) and len(b) > 0
                                       for b in blobs), "missing blobs")
    bad = [i for i, (a, b) in enumerate(zip(blobs, host_blobs)) if a != b]
    _check(not bad, f"{len(bad)} blobs differ from the host plane "
           f"(first {bad[:5]})")
    sample = list(range(0, BATCH, BATCH // 32))
    bad = [i for i in sample if blobs[i] != _host.encode(meshes[i])]
    _check(not bad, f"blobs differ from tpudraco.encode.encode: {bad[:5]}")
    out_bytes = sum(len(b) for b in blobs)
    print(f"phase 3: {BATCH} meshes of {GRID}x{GRID} ({mb_in:.1f} MB f32 "
          f"positions) -> {out_bytes} B of .drc; all equal the host plane, "
          f"{len(sample)} sampled equal tpudraco.encode.encode; launches "
          f"{launches}; pathological lanes {n_patho}")

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
    quant_s = wall_s(lambda: _host.native.quantize_batch(positions,
                                                         BITS))[1]
    dev_c, step_s = wall_s(lambda: tbatch.device_encode_group(
        positions, topo, pos_att, bits=BITS, device=dev))
    _, ent_s = wall_s(lambda: trl.encode_group_entropy_device(
        dev_c["symbols"], dev_c["counts"]))
    t["breakdown_s"] = {
        "topology_signatures": sig_s, "host_quantize": quant_s,
        "quantize_upload_step": step_s, "entropy": ent_s,
        "assembly_and_rest": min(dev_runs) - sig_s - step_s - ent_s}
    # kernels against their twins at the main path's shapes
    k = {}
    k["predict_residual"] = (
        cuda_ms(lambda: tdev.predict_residual(q_dev, gathers, vmin_dev,
                                              vmax_dev), 50),
        cuda_ms(lambda: tdev.predict_residual_ref(q_dev, gathers, vmin_dev,
                                                  vmax_dev), 10))
    flat = syms_dev.view(BATCH, -1)
    k["histogram"] = (cuda_ms(lambda: tdev.histogram(flat, bins), 50),
                      cuda_ms(lambda: tdev.bincount_kernel(flat, bins), 10))
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
    t["kernel_ms"] = k
    report["times"] = t
    print(f"phase 4: fused step on resident data {t['step_ms']:.3f} ms; "
          f"entropy stage {min(ent) * 1e3:.1f} ms; e2e "
          f"{t['e2e_mb_s']:.1f} MB/s (runs {[round(x, 3) for x in dev_runs]}"
          f" s) vs host plane {t['host_plane_mb_s']:.1f} MB/s (runs "
          f"{[round(x, 3) for x in host_runs]} s); breakdown "
          f"{ {a: round(b, 4) for a, b in t['breakdown_s'].items()} }; "
          f"kernel/twin ms { {a: (round(b, 4), round(c, 4)) for a, (b, c) in k.items()} }")

    # ---- phase 5: device trace of one warm e2e run ----------------------
    from torch.profiler import ProfilerActivity, profile

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
    busy_us, edge = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of device intervals
        if b > edge:
            busy_us += b - max(a, edge)
            edge = b
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

    src = "torchdraco/ops/csrc/"
    table = [
        ("predict_residual", "predict_residual.cu",
         "tpudraco/ops/pallas_kernels.py:174"),
        ("histogram", "histogram.cu", "tpudraco/ops/pallas_kernels.py:71"),
        ("rans_words_scan", "rans_words.cu",
         "tpudraco/ops/pallas_kernels.py:399"),
    ]
    kernels = [{"name": name, "route": "cuda", "source": src + f,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": k[name][0],
                "plain_ms": k[name][1]} for name, f, rep in table]
    print("chip_smoke details: " + json.dumps({**report, "kernels": kernels}),
          file=sys.stderr)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

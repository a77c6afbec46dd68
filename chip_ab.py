#!/usr/bin/env python3
"""Times torchdraco's kernels K1 (predict_residual), K2 (histogram), K3
(rans_words_scan), K4 (rans_scan_dense) and D1 (rans_decode_lanes) of two
checkouts in turns on one NVIDIA GPU.

    python3 chip_ab.py --turns PARENT_DIR CHANGE_DIR

runs PARENT, CHANGE, CHANGE, PARENT, each in a process of its own (a
checkout builds its own kernels), and prints one JSON line per run and a
summary line. ``python3 chip_ab.py --tree DIR`` is one such run. Unpack the
parent with ``git archive <commit> | tar -x -C _checkout``.

Inputs are 512 grid meshes of 64 x 64 vertices and the fused step's symbols
of them (512 lanes x 12,288 symbols): K1 and K2 as the encode path calls
them, K3 on the encode path's own per-lane tables and precisions, K3, K4
and D1 on per-lane tables at precision 12 (K4 on the pre-gathered int32
(freq, cum) of those lanes), and D1 on per-lane tables at precision 20, the
group decode's call. Each kernel's outputs are checked (D1 must give every
lane back; the two checkouts' outputs of K1, K2, K3 and K4 are compared
through checksums). Times are CUDA-event means over ``REPS`` launches after
a warm-up launch; K1 and K2, which take tens of microseconds, are medians
of ``BATCHES`` means of ``SHORT_REPS`` launches.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

BATCH, GRID, SEED, BITS, REPS = 512, 64, 1, 11, 10
BATCHES, SHORT_REPS = 7, 50


def run_tree(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import torchdraco
    from torchdraco.ops import device as tdev
    from torchdraco.ops import rans_lanes as trl
    from torchdraco.parallel import batch as tbatch
    from torchdraco import native
    from torchdraco.entropy.rans import normalize_freq_counts

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab needs an NVIDIA GPU")
    dev = torch.device("cuda")

    def cuda_ms(fn, reps: int = REPS) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def median_ms(fn) -> float:
        return sorted(cuda_ms(fn, SHORT_REPS)
                      for _ in range(BATCHES))[BATCHES // 2]

    def sha(*tensors) -> str:
        return hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in tensors)).hexdigest()[:16]

    positions, faces = torchdraco.make_mesh_batch(BATCH, GRID, SEED)
    mesh0 = torchdraco.build_meshes(positions[:1], faces)[0]
    topo = tbatch.PreparedTopology(mesh0)
    gathers = tbatch.gathers_to_torch(
        tbatch.topology_gathers_np(topo, mesh0.position_attribute()), dev)
    q_up, _, _, vmin, vmax = native.quantize_batch(positions, BITS)
    q_dev, vmin_dev, vmax_dev = (torch.from_numpy(a).to(dev)
                                 for a in (q_up, vmin, vmax))
    syms, counts = tdev.encode_step_from_q_cuda(q_dev, gathers, vmin_dev,
                                                vmax_dev, bits=BITS)
    flat = syms.view(BATCH, -1)
    n = flat.shape[1]
    full = torch.full((BATCH,), n, dtype=torch.int32, device=dev)
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}

    # K1 and K2 as the fused step calls them
    bins = tdev.default_hist_bins(BITS)
    out["k1_ms"] = median_ms(lambda: tdev.predict_residual(
        q_dev, gathers, vmin_dev, vmax_dev))
    out["k1_sha"] = sha(syms)
    out["k2_ms"] = median_ms(lambda: tdev.histogram(flat, bins))
    out["k2_sha"] = sha(counts)

    # K3 as the encode path calls it
    dist, cums, prec, _ = trl.normalize_tables(counts, n)
    out["k3_encode_prec"] = [int(prec.min()), int(prec.max())]
    out["k3_encode_ms"] = cuda_ms(lambda: trl.rans_words_scan(
        flat, dist, cums, prec, full))
    words, meta = trl.rans_words_scan(flat, dist, cums, prec, full)
    out["k3_encode_sha"] = sha(words, meta)

    flat_np = flat.cpu().numpy()
    cnt_np = counts.cpu().numpy()
    lanes_dev = torch.from_numpy(
        np.ascontiguousarray(flat_np[:, ::-1]).astype(np.int32)).to(dev)
    for p in (12, 20):
        dists = [normalize_freq_counts(c[:np.flatnonzero(c)[-1] + 1], p)
                 for c in cnt_np]
        S = 16
        while S < max(len(d) for d in dists):
            S *= 2
        freqs = np.zeros((BATCH, S), np.int32)
        for i, d in enumerate(dists):
            freqs[i, :len(d)] = d
        cums_np = np.cumsum(freqs, axis=1, dtype=np.int32) - freqs
        f, c = torch.from_numpy(freqs).to(dev), torch.from_numpy(cums_np) \
            .to(dev)
        prec_p = torch.full((BATCH,), p, dtype=torch.int32, device=dev)
        flipped = lanes_dev.flip(1)
        if p == 12:  # K4 on the dense engine's pre-gathered lanes
            idx = lanes_dev.to(torch.int64)
            fs, cs = f.gather(1, idx), c.gather(1, idx)
            out["k4_p12_ms"] = cuda_ms(lambda: trl.rans_scan_dense(
                fs, cs, full, p))
            out["k4_p12_sha"] = sha(*trl.rans_scan_dense(fs, cs, full, p))
            del idx, fs, cs
        out[f"k3_p{p}_ms"] = cuda_ms(lambda: trl.rans_words_scan(
            flipped, f, c, prec_p, full))
        bufs, nbytes = trl.rans_encode_lanes(lanes_dev, f, c, full,
                                             precision=p)
        out[f"lanes_p{p}_sha"] = hashlib.sha256(
            b"".join(bufs[i, :nbytes[i]].tobytes() for i in range(BATCH))
        ).hexdigest()[:16]
        args = [torch.from_numpy(bufs).to(dev),
                torch.from_numpy(nbytes).to(dev), f, full]
        got = trl.rans_decode_lanes(*args, precision=p)
        torch.cuda.synchronize()
        if not np.array_equal(got.cpu().numpy().astype(np.int64), flat_np):
            raise SystemExit(f"{tree}: D1 at P={p} did not give the lanes "
                             "back")
        out[f"d1_p{p}_ms"] = cuda_ms(lambda: trl.rans_decode_lanes(
            *args, precision=p))
        out[f"d1_p{p}_alphabet"] = S
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="time one checkout, in this process")
    ap.add_argument("--turns", nargs=2, metavar=("PARENT", "CHANGE"),
                    help="time PARENT, CHANGE, CHANGE, PARENT")
    a = ap.parse_args()
    if a.tree:
        print(json.dumps(run_tree(a.tree)))
        return 0
    if not a.turns:
        ap.error("give --tree or --turns")
    parent, change = a.turns
    runs = []
    for tree in (parent, change, change, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    same = all(runs[0][k] == r[k] for r in runs
               for k in runs[0] if k.endswith("_sha"))
    keys = [k for k in runs[0] if k.endswith("_ms")]
    print(json.dumps({
        "card": smi.stdout.strip(), "identical_outputs": same,
        "parent_ms": {k: [runs[0][k], runs[3][k]] for k in keys},
        "change_ms": {k: [runs[1][k], runs[2][k]] for k in keys}}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

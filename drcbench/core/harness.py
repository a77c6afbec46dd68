"""One run of one cell of ``BENCHMARK.json``: set-up (inputs from the
seed, the entry, one warm request of a distinct input), a closed loop of
requests for ``--seconds`` (traced with ``--trace 1``), then the reference's
check of every output of the window, and one JSON line of results. Beside
each request it keeps the wall, process CPU and garbage-collector seconds,
which it prints on standard error.

A request holds frames of one or more takes (``request_takes``), each
take with its own topology and size (``inputs.Takes``); the entry gets
them as a list of ``(faces, [frame attributes ...])``, one a take, and
every reading follows the take of each frame.

The cell names its configuration and traffic mix; the mix names its entry.
Each is found by name: ``configs/`` (the configuration's ``file``),
``workloads/<traffic>.json``, ``entries/<entry>.py`` and
``metrics/<metric>.py``, so a cell, configuration or metric is added as
new files only."""

from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import inputs, trace
from ..reference import pool

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpudraco")


class SpecError(Exception):
    pass


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_module(root: Path, folder: str, name: str):
    path = root / "drcbench" / folder / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"{path.relative_to(root)} is missing")
    modname = f"drcbench.{folder}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    the cell; a per-layer metric without the key goes where the
    end-to-end metric it moves (``reported``) goes."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in (reported or set())
    return True


class Cell:
    """A cell with everything it names, read from ``root``."""

    def __init__(self, root: Path, name: str) -> None:
        self.root = root
        self.spec = load_spec(root)
        self.cell = _by_name(self.spec["workloads"], name, "workload")
        cfg = _by_name(self.spec["configs"], self.cell["config"],
                       "config")
        with open(root / cfg["file"]) as f:
            self.config = json.load(f)
        tpath = root / "drcbench" / "workloads" / f"{self.cell['traffic']}.json"
        if not tpath.is_file():
            raise SpecError(f"{tpath.relative_to(root)} is missing")
        with open(tpath) as f:
            self.traffic = json.load(f)
        self.entry = _load_module(root, "entries", self.traffic["entry"])
        self.end_to_end = [m for m in self.spec["end_to_end"]
                           if applies(m, name)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.spec["per_layer"]
                          if applies(m, name, e2e)]
        self.readers = {m["name"]: _load_module(root, "metrics", m["name"])
                        for m in self.end_to_end + self.per_layer}


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell: Cell, seed: int, seconds: float) -> None:
        self.cell = cell
        self.name = cell.cell["name"]
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.setup_s = None
        self.window_s = None
        self.requests: list[dict] = []
        self.takes = inputs.Takes(cell.config, seed)
        first = self.takes[0]         # take 0's sizes, for one-take readers
        self.frame_bytes = first.frame_bytes
        self.vertices = first.vertices
        self.faces = first.num_faces
        self.streams: list = []       # per distinct request, per frame
        self.device_events = None     # the traced window's, or None
        self.spans: list = []

    def completed_bytes(self) -> int:
        """Raw bytes of every frame of every request in the window, each
        frame its own take's."""
        return sum(self.takes[t].frame_bytes for r in self.requests
                   for t, _ in r["frames"])

    def frames_by_take(self, request: dict) -> list:
        """(take, frames of it) of a request in the window, in the order
        its takes first come."""
        n = collections.Counter(t for t, _ in request["frames"])
        return [(self.takes[t], k) for t, k in n.items()]

    def mean_timing_ms(self, key: str):
        vals = [r["timings"][key] for r in self.requests
                if key in r["timings"]]
        return 1e3 * float(np.mean(vals)) if vals else None

    def kernel_seconds(self, names):
        """(device seconds, launches) of the named kernels in the traced
        window, or None untraced or where none ran."""
        if self.device_events is None:
            return None
        s, n = trace.kernel_seconds(self.device_events, names)
        return (s, n) if n else None

    def window_streams(self, attribute: int) -> list:
        """The stream stats of one attribute of every frame of every
        request in the window."""
        return [frame[attribute] for r in self.requests
                for frame in self.streams[r["distinct"]]]


def request_takes(traffic: dict, r: int) -> list[tuple[int, list[int]]]:
    """(take, frame indices) of request ``r``. Without the traffic's
    ``takes_per_request``, frames ``r n ... (r + 1) n - 1`` of take 0 (n:
    ``frames_per_request``); with it (k, which divides n), takes
    ``r k ... r k + k - 1``, frames ``0 ... n / k - 1`` of each."""
    n = int(traffic["frames_per_request"])
    if "takes_per_request" not in traffic:
        return [(0, list(range(r * n, (r + 1) * n)))]
    k = int(traffic["takes_per_request"])
    if k < 1 or n % k:
        raise SpecError(f"takes_per_request {k} does not divide "
                        f"frames_per_request {n}")
    return [(t, list(range(n // k))) for t in range(r * k, (r + 1) * k)]


def request_frames(traffic: dict, r: int) -> list[tuple[int, int]]:
    """The (take, frame) pairs of request ``r``, in the entry's order."""
    return [(t, f) for t, fs in request_takes(traffic, r) for f in fs]


def _parse(argv):
    p = argparse.ArgumentParser(prog="drcbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def compare_encode(run: Run, outputs: list, expected: list) -> dict:
    wrong = failed = checked = 0
    for rec, out in zip(run.requests, outputs):
        exp = expected[rec["distinct"]]
        out = list(out) + [None] * (len(exp) - len(out))
        failed += any(o is None for o in out)
        wrong += sum(1 for o, e in zip(out, exp) if o != e)
        wrong += max(0, len(out) - len(exp))
        checked += len(exp)
    return {"failed": failed,
            "compared": {"blobs_wrong": {"value": wrong, "limit": 0}},
            "checked": checked}


class GcClock:
    """Seconds in Python's garbage collector, and its full collections,
    while registered in ``gc.callbacks``."""

    def __init__(self) -> None:
        self.seconds, self.full, self._t = 0.0, 0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t
            self.full += info["generation"] == 2


def main(argv=None, t0: float | None = None, device: str = "cuda",
         require_cuda: bool = True, root: Path = ROOT,
         workers: int | None = None, entry_wrapper=None,
         max_requests: int | None = None) -> int:
    """Runs one cell and prints its result line; returns the exit code.
    ``device``, ``require_cuda``, ``workers`` and ``entry_wrapper`` (which
    wraps the entry, as the tests' faults and the control do) are for the
    CPU tests and the control; ``max_requests`` closes the window early
    (the control, whose answers take no time)."""
    t0 = time.perf_counter() if t0 is None else t0
    args = _parse(argv)
    cell = Cell(root, args.workload)
    chips = int(cell.cell["chips"])
    torch = None
    if require_cuda:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < chips:
            print(f"drcbench: {args.workload} needs {chips} CUDA "
                  f"device(s); this machine has {n}", file=sys.stderr)
            return 2
    workers = pool.default_workers() if workers is None else workers
    run = Run(cell, args.seed, args.seconds)
    traffic = cell.traffic
    n_distinct = int(traffic["distinct_requests"])
    warm_ids = [n_distinct + w for w in range(int(traffic["warm_requests"]))]

    entry = cell.entry.Entry(cell.config, traffic, device)
    if entry_wrapper is not None:
        entry = entry_wrapper(entry)

    def make(r: int):
        return entry.prepare([
            (run.takes[t].faces, [run.takes[t].frame(f) for f in frames])
            for t, frames in request_takes(traffic, r)])

    requests = [make(r) for r in range(n_distinct)]
    for r in warm_ids:
        entry.run(make(r))
    if torch is not None:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t0

    outputs: list = []
    label = traffic["entry"]
    gc.collect()  # set-up's garbage, collected before the window opens
    gc_clock = GcClock()

    def loop():
        start = time.perf_counter()
        i = 0
        while True:
            r = i % n_distinct
            ts, cpu = time.perf_counter(), time.process_time()
            gc_s = gc_clock.seconds
            if args.trace:
                from torch.profiler import record_function
                with record_function(f"{trace.SPAN_PREFIX}request {i} "
                                     f"{label}"):
                    out = entry.run(requests[r])
            else:
                out = entry.run(requests[r])
            te = time.perf_counter()
            outputs.append(out)
            run.requests.append({"index": i, "distinct": r,
                                 "frames": request_frames(traffic, r),
                                 "start": ts - start, "end": te - start,
                                 "cpu": time.process_time() - cpu,
                                 "gc": gc_clock.seconds - gc_s,
                                 "timings": entry.timings()})
            i += 1
            if te - start >= args.seconds or i == max_requests:
                return te - start

    gc.callbacks.append(gc_clock)
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch is not None:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            run.window_s = loop()
        gc.callbacks.remove(gc_clock)
        events = trace.export_events(prof)
        run.device_events = trace.device_events(events)
        run.spans = trace.spans(events)
    else:
        run.window_s = loop()
        gc.callbacks.remove(gc_clock)

    memory_peak = (int(torch.cuda.max_memory_allocated())
                   if torch is not None else 0)
    kind = (torch.cuda.get_device_name(0) if torch is not None
            else "cpu")
    del entry, requests
    gc.collect()
    if torch is not None:
        torch.cuda.empty_cache()

    # the reference, once the window has closed
    frame_ids = [f for r in range(n_distinct)
                 for f in request_frames(traffic, r)]
    per = int(traffic["frames_per_request"])
    blobs, stats = pool.encode(cell.config, args.seed, frame_ids, workers)
    expected = [blobs[r * per:(r + 1) * per] for r in range(n_distinct)]
    run.streams = [stats[r * per:(r + 1) * per] for r in range(n_distinct)]
    verdict = compare_encode(run, outputs, expected)
    del outputs, expected

    compared = verdict["compared"]
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = cell.readers[m["name"]].value(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch is not None else "cpu",
           "kind": kind, "count": chips, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(run.requests),
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev}
    if args.trace and run.device_events is not None:
        lo = run.spans[0][0] if run.spans else 0.0
        hi = max(s[1] for s in run.spans) if run.spans else 0.0
        dev["busy_s"] = trace.union_us(
            trace.clipped(run.device_events, lo, hi)) * 1e-6
        dev["window_s"] = run.window_s
        result["breakdown"] = {
            "device_ops": trace.top_operations(run.device_events),
            "idle_gaps": trace.idle_gaps(run.device_events, run.spans)}
    result["compared"] = compared

    found = _forbidden_modules()
    if found:
        print(f"drcbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    head = f"drcbench: {args.workload} seed {args.seed}:"
    for what, key in (("seconds", None), ("process CPU seconds", "cpu"),
                      ("GC seconds", "gc")):
        print(f"{head} request {what} "
              + " ".join(f"{r[key] if key else r['end'] - r['start']:.4f}"
                         for r in run.requests), file=sys.stderr)
    print(f"{head} {gc_clock.full} full collections in the window",
          file=sys.stderr)
    print(f"{head} {verdict['checked']} outputs of {len(run.requests)} requests "
          f"checked against the reference", file=sys.stderr)
    for k, v in compared.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0

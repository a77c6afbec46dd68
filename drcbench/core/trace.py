"""The traced window's Chrome trace, reduced: device events (kernels,
copies, fills), their union (busy time), time by operation name, and the
idle gaps between them, each labelled by the benchmark's own span (the
request and its entry) that it fell in."""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "drcbench "  # the record_function names of the requests
TOP = 10


def export_events(prof) -> list[dict]:
    """The complete ('X') events of a finished ``torch.profiler`` run. The
    Chrome trace is written under TMPDIR and deleted once read."""
    fd, path = tempfile.mkstemp(prefix="drcbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"]


def device_events(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


def spans(events: list[dict]) -> list[tuple[float, float, str]]:
    """The benchmark's request spans (start us, end us, label), from its
    ``record_function`` annotations on the host's timeline."""
    out = []
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(SPAN_PREFIX):
            out.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        name[len(SPAN_PREFIX):]))
    return sorted(out)


def union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, edge = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    return busy


def clipped(dev: list[dict], lo: float, hi: float) -> list[tuple]:
    """Device intervals clipped to [lo, hi] us."""
    out = []
    for e in dev:
        a = float(e["ts"])
        b = a + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def kernel_seconds(dev: list[dict], names) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose names contain one
    of ``names``."""
    total, n = 0.0, 0
    for e in dev:
        if e.get("cat") == "kernel" and any(k in e.get("name", "")
                                            for k in names):
            total += float(e["dur"]) * 1e-6
            n += 1
    return total, n


def top_operations(dev: list[dict], k: int = TOP) -> list[list]:
    """The ``k`` device operations that took the most time, by name."""
    by: dict[str, float] = {}
    for e in dev:
        by[e["name"]] = by.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(dev: list[dict], window: list[tuple], k: int = TOP
              ) -> list[list]:
    """The ``k`` longest stretches inside the request spans ``window``
    (start, end, label) in which no device operation ran, each with the
    label of the request it fell in."""
    if not window:
        return []
    lo, hi = window[0][0], max(s[1] for s in window)
    gaps, edge = [], lo
    for a, b in sorted(clipped(dev, lo, hi)):
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        mid = (a + b) / 2
        label = next((s[2] for s in window if s[0] <= mid <= s[1]),
                     "between requests")
        out.append([label, (b - a) * 1e-6])
    return out

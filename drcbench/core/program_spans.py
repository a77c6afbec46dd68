"""The program's own spans (``torchdraco.trace``) of a traced window, on the
Chrome trace's clock, and the window's device-idle and device-busy time by
the innermost span it falls in.

The program keeps its spans in Unix ns; the trace's events are in us from
a base that the harness does not keep. Each request opens exactly one
``build_meshes`` root a few us after the benchmark's request span opens,
so the offset between the two clocks is the median over the window's
requests of (root start - request start); the spread of those differences
says how well one constant holds. A program without the recorder, or a
window whose requests and roots do not pair, gives None, and the readers
then give nothing."""

from __future__ import annotations

import statistics

from . import trace

REQUEST_ROOT = "build_meshes"  # the root each request opens first
NO_SPAN = "(no span)"
SELF = " (self)"  # a root's time outside its children


def recorded() -> list | None:
    """The program's kept spans, or None where it has no recorder."""
    try:
        from torchdraco import trace as program_trace
    except ImportError:
        return None
    return program_trace.spans()


def _paired_roots(program: list, requests: list[tuple]) -> list[int]:
    """The start (ns) of the ``REQUEST_ROOT`` root of each request, the
    latest roots kept; [] where there are fewer roots than requests."""
    roots = sorted(s.start_ns for s in program
                   if s.name == REQUEST_ROOT and s.parent is None)
    if not requests or len(roots) < len(requests):
        return []
    return roots[-len(requests):]


def clock_offset(program: list, requests: list[tuple]
                 ) -> tuple[float, float] | None:
    """(offset ns, spread us) between the program's Unix-ns spans and the
    trace's request spans (start us, end us, label): the median and the
    distance between the quartiles of (root start - request start) over
    the requests, each paired with the ``REQUEST_ROOT`` root it opened,
    the latest roots kept. None where there are fewer roots than
    requests. Whole ns, so that no float rounds Unix time."""
    roots = _paired_roots(program, requests)
    if not roots:
        return None
    diffs = [r - round(q[0] * 1e3) for r, q in zip(roots, sorted(requests))]
    if len(diffs) < 2:
        return diffs[0], 0.0
    q1, _, q3 = statistics.quantiles([d - diffs[0] for d in diffs], n=4)
    return statistics.median(diffs), (q3 - q1) / 1e3


class Window:
    """The program's spans of a traced run, each as (start us, end us,
    span) on the trace's clock: those from the first request's root to
    the end of the window of the benchmark's request spans."""

    def __init__(self, program: list, requests: list[tuple]) -> None:
        self.offset_ns, self.spread = clock_offset(program, requests)
        self.lo, self.hi = requests[0][0], max(q[1] for q in requests)
        first = _paired_roots(program, requests)[0]
        self.spans = []
        for s in program:
            a = (s.start_ns - self.offset_ns) / 1e3
            if s.start_ns >= first and a <= self.hi:
                self.spans.append((a, (s.end_ns - self.offset_ns) / 1e3, s))
        self.roots = {s.id: s.name for _, _, s in self.spans
                      if s.parent is None}

    def total_us(self, name: str, root: str | None = None) -> float:
        """The summed length of the spans named ``name`` (under a root
        named ``root``, where given)."""
        return sum(b - a for a, b, s in self.spans if s.name == name
                   and (root is None or self.roots.get(s.root) == root))


def window(run) -> Window | None:
    """The program's spans of ``run``'s traced window, or None (no trace,
    no recorder, or no pairing of requests and roots)."""
    if not run.spans:
        return None
    program = recorded()
    if not program or not _paired_roots(program, run.spans):
        return None
    return Window(program, run.spans)


def mean_ms(run, name: str, root: str | None = None) -> float | None:
    """The spans named ``name`` (under a root named ``root``, where given)
    in ``run``'s traced window, in ms a request; None where there are
    none to read."""
    w = window(run)
    if w is None or not run.requests:
        return None
    return w.total_us(name, root) / 1e3 / len(run.requests)


def _label(s) -> str:
    return s.name + SELF if s.parent is None else s.name


def by_innermost(dev: list[dict], w: Window) -> dict[str, list[float]]:
    """{label: [device-idle us, device-busy us]} over the window: each
    stretch counted under the innermost program span it falls in, a
    root's own time under its name with ``SELF``, time in no span under
    ``NO_SPAN``."""
    busy = []
    for a, b in sorted(trace.clipped(dev, w.lo, w.hi)):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    parent = {s.id: s.parent for _, _, s in w.spans}

    def depth(i: int) -> int:
        n = 0
        while parent.get(i) is not None:
            i, n = parent[i], n + 1
        return n

    # (time, order, kind, item): at one instant ends go before starts
    marks = []
    for a, b in busy:
        marks += [(a, 1, "busy", True), (b, 0, "busy", False)]
    for a, b, s in w.spans:
        a, b = max(a, w.lo), min(b, w.hi)
        if b > a:
            marks += [(a, 1, "open", s), (b, 0, "close", s)]
    marks.sort(key=lambda m: (m[0], m[1]))
    out: dict[str, list[float]] = {}
    active: dict[int, tuple] = {}
    on, edge = False, w.lo
    for t, _, kind, item in marks + [(w.hi, 0, "end", None)]:
        if t > edge:
            inner = max(active.values(), default=None)
            label = _label(inner[3]) if inner else NO_SPAN
            out.setdefault(label, [0.0, 0.0])[on] += t - edge
            edge = t
        if kind == "busy":
            on = item
        elif kind == "open":
            active[item.id] = (depth(item.id), item.start_ns, item.id, item)
        elif kind == "close":
            active.pop(item.id, None)
    return out


def unexplained_share(table: dict[str, list[float]]) -> float | None:
    """The share, in %, of the device-idle time in no span or in a root's
    own time."""
    idle = sum(v[0] for v in table.values())
    if idle <= 0:
        return None
    lost = sum(v[0] for k, v in table.items()
               if k == NO_SPAN or k.endswith(SELF))
    return 100.0 * lost / idle

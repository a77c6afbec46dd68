"""The share of the traced window, in %, in which no device operation
(kernel, copy, fill) ran: 100 (1 - union of device events / window)."""

from drcbench.core import trace


def value(run):
    if not run.device_events or not run.spans:
        return None
    lo, hi = run.spans[0][0], max(s[1] for s in run.spans)
    busy = trace.union_us(trace.clipped(run.device_events, lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))

"""The mean a request of the program's ``route.host`` spans, in ms: the
router's host-plane encodes outside its probes, of the groups it sends to
the host (``torchdraco.trace``). None where the program's router opens no
``route.group`` span."""

from drcbench.core import program_spans


def value(run):
    w = program_spans.window(run)
    if w is None or not run.requests or not any(
            s.name == "route.group" for _, _, s in w.spans):
        return None
    return w.total_us("route.host") / 1e3 / len(run.requests)

"""The mean a request of the program's ``route.probe.host`` and
``route.probe.device`` spans, in ms: the router's probes, the host plane
on a group's first meshes and the device plane on the next, once for each
take whose decision is not yet kept (``torchdraco.trace``). None where the
program's router opens no ``route.group`` span."""

from drcbench.core import program_spans


def value(run):
    w = program_spans.window(run)
    if w is None or not run.requests or not any(
            s.name == "route.group" for _, _, s in w.spans):
        return None
    us = w.total_us("route.probe.host") + w.total_us("route.probe.device")
    return us / 1e3 / len(run.requests)

"""The share, in %, of the traced window's device-idle time that falls in
no program span or only in a root's own time (``build_meshes``,
``encode_meshes_device``, ``encode_mesh_device`` outside their children):
the idle time that no stage of the program accounts for. The window is
``idle.encode``'s, from the first request span to the last."""

from drcbench.core import program_spans


def value(run):
    if run.device_events is None:
        return None
    w = program_spans.window(run)
    if w is None:
        return None
    return program_spans.unexplained_share(
        program_spans.by_innermost(run.device_events, w))

"""The mean a request of the program's ``build.points`` spans under its
``build_meshes`` roots, in ms: the point dedup over all attributes of each
frame (``MeshBuilder``'s ``_deduplicate_points``; ``torchdraco.trace``)."""

from drcbench.core import program_spans


def value(run):
    return program_spans.mean_ms(run, "build.points", root="build_meshes")

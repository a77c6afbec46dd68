"""The mean a request of the program's ``build.values`` spans under its
``build_meshes`` roots, in ms: the per-attribute value dedup
(``unique_rows_first_occurrence``) of each frame's attributes
(``torchdraco.trace``)."""

from drcbench.core import program_spans


def value(run):
    return program_spans.mean_ms(run, "build.values", root="build_meshes")

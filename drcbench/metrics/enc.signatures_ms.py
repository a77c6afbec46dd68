"""The mean a request of the program's ``signatures`` spans, in ms:
``topology_signature`` over every mesh of the request, which hashes its
faces and each attribute's value-dedup map (``torchdraco.trace``)."""

from drcbench.core import program_spans


def value(run):
    return program_spans.mean_ms(run, "signatures")

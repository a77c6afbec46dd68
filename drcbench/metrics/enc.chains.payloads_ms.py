"""The mean a request of the program's ``chains.payloads`` spans, in ms:
the per-mesh loops of the NORMAL and TEX_COORD chains that write the
flips, the orientations and the DIRECT_CODED payloads
(``torchdraco.trace``)."""

from drcbench.core import program_spans


def value(run):
    return program_spans.mean_ms(run, "chains.payloads")

"""The mean a request of the program's ``timings["assembly_s"]``, in ms: the per-mesh assembly of the .drc (BatchEncoder)."""


def value(run):
    return run.mean_timing_ms("assembly_s")

"""The mean a request of the program's ``timings["chains_s"]``, in ms: the NORMAL and TEX_COORD chains with their guards, readbacks, host payloads and bit writers (BatchEncoder)."""


def value(run):
    return run.mean_timing_ms("chains_s")

"""Set-up: process start to the first timed request (imports, CUDA and the
kernel library, the inputs, the entry and its warm request)."""


def value(run):
    return run.setup_s

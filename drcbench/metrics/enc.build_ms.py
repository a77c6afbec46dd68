"""The mean a request of ``torchdraco.build_meshes``' seconds, in ms: the
program's meshes built from the request's arrays (value dedup, corner
attributes), timed by the entry inside the request."""


def value(run):
    return run.mean_timing_ms("build_s")

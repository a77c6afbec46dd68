"""Raw float32 attribute megabytes (positions, normals, UVs) of every mesh
encoded in the window, over the window's seconds (the window closes when the
request running at its end returns)."""


def value(run):
    return run.completed_bytes() / run.window_s / 1e6

"""The share, in %, of the window's meshes that the router's device plane
encoded: the program's ``timings["meshes_device"]`` summed over the
window's requests, over their frames. None where the program does not
count them."""


def value(run):
    n = [r["timings"].get("meshes_device") for r in run.requests]
    if not n or None in n:
        return None
    return 100.0 * sum(n) / sum(len(r["frames"]) for r in run.requests)

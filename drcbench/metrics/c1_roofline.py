"""C1, the NORMAL encode chain: the least time of the window's chains
(``roofline.normal_encode_work``, one chain over each take's meshes of
each request) over the device time of the kernels named below, in %."""

from drcbench.core import roofline

KERNELS = ("normal_encode_kernel",)


def value(run):
    got = run.kernel_seconds(KERNELS)
    if got is None:
        return None
    nbytes = ops = 0.0
    for r in run.requests:
        for take, frames in run.frames_by_take(r):
            b, o = roofline.normal_encode_work(frames, take.vertices,
                                               take.num_faces)
            nbytes += b
            ops += o
    least, _ = roofline.bound(nbytes, ops)
    return 100.0 * least / got[0]

"""K3, the position symbols' rANS lanes of a group: the least time of the
window's lanes (``roofline.rans_lanes_work`` over each request's position
streams) over the device time of the kernels named below, in %."""

from drcbench.core import roofline

KERNELS = ("rans_words_kernel",)


def value(run):
    got = run.kernel_seconds(KERNELS)
    if got is None:
        return None
    least, _ = roofline.bound(*roofline.rans_lanes_work(
        run.window_streams(attribute=0)))
    return 100.0 * least / got[0]

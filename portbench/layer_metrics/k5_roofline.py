"""k5_roofline: the least time of one K5 launch (``csrc/rgbd.cu``): the
frozen least-work count (``counts/kernel_ops.py::rgbd_least_ops``) and the
bytes it must move, over K5's device time per launch in the trace."""

from portbench.trace import kernel_time


def read(ctx):
    least = ctx["values"].get("k5_least_s")
    k = kernel_time(ctx["trace"], "rgbd_kernel")
    if least is None or k is None:
        return None
    return 100.0 * least / k[0]

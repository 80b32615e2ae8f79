"""k4_roofline.sim: the least time of one K4 launch (``csrc/megastep.cu``)
on the traced stretch's first state, from the frozen operation and byte
counts (``counts/kernel_ops.py``), over K4's device time per launch in the
profiler's trace, as a share."""

from portbench.trace import kernel_time


def read(ctx):
    least = ctx["values"].get("k4_least_s")
    k = kernel_time(ctx["trace"], "megastep_kernel")
    if least is None or k is None:
        return None
    return 100.0 * least / k[0]

"""serve_mfu: the needed forward FLOPs of the window's steps (each agent
once, through its own policy; ``counts/policy_flops.py``), over the
window's time, as a share of the float32 peak."""

from portbench.counts.peaks import PEAK_F32


def read(ctx):
    f = ctx["values"].get("window_flops")
    if not f:
        return None
    return 100.0 * f / ctx["window_s"] / PEAK_F32

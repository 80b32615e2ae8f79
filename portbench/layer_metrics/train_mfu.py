"""train_mfu: the needed FLOPs of the window's updates
(``counts/policy_flops.py``: the rollout counts each agent once through
its own policy, PPO the forward and backward of the trained policies on
their agents each epoch), over the window's time, as a share of the
float32 peak (``counts/peaks.py``)."""

from portbench.counts.peaks import PEAK_F32


def read(ctx):
    f = ctx["values"].get("window_flops")
    if not f:
        return None
    return 100.0 * f / ctx["window_s"] / PEAK_F32

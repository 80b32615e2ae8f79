"""idle.sim: the share of the traced stretch in which no kernel or copy
ran on the device: 1 minus the union of the device intervals over the
stretch's length (``portbench/trace.py``)."""


def read(ctx):
    t = ctx["trace"]
    if not t.get("window_s") or t.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

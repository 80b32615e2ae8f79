"""rollout_ms: host-clock milliseconds from the start of ``update_iter``
to ``post_rollout`` (``train/rollout.py::collect_rollout``), each closed by
a synchronize, mean over the traced window's updates."""


def read(ctx):
    s = ctx["spans"].get("rollout")
    return 1e3 * sum(s) / len(s) if s else None

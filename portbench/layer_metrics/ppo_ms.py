"""ppo_ms: host-clock milliseconds from ``post_rollout`` to the end of
``update_iter`` (the normalizer update, ``train/ppo.py::ppo_update``, ELO
and PBT), each closed by a synchronize, mean over the window's updates."""


def read(ctx):
    s = ctx["spans"].get("ppo")
    return 1e3 * sum(s) / len(s) if s else None

"""reset_ms: host-clock milliseconds of each ``PackedEnv.step`` that
triggers the episode-end full reset (``env/packed.py::_full_resets``,
level generation, K1), synchronized before and after, mean over the
window's reset steps; the harness's own span around the call."""


def read(ctx):
    s = ctx["spans"].get("reset")
    return 1e3 * sum(s) / len(s) if s else None

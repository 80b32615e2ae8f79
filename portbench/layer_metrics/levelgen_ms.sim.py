"""levelgen_ms.sim: device-clock milliseconds of level generation (the
``env.levelgen`` spans of ``env/episode.py``, around the worldgen of a
full or compact reset and of ``PackedEnv.init``) per ``env.step`` span of
the traced stretch."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "env.levelgen", "env.step")

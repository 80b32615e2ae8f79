"""env_ms.train: device-clock milliseconds of the training rollout's env
steps (the ``env.step`` spans of ``env/packed.py::PackedEnv.step`` inside
``rollout``), summed per ``update`` span of the traced stretch."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "env.step", "update", parent="rollout")

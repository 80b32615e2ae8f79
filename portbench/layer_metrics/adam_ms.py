"""adam_ms: device-clock milliseconds of the PPO update's optimizer (the
``ppo.adam`` spans of ``train/ppo.py``: ``clipped_adam`` and the
parameters' step, once a minibatch), summed per ``update`` span of the
traced stretch."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "ppo.adam", "update")

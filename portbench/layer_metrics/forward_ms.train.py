"""forward_ms.train: device-clock milliseconds of the training rollout's
forward (the ``rollout.forward`` spans of ``train/rollout.py``: normalize,
``apply_ensemble``, denormalize, the draw and its log-probabilities, 40
steps and the bootstrap), summed per ``update`` span of the traced
stretch."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "rollout.forward", "update")

"""loss_ms: device-clock milliseconds of the PPO update's loss and
gradients (the ``ppo.loss`` spans of ``train/ppo.py``: ``_policy_loss``,
``autograd.grad`` and the gradients' all-sum, once a minibatch), summed per
``update`` span of the traced stretch."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "ppo.loss", "update")

"""torso_ms: device-clock milliseconds of the conv torso's forwards (the
``model.torso`` spans of ``policy.py::ImpalaCnnNet``: every rollout
forward's, and each PPO epoch's loss forward), summed per ``update`` span
of the traced stretch. The torso's backward runs inside ``ppo.loss``
(``loss_ms``), outside these spans."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "model.torso", "update")

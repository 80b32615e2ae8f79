"""attn_ms: device-clock milliseconds of the attention blocks' forwards
(the ``model.attn`` spans of ``models/layers.py::ResidualSelfAttention``:
the rollout's, and the PPO loss's forward), summed per ``update`` span of
the traced stretch."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "model.attn", "update")

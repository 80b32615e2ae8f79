"""FLOPs, attention operations and bytes of the ``openai_hns`` policy,
counted from the configuration's widths: the dense products and the
attention's score and weighted-sum products only (each multiply-add two
FLOPs). LayerNorm, activations, the softmax, the pooling and the LSTM's
gate arithmetic are left out, so every count errs low. Each agent is
counted once, through its own policy; work an implementation does for
other policies, or again (a recomputed block), is not counted."""

from __future__ import annotations

F32 = 4


def tokens(cfg: dict) -> int:
    """The self token and one a slot of every other entity."""
    return 1 + sum(cfg["entity_counts"].values())


def attn_macs(cfg: dict) -> int:
    """Multiply-adds of the attention block for one agent: the query, key
    and value products, the scores and the weighted sum of every head,
    and the output product."""
    t, c = tokens(cfg), cfg["embed_dim"]
    return t * c * 3 * c + 2 * t * t * c + t * c * c


def encoder_macs(cfg: dict) -> int:
    """One encoder (lidar convolution, embeddings, attention block, the
    dense layer after the pooling, the LSTM step) for one agent."""
    c = cfg["embed_dim"]
    conv = cfg["lidar_samples"] * cfg["lidar_width"] * cfg["lidar_filters"]
    self_in = cfg["self_features"] + cfg["lidar_samples"] * cfg["lidar_filters"]
    embed = self_in * c + sum(
        cfg["entity_features"][k] * n * c
        for k, n in cfg["entity_counts"].items())
    out = cfg["out_channels"]
    h = cfg["lstm_channels"]
    return conv + embed + attn_macs(cfg) + c * out + (out + h) * 4 * h


def actor_macs(cfg: dict) -> int:
    return encoder_macs(cfg) + cfg["lstm_channels"] * sum(cfg["action_buckets"])


def critic_macs(cfg: dict) -> int:
    """The critic encoder and the plain value head."""
    return encoder_macs(cfg) + cfg["lstm_channels"]


def forward_flops(cfg: dict, n_full: float, n_actor_only: float = 0) -> float:
    """One forward step: ``n_full`` agents through actor and critic,
    ``n_actor_only`` (frozen past policies) through the actor."""
    full = actor_macs(cfg) + critic_macs(cfg)
    return 2.0 * (n_full * full + n_actor_only * actor_macs(cfg))


def ppo_flops(cfg: dict, agent_steps: float, epochs: int) -> float:
    """The PPO update: forward and backward (twice the forward) of actor
    and critic over the trained agents' stored steps, each epoch."""
    return 3.0 * epochs * forward_flops(cfg, agent_steps)


def attn_weight_bytes(cfg: dict) -> int:
    """One policy's parameters of the block: four C x C products with
    their biases, two LayerNorms."""
    c = cfg["embed_dim"]
    return F32 * (4 * c * c + 4 * c + 4 * c)


def attn_work(cfg: dict, agent_blocks: float, policy_blocks: float):
    """(FLOPs, bytes) of ``agent_blocks`` block forwards (an agent through
    one encoder's block), in calls that hold ``policy_blocks`` policies'
    blocks in all: each agent's tokens read and written once, its key
    mask read once, each policy's weights read once a call."""
    t, c = tokens(cfg), cfg["embed_dim"]
    flops = 2.0 * attn_macs(cfg) * agent_blocks
    n_bytes = (agent_blocks * (2 * t * c * F32 + t) +
               policy_blocks * attn_weight_bytes(cfg))
    return flops, float(n_bytes)

"""FLOPs the flagship policy needs, counted from the configuration's
widths: the dense products only (each multiply-add two FLOPs). LayerNorm,
activations, the LSTM's gate arithmetic, the pooling and the softmaxes are
left out, so every count errs low. Each agent is counted once, through its
own policy; work an implementation does for other policies, or again (a
recomputed forward), is not counted."""

from __future__ import annotations


def encoder_macs(cfg: dict) -> int:
    """Multiply-adds of one encoder (entity embeddings, the MLP, the LSTM
    step) for one agent."""
    emb = cfg["embed_dim"]
    feats, counts = cfg["entity_features"], cfg["entity_counts"]
    embed = sum(f * emb * counts.get(name, 1) for name, f in feats.items())
    ch = cfg["mlp_channels"]
    mlp_in = emb * len(feats)
    mlp = mlp_in * ch + (cfg["mlp_layers"] - 1) * ch * ch
    h = cfg["lstm_channels"]
    lstm = (ch + h) * 4 * h
    return embed + mlp + lstm


def actor_macs(cfg: dict) -> int:
    """The actor encoder and the action head, for one agent."""
    return encoder_macs(cfg) + cfg["lstm_channels"] * sum(cfg["action_buckets"])


def critic_macs(cfg: dict) -> int:
    """The critic encoder and the two-hot value head, for one agent."""
    return encoder_macs(cfg) + cfg["lstm_channels"] * cfg["critic_bins"]


def forward_flops(cfg: dict, n_full: float, n_actor_only: float = 0) -> float:
    """FLOPs of one forward step: ``n_full`` agents through actor and
    critic, ``n_actor_only`` (frozen past policies) through the actor."""
    full = actor_macs(cfg) + critic_macs(cfg)
    return 2.0 * (n_full * full + n_actor_only * actor_macs(cfg))


def ppo_flops(cfg: dict, agent_steps: float, epochs: int) -> float:
    """FLOPs of the PPO update: forward and backward (twice the forward)
    of actor and critic over the trained agents' stored steps, each
    epoch."""
    return 3.0 * epochs * forward_flops(cfg, agent_steps)

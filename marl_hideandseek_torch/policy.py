"""Default hide-and-seek policy assembly.

Port of ``marl_hideandseek_tpu/policy.py``: a per-entity-class embedding
backbone with max-pooling (embed 64 + LayerNorm + leaky-relu per class,
max over entities, concat, MLP 256x3), an LSTM(256) recurrent encoder per
branch, separate actor and critic backbones, a discrete actor head over
[5, 5, 5, 2, 2] buckets and a Dreamer-V3 critic, with the EMA observation
normalizer's prep and skip sets. An entity self-attention backbone and a
simhash lookup backbone are the alternatives.

``backbone="openai_hns"`` (the port's own; the JAX package has none) is
the policy of Baker et al., *Emergent Tool Use From Multi-Agent
Autocurricula* (2019), on this env: a circular convolution over the lidar,
entity embeddings, one masked residual self-attention block and masked
mean pooling, then the LSTM, with the env's force-based movement
(``FORCE_ACTION_BUCKETS``) and a plain value head (``backbone_recipe``). Its actor attends only
to what the agent sees; its critic, with parameters of its own, to every
entity that exists (``OpenAIHnsNet``).

``backbone="impala_cnn"`` (the port's own) trains from pixels: the deep
residual torso of Espeholt et al., *IMPALA* (2018, Figure 3, right) over
each agent's rendered 64x64 RGBD (``EnvConfig.render_frames``), one
encoder shared by actor and critic, whose core input joins the previous
action and reward and the agent's own observation (``ImpalaCnnNet``),
with the flagship's action buckets and a plain value head.

Every module holds ``num_policies`` policies stacked on a leading axis
(``models/layers.py``); ``make_policy`` draws them as flax's ``init``
does from one key per policy, or leaves them for
``bridge.policy_params_from_numpy`` to fill from a flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import FRAME_KEY, NUM_LIDAR_SAMPLES
from marl_hideandseek_torch.models import (
    MLP,
    ActorCritic,
    BackboneSeparate,
    BackboneShared,
    DenseLayerDiscreteActor,
    DreamerV3Critic,
    EntitySelfAttentionNet,
    LayerNorm,
    ObservationsEMANormalizer,
    Policy,
    RecurrentBackboneEncoder,
)
from marl_hideandseek_torch.models.layers import (
    CircularConv1d,
    ConvSection,
    Dense,
    DenseLayerCritic,
    EmbedBlock,
    ResidualSelfAttention,
    Stacked,
    he_normal,
    init_params,
    masked_mean,
    normal,
)
from marl_hideandseek_torch.models.rnn import LSTM
from marl_hideandseek_torch.utils import tracing

DEFAULT_ACTION_BUCKETS = (5, 5, 5, 2, 2)  # reference: jax_train.py:147
# The env's default movement (env/packed.py DEFAULT_BUCKETS): 11 force
# buckets on x and y, 11 torque buckets on z, then grab and lock.
FORCE_ACTION_BUCKETS = (11, 11, 11, 2, 2)
BACKBONES = ("pooled", "attention", "hash", "openai_hns", "impala_cnn")

# Features per entity of the observations (env/observations.py): the self
# vector is prep_counter 1 + self_data 13 + self_type 1 + self_lidar 30;
# the other agents, boxes and ramps have 14, 17 and 14 each.
ENTITY_FEATURES = {"self": 1 + 13 + 1 + NUM_LIDAR_SAMPLES, "agents": 14,
                   "boxes": 17, "ramps": 14}
# Entities of each class at full capacity: 5 other agents, 9 boxes,
# 2 ramps (they size HashNet's flat input, as flax sizes it from the
# observations it is initialised on).
ENTITY_COUNTS = {"agents": 5, "boxes": 9, "ramps": 2}


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; CUDA without a card raises rather
    than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device='cuda') but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run on the CPU")
    return device


def split_obs(obs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Group the 11 named tensors into self + entity-class groups, with
    the visibility masks applied to the entity rows (policy.py:41-73).

    Takes the reference layout (``box_data [.., 9, 17]`` with
    ``vis_boxes_mask [.., 9, 1]``) or the packed env's flat layout
    (``box_data [.., 153]`` with ``vis_boxes_mask [.., 9]``), reshaped here
    with the entity count taken from the mask.
    """
    self_ob = torch.cat([obs["prep_counter"], obs["self_data"],
                         obs["self_type"], obs["self_lidar"]], dim=-1)

    def entity(data, mask):
        if mask.dim() == data.dim() and mask.shape[-1] == 1:
            return data * mask
        data = data.reshape(*data.shape[:-1], mask.shape[-1], -1)
        return data * mask[..., None]

    return {"self": self_ob,
            "agents": entity(obs["agent_data"], obs["vis_agents_mask"]),
            "boxes": entity(obs["box_data"], obs["vis_boxes_mask"]),
            "ramps": entity(obs["ramp_data"], obs["vis_ramps_mask"])}


class PooledEntityNet(nn.Module):
    """Embed each entity class, max-pool over entities, concat, MLP
    (policy.py:76-95)."""

    def __init__(self, num_policies: int, dtype=torch.float32,
                 embed_dim: int = 64, num_channels: int = 256,
                 num_layers: int = 3, device=None):
        super().__init__()
        self.num_channels = num_channels
        for name, f in ENTITY_FEATURES.items():
            setattr(self, f"embed_{name}", EmbedBlock(
                num_policies, f, embed_dim, dtype, device))
        self.MLP_0 = MLP(num_policies, 4 * embed_dim, num_channels,
                         num_layers, dtype, device)

    def forward(self, obs, train: bool = False):
        grouped = split_obs(obs)
        feats = [self.embed_self(grouped["self"])]
        for name in ("agents", "boxes", "ramps"):
            e = getattr(self, f"embed_{name}")(grouped[name])
            feats.append(torch.amax(e, dim=-2))
        return self.MLP_0(torch.cat(feats, dim=-1), train)


class HashNet(Stacked):
    """Simhash lookup-table backbone (policy.py:98-133): a random
    projection of the concatenated observation to sign bits, the bits as a
    table index, the table row through the custom LayerNorm. ``proj [P, H,
    F]`` is a parameter, carried across with the rest, and so is ``table
    [P, 2**H, D]``; both in the compute dtype, as flax creates them."""

    def __init__(self, num_policies: int, dtype=torch.float32,
                 hash_power: int = 8, feature_dim: int = 32, device=None):
        super().__init__(num_policies, device)
        self.hash_power = hash_power
        self.num_channels = feature_dim
        n_in = ENTITY_FEATURES["self"] + sum(
            n * ENTITY_FEATURES[k] for k, n in ENTITY_COUNTS.items())
        self.add("proj", (hash_power, n_in), normal, dtype)
        self.add("table", (2 ** hash_power, feature_dim), he_normal, dtype)
        self.LayerNorm_0 = LayerNorm(num_policies, feature_dim, device=device)

    def forward(self, obs, train: bool = False):
        g = split_obs(obs)
        flat = torch.cat([g["self"]] + [g[k].flatten(-2) for k in
                                        ("agents", "boxes", "ramps")], -1)
        lead = flat.shape[1:-1]
        f2 = flat.reshape(flat.shape[0], -1, flat.shape[-1])
        dots = torch.matmul(f2, self.proj.transpose(1, 2))     # [P, M, H]
        powers = 2 ** torch.arange(self.hash_power, device=flat.device,
                                   dtype=torch.int32)
        idx = ((dots > 0).to(torch.int32) * powers).sum(-1)    # [P, M]
        p = self.table.shape[0]
        rows = torch.arange(p, device=flat.device)[:, None]
        feats = self.table[rows, idx.long()]
        return self.LayerNorm_0(feats.reshape(p, *lead, -1))


class AttentionEntityNet(nn.Module):
    """Entity self-attention backbone (policy.py:136-153)."""

    def __init__(self, num_policies: int, dtype=torch.float32,
                 num_embed_channels: int = 128, num_out_channels: int = 256,
                 num_heads: int = 4, device=None):
        super().__init__()
        self.num_channels = num_out_channels
        self.EntitySelfAttentionNet_0 = EntitySelfAttentionNet(
            num_policies, ENTITY_FEATURES, num_embed_channels,
            num_out_channels, num_heads, dtype, device)

    def forward(self, obs, train: bool = False):
        return self.EntitySelfAttentionNet_0(split_obs(obs), train)


class VisibleKeyTally:
    """Keys the actor's attention may attend to, summed on the device
    over every actor query row (``add``), with the number of rows: its
    ``read`` (a host read, for after a timed stretch) is the mean
    visible keys per actor query, the self token included."""

    def __init__(self):
        self.sums: Optional[torch.Tensor] = None   # [keys, rows] float64

    def add(self, mask: torch.Tensor) -> None:
        if self.sums is None:
            self.sums = torch.zeros(2, dtype=torch.float64,
                                    device=mask.device)
        self.sums[0] += mask.sum()
        self.sums[1] += mask[..., 0].numel()

    def read(self) -> Optional[float]:
        if self.sums is None:
            return None
        keys, rows = self.sums.tolist()
        return keys / rows


def entity_group(obs, data: str, mask: str) -> torch.Tensor:
    """An entity group ``[.., N, F]`` from the packed env's flat layout
    (``[.., N * F]``, N the mask's count)."""
    x = obs[data]
    return x.reshape(*x.shape[:-1], obs[mask].shape[-1], -1)


class OpenAIHnsNet(nn.Module):
    """Baker et al. 2019's entity encoder (appendix B; the code's
    ``ma_policy/layers.py``), one of ``view`` ``"actor"`` or ``"critic"``:

    - self token: a circular convolution of the 30 lidar samples (9
      filters of width 3), ReLU, flattened position-major, joined to
      ``prep_counter / 96``, ``self_data`` and ``self_type``; Dense 285 ->
      128 and ReLU;
    - one token for each other agent, box and ramp slot: Dense of its own
      features, weights per entity type, and ReLU;
    - the key mask: the self token and, for the actor, the entities the
      agent sees (``vis_*_mask``); for the critic every slot that holds
      an entity (a row not all zero: the env zeroes empty slots, and the
      normalizer keeps them zero, ``entity_rows``);
    - one residual self-attention block (4 heads of 32) under that mask,
      the mean of its outputs over the mask, Dense 128 -> 256, ReLU and
      LayerNorm.

    The actor's masks go into its ``visible_keys`` tally."""

    # (entity type, data key, visibility key)
    GROUPS = (("agents", "agent_data", "vis_agents_mask"),
              ("boxes", "box_data", "vis_boxes_mask"),
              ("ramps", "ramp_data", "vis_ramps_mask"))
    FILTERS, EMBED, HEADS, OUT = 9, 128, 4, 256

    def __init__(self, num_policies: int, view: str, dtype=torch.float32,
                 device=None):
        super().__init__()
        if view not in ("actor", "critic"):
            raise ValueError(f"unknown view {view!r}")
        self.view = view
        self.visible_keys = VisibleKeyTally() if view == "actor" else None
        self.num_channels = self.OUT
        p, c = num_policies, self.EMBED
        self.lidar_conv = CircularConv1d(p, 1, self.FILTERS, 3, dtype, device)
        n_self = 1 + 13 + 1 + self.FILTERS * NUM_LIDAR_SAMPLES
        self.embed_self = Dense(p, n_self, c, dtype=dtype, device=device)
        for name, _, _ in self.GROUPS:
            setattr(self, f"embed_{name}", Dense(
                p, ENTITY_FEATURES[name], c, dtype=dtype, device=device))
        self.attn = ResidualSelfAttention(p, c, self.HEADS, dtype, device)
        self.Dense_0 = Dense(p, c, self.OUT, dtype=dtype, device=device)
        self.LayerNorm_0 = LayerNorm(p, self.OUT, device=device)

    def forward(self, obs, train: bool = False):
        conv = torch.relu(self.lidar_conv(obs["self_lidar"][..., None]))
        own = torch.cat([obs["prep_counter"], obs["self_data"],
                         obs["self_type"]], -1)               # [P|1, .., 15]
        self_in = torch.cat([own.expand(conv.shape[0], *own.shape[1:]),
                             conv.flatten(-2)], -1)
        tokens = [torch.relu(self.embed_self(self_in)).unsqueeze(-2)]
        masks = [torch.ones_like(obs["vis_agents_mask"][..., :1],
                                 dtype=torch.bool)]
        for name, data, vis in self.GROUPS:
            rows = entity_group(obs, data, vis)
            tokens.append(torch.relu(getattr(self, f"embed_{name}")(rows)))
            masks.append(obs[vis] != 0 if self.view == "actor"
                         else (rows != 0).any(-1))
        mask = torch.cat(masks, -1)                           # [P|1, .., T]
        if self.visible_keys is not None:
            self.visible_keys.add(mask)
        x = self.attn(torch.cat(tokens, -2), mask)            # [P, .., T, C]
        pooled = masked_mean(x, mask)
        return self.LayerNorm_0(torch.relu(self.Dense_0(pooled)))


class ImpalaCnnNet(nn.Module):
    """IMPALA's deep network (Espeholt et al. 2018, Figure 3, right; the
    code's ``experiment.py``, ``Agent._torso``) on each agent's frame
    ``FRAME_KEY`` ``[.., 4, 64, 64]`` (RGB / 255, depth / 200):

    - the torso: three sections (``ConvSection``) of 16, 32 and 32
      channels, each a 3 x 3 convolution, the SAME 3 x 3 max pool with
      stride 2 and two residual blocks; ReLU, flatten (32 x 8 x 8 =
      2,048, channel-major), Dense 256 and ReLU. Each call is the span
      ``model.torso``, and adds the frames it ran to ``torso_frames``;
    - the core input: the torso's output, the previous reward clipped to
      [-1, 1] (``prev_reward``), one one-hot a bucket of the previous
      action (``prev_action``) and, in the slot of IMPALA's instruction,
      the agent's own observation (``split_obs``'s self group): 256 + 1
      + sum(buckets) + 45 features.

    Each policy runs its own frames through the whole torso (a loop over
    the policy axis); their flattened outputs meet again in one batched
    Dense."""

    SECTIONS = ((16, 2), (32, 2), (32, 2))
    OUT = 256

    def __init__(self, num_policies: int, buckets: Sequence[int],
                 dtype=torch.float32, device=None):
        super().__init__()
        in_ch = 4
        for i, (ch, blocks) in enumerate(self.SECTIONS):
            setattr(self, f"ConvSection_{i}", ConvSection(
                num_policies, in_ch, ch, blocks, dtype, device))
            in_ch = ch
        self.Dense_0 = Dense(num_policies, in_ch * 8 * 8, self.OUT,
                             dtype=dtype, device=device)
        self.num_channels = (self.OUT + 1 + sum(buckets) +
                             ENTITY_FEATURES["self"])
        self.torso_frames = 0

    def torso(self, frames: torch.Tensor) -> torch.Tensor:
        """frames ``[P|1, .., 4, H, W]`` -> ``[P, .., 256]``."""
        with tracing.span("model.torso"):
            p = self.Dense_0.kernel.shape[0]
            lead = frames.shape[1:-3]
            flat = []
            for i in range(p):
                x = frames[i if frames.shape[0] > 1 else 0]
                x = x.reshape(-1, *frames.shape[-3:])
                for k in range(len(self.SECTIONS)):
                    x = getattr(self, f"ConvSection_{k}")(x, i)
                flat.append(torch.relu(x).flatten(1))
                self.torso_frames += x.shape[0]
            out = torch.relu(self.Dense_0(torch.stack(flat)))
            return out.reshape(p, *lead, self.OUT)

    def forward(self, obs, train: bool = False):
        feat = self.torso(obs[FRAME_KEY])
        own = torch.cat([obs["prev_reward"], obs["prev_action"],
                         obs["prep_counter"], obs["self_data"],
                         obs["self_type"], obs["self_lidar"]], -1)
        own = own.to(feat.dtype).expand(feat.shape[0], *own.shape[1:])
        return torch.cat([feat, own], -1)


@dataclasses.dataclass(frozen=True)
class Recipe:
    """What a backbone brings beside its encoder: its action heads, its
    critic (the Dreamer-V3 critic, or a plain value head on EMA-normalized
    returns: ``TrainConfig.dreamer_v3_critic``), the env's movement
    (``SimFlags.ZeroAgentVelocity``'s instant velocities, or forces), and
    whether the env renders each agent's view into the observations
    (``EnvConfig.render_frames``)."""

    action_buckets: Tuple[int, ...] = DEFAULT_ACTION_BUCKETS
    dreamer_critic: bool = True
    instant_velocity: bool = True
    frames: bool = False


def backbone_recipe(backbone: str) -> Recipe:
    """train.sh's recipe for the upstream backbones; Baker et al.'s force
    movement and plain value head for ``openai_hns``; for
    ``impala_cnn`` the flagship's movement and buckets, a plain value
    head and rendered frames."""
    if backbone == "openai_hns":
        return Recipe(FORCE_ACTION_BUCKETS, dreamer_critic=False,
                      instant_velocity=False)
    if backbone == "impala_cnn":
        return Recipe(dreamer_critic=False, frames=True)
    return Recipe()


def make_policy(dtype=torch.float32,
                action_buckets: Optional[Sequence[int]] = None,
                backbone: str = "pooled", num_rnn_channels: int = 256, *,
                num_policies: int = 1, device="cuda",
                key: Optional[torch.Tensor] = None) -> Policy:
    """Build the default policy (policy.py:156-210) with ``num_policies``
    policies stacked, its parameters on ``device``: policy ``i`` drawn
    as flax's ``init`` draws it from ``split(key, num_policies)[i]``
    (``key`` a ``prng`` key; ``PRNGKey(0)`` when None). ``action_buckets``
    defaults to the backbone's (``backbone_recipe``)."""
    device = resolve_device(device, "make_policy")
    p = num_policies
    recipe = backbone_recipe(backbone)
    if action_buckets is None:
        action_buckets = recipe.action_buckets

    def encoder(view):
        if backbone == "impala_cnn":
            net = ImpalaCnnNet(p, action_buckets, dtype, device=device)
        elif backbone == "pooled":
            net = PooledEntityNet(p, dtype, device=device)
        elif backbone == "attention":
            net = AttentionEntityNet(p, dtype, device=device)
        elif backbone == "hash":
            net = HashNet(p, dtype, device=device)
        elif backbone == "openai_hns":
            net = OpenAIHnsNet(p, view, dtype, device=device)
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        return RecurrentBackboneEncoder(
            net=net, rnn=LSTM(p, net.num_channels, num_rnn_channels,
                              num_layers=1, dtype=dtype, device=device))

    if recipe.dreamer_critic:
        critic = DreamerV3Critic(p, num_rnn_channels, dtype, device=device)
    else:
        critic = DenseLayerCritic(p, num_rnn_channels, dtype, device=device)
    if backbone == "impala_cnn":
        # One torso and LSTM for both heads, as IMPALA shares them.
        body = BackboneShared(prefix=None, encoder=encoder("shared"))
    else:
        body = BackboneSeparate(prefix=None, actor_encoder=encoder("actor"),
                                critic_encoder=encoder("critic"))
    actor_critic = ActorCritic(
        backbone=body,
        actor=DenseLayerDiscreteActor(p, num_rnn_channels, action_buckets,
                                      dtype, device),
        critic=critic,
    )
    key = prng.key(0) if key is None else prng.as_key(key)
    init_params(actor_critic, prng.split(key, p))

    obs_preprocess = ObservationsEMANormalizer.create(
        decay=0.99999,
        dtype=dtype,
        prep_fns={
            "prep_counter":
                lambda x: (x.to(torch.float32) / 96.0).to(dtype),
            "self_type": lambda x: x.to(dtype),
            "vis_agents_mask": lambda x: x.to(dtype),
            "vis_boxes_mask": lambda x: x.to(dtype),
            "vis_ramps_mask": lambda x: x.to(dtype),
        },
        skip_normalization={
            "prep_counter", "self_type", "self_mask", "vis_agents_mask",
            "vis_boxes_mask", "vis_ramps_mask", FRAME_KEY, "prev_action",
            "prev_reward",
        },
        entity_rows=({"agent_data": ENTITY_FEATURES["agents"],
                      "box_data": ENTITY_FEATURES["boxes"],
                      "ramp_data": ENTITY_FEATURES["ramps"]}
                     if backbone == "openai_hns" else None),
    )
    return Policy(actor_critic=actor_critic, obs_preprocess=obs_preprocess,
                  get_episode_scores=lambda episode_result: episode_result,
                  core_inputs=backbone == "impala_cnn")

"""Actor-critic composition: backbones, encoders, the Policy bundle.

Port of ``marl_hideandseek_tpu/models/actor_critic.py``. The recurrent
state is threaded explicitly, as nested tuples of ``[L, N, C]`` tensors
per agent (``init_recurrent_state``). ``ActorCritic`` takes the
observations and the state shared by every policy of its ensemble, or
with ``per_policy`` each policy's own rows (``[P, M, ...]``, states ``[P,
L, M, C]``), and returns each output with the policy axis in front
(``[P, M, ...]``): ``train/rollout.py::apply_ensemble`` routes each agent
to its policy's rows and back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from torch import nn

from marl_hideandseek_torch.models.layers import FlaxLayerNorm
from marl_hideandseek_torch.models.normalizer import ObservationsEMANormalizer


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested tuples, lists and dicts
    (``rest``: trees of the same structure, passed alongside)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _shared(tree):
    """Inputs shared by every policy: a policy axis of size 1 in front."""
    return tree_map(lambda x: x.unsqueeze(0), tree)


class BackboneEncoder(nn.Module):
    """Feed-forward encoder (no recurrence)."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def init_recurrent_state(self, n, device=None):
        return ()

    def clear_recurrent_state(self, states, should_clear):
        return ()

    def forward(self, rnn_states, obs, train=False):
        return self.net(obs, train), ()

    def sequence(self, start_states, seq_ends, seq_obs, train=False):
        return self.net(seq_obs, train)


class RecurrentBackboneEncoder(nn.Module):
    """Feature net, then an RNN, then flax's default LayerNorm
    (``rnn_norm``)."""

    def __init__(self, net: nn.Module, rnn: nn.Module):
        super().__init__()
        self.net = net
        self.rnn = rnn
        p = rnn.layer_0_ih.num_policies
        self.rnn_norm = FlaxLayerNorm(p, rnn.num_hidden_channels,
                                      device=rnn.layer_0_ih.kernel.device)

    def init_recurrent_state(self, n, device=None):
        return self.rnn.init_recurrent_state(n, device)

    def clear_recurrent_state(self, states, should_clear):
        return self.rnn.clear_recurrent_state(states, should_clear)

    def forward(self, rnn_states, obs, train=False):
        features = self.net(obs, train)
        out, new_states = self.rnn(rnn_states, features, train)
        return self.rnn_norm(out), new_states

    def sequence(self, start_states, seq_ends, seq_obs, train=False):
        features = self.net(seq_obs, train)
        outs = self.rnn.sequence(start_states, seq_ends, features, train)
        return self.rnn_norm(outs)


class BackboneShared(nn.Module):
    """One encoder feeding both heads."""

    def __init__(self, prefix: Optional[Callable], encoder: nn.Module):
        super().__init__()
        self.prefix = prefix
        self.encoder = encoder

    def init_recurrent_state(self, n, device=None):
        return (self.encoder.init_recurrent_state(n, device),)

    def clear_recurrent_state(self, states, should_clear):
        return (self.encoder.clear_recurrent_state(states[0], should_clear),)

    def _prefix(self, obs, train):
        return self.prefix(obs, train) if self.prefix else obs

    def forward(self, rnn_states, obs, train=False):
        feat, new_state = self.encoder(rnn_states[0],
                                       self._prefix(obs, train), train)
        return (feat, feat), (new_state,)

    def actor_only(self, rnn_states, obs, train=False):
        """Shared encoder: actor-only is the full encoder pass."""
        feat, new_state = self.encoder(rnn_states[0],
                                       self._prefix(obs, train), train)
        return feat, (new_state,)

    def actor_only_states(self, new_states, old_states):
        return new_states

    def sequence(self, start_states, seq_ends, seq_obs, train=False):
        feat = self.encoder.sequence(start_states[0], seq_ends,
                                     self._prefix(seq_obs, train), train)
        return feat, feat


class BackboneSeparate(nn.Module):
    """Separate actor and critic encoders."""

    def __init__(self, prefix: Optional[Callable], actor_encoder: nn.Module,
                 critic_encoder: nn.Module):
        super().__init__()
        self.prefix = prefix
        self.actor_encoder = actor_encoder
        self.critic_encoder = critic_encoder

    def init_recurrent_state(self, n, device=None):
        return (self.actor_encoder.init_recurrent_state(n, device),
                self.critic_encoder.init_recurrent_state(n, device))

    def clear_recurrent_state(self, states, should_clear):
        return (
            self.actor_encoder.clear_recurrent_state(states[0], should_clear),
            self.critic_encoder.clear_recurrent_state(states[1],
                                                      should_clear),
        )

    def _prefix(self, obs, train):
        return self.prefix(obs, train) if self.prefix else obs

    def forward(self, rnn_states, obs, train=False):
        obs = self._prefix(obs, train)
        a_feat, a_state = self.actor_encoder(rnn_states[0], obs, train)
        c_feat, c_state = self.critic_encoder(rnn_states[1], obs, train)
        return (a_feat, c_feat), (a_state, c_state)

    def actor_only(self, rnn_states, obs, train=False):
        """Actor encoder only (frozen-policy rollouts skip the critic); the
        critic's recurrent state passes through unchanged."""
        a_feat, a_state = self.actor_encoder(
            rnn_states[0], self._prefix(obs, train), train)
        return a_feat, (a_state, rnn_states[1])

    def actor_only_states(self, new_states, old_states):
        return new_states[0], old_states[1]

    def sequence(self, start_states, seq_ends, seq_obs, train=False):
        seq_obs = self._prefix(seq_obs, train)
        a = self.actor_encoder.sequence(start_states[0], seq_ends, seq_obs,
                                        train)
        c = self.critic_encoder.sequence(start_states[1], seq_ends, seq_obs,
                                         train)
        return a, c


class ActorCritic(nn.Module):
    """Backbone + discrete actor head + critic head. Every method takes
    observations and recurrent state shared by the ensemble (no policy
    axis), or with ``per_policy`` the policy axis in front of every input
    (each policy runs its own rows), and returns outputs with the policy
    axis in front."""

    def __init__(self, backbone: nn.Module, actor: nn.Module,
                 critic: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.actor = actor
        self.critic = critic

    def init_recurrent_state(self, n, device=None):
        return self.backbone.init_recurrent_state(n, device)

    def clear_recurrent_state(self, states, should_clear):
        return self.backbone.clear_recurrent_state(states, should_clear)

    def forward(self, rnn_states, obs, train: bool = False,
                per_policy: bool = False):
        """One rollout step: (action dists, critic out, new states). With
        ``per_policy`` the inputs carry the policy axis (``[P, M, ...]``,
        states ``[P, L, M, C]``)."""
        if not per_policy:
            rnn_states, obs = _shared(rnn_states), _shared(obs)
        (a_feat, c_feat), new_states = self.backbone(rnn_states, obs, train)
        return self.actor(a_feat), self.critic(c_feat), new_states

    def act(self, rnn_states, obs, train: bool = False):
        """Actor-only step for frozen (past) policies: (action dists, new
        states), without the critic."""
        a_feat, new_states = self.backbone.actor_only(
            _shared(rnn_states), _shared(obs), train)
        return self.actor(a_feat), new_states

    def actor_only_states(self, new_states, old_states):
        """The recurrent state an actor-only step leaves, from a full
        step's ``new_states``: a separate critic encoder's part kept as in
        ``old_states``."""
        return self.backbone.actor_only_states(new_states, old_states)

    def sequence(self, start_states, seq_ends, seq_obs, train: bool = True,
                 per_policy: bool = False):
        """BPTT replay over stored ``[T, N, ...]`` sequences. With
        ``per_policy`` every input carries the policy axis in front
        (``[P, T, N, ...]``, states ``[P, L, N, C]``): each policy replays
        its own agents."""
        if not per_policy:
            start_states, seq_obs = _shared(start_states), _shared(seq_obs)
        a_feat, c_feat = self.backbone.sequence(start_states, seq_ends,
                                                seq_obs, train)
        return self.actor(a_feat), self.critic(c_feat)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Actor-critic module + observation preprocessing. ``core_inputs``:
    the policy reads the previous action and reward (IMPALA's core
    input), which the rollout and the inference loop then carry as the
    observations ``prev_action`` and ``prev_reward``
    (``train/rollout.py::core_inputs``)."""

    actor_critic: ActorCritic
    obs_preprocess: Optional[ObservationsEMANormalizer] = None
    get_episode_scores: Callable[[Any], Any] = lambda episode_result: \
        episode_result
    core_inputs: bool = False

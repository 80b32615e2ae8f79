"""Policy ensembles on the agent batch.

The part of ``marl_hideandseek_tpu/train/rollout.py`` that inference uses:
``apply_ensemble``. ``collect_rollout``, ``compute_gae`` and the rest come
with the training slice.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn
from torch.func import functional_call

from marl_hideandseek_torch.models import Policy
from marl_hideandseek_torch.models.actor_critic import tree_map


class _Act(nn.Module):
    """``ActorCritic.act`` as a module's forward, for ``functional_call``."""

    def __init__(self, actor_critic: nn.Module):
        super().__init__()
        self.ac = actor_critic

    def forward(self, rnn_states, obs):
        return self.ac.act(rnn_states, obs)


def apply_ensemble(policy: Policy, all_params: Mapping[str, torch.Tensor],
                   rnn_states, obs, assignments: torch.Tensor,
                   num_policies: int, num_train: Optional[int] = None):
    """Apply every policy to the whole agent batch, then give each agent
    its assigned policy's outputs (rollout.py:61-126).

    all_params: the flat parameter dict, leading policy axis P. Every
    layer runs as one batched product over the P policies (the stacked
    modules of ``models/layers.py``), which computes what JAX's
    ``vmap`` over the policy axis computes. Returns (logits ``[N, L]``,
    values ``[N]``, new recurrent state ``[.., N, C]``) per agent.

    With ``num_train`` set, policies at index >= num_train are frozen past
    policies: they run actor-only (values 0, the critic's recurrent state
    passed through).

    Each agent's policy is picked with a gather where JAX contracts with a
    one-hot: the same for finite values, but a non-finite output of a
    policy the agent does not use turns JAX's one-hot sum into NaN and
    leaves the gather untouched.
    """
    ac = policy.actor_critic

    def one(params):
        dists, critic_out, new_rnn = functional_call(
            ac, dict(params), (rnn_states, obs), strict=True)
        return dists.logits, critic_out["value"][..., 0], new_rnn

    if num_policies == 1:
        logits, values, new_rnn = one({k: v[:1] for k, v in
                                       all_params.items()})
        return logits[0], values[0], tree_map(lambda x: x[0], new_rnn)

    if num_train is not None and 0 < num_train < num_policies:
        n_past = num_policies - num_train
        lg_t, val_t, rnn_t = one({k: v[:num_train]
                                  for k, v in all_params.items()})
        dists, rnn_p = functional_call(
            _Act(ac), {f"ac.{k}": v[num_train:]
                       for k, v in all_params.items()},
            (rnn_states, obs), strict=True)
        logits_all = torch.cat([lg_t, dists.logits], 0)
        values_all = torch.cat([val_t, val_t.new_zeros(
            (n_past,) + val_t.shape[1:])], 0)
        rnn_all = tree_map(lambda a, b: torch.cat(
            [a, b.expand(n_past, *b.shape[1:])], 0), rnn_t, rnn_p)
    else:
        logits_all, values_all, rnn_all = one(all_params)   # [P, N, ..]

    idx = assignments.to(torch.long)

    def sel(arr):
        """arr [P, ..., N, C] or [P, N]: each agent's policy's slice."""
        n_axis = arr.dim() - 2 if arr.dim() >= 3 else 1
        shape = [1] * arr.dim()
        shape[n_axis] = -1
        i = idx.reshape(shape).expand(1, *arr.shape[1:])
        return torch.gather(arr, 0, i)[0]

    return sel(logits_all), sel(values_all), tree_map(sel, rnn_all)

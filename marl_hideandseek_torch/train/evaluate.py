"""Policy evaluation: ``eval_load_ckpt`` and ``eval_policies``.

Port of ``marl_hideandseek_tpu/train/evaluate.py``. ``eval_load_ckpt``
reads the port's policy checkpoint (``bridge.save_policy_checkpoint``;
a JAX orbax checkpoint converts to one, README.md); ``eval_policies``
plays the policies against each other on the classic ``HideAndSeekEnv``
and keeps their ELOs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.bridge import (
    check_policy_params,
    load_policy_checkpoint,
)
from marl_hideandseek_torch.models import DiscreteActionDistributions, Policy
from marl_hideandseek_torch.policy import resolve_device
from marl_hideandseek_torch.train import elo as elo_mod
from marl_hideandseek_torch.train.cfg import EvalConfig
from marl_hideandseek_torch.train.rollout import apply_ensemble
from marl_hideandseek_torch.types import AGENT_HIDER


def eval_load_ckpt(policy: Policy, ckpt_path,
                   single_policy: Optional[int] = None,
                   train_only: bool = False, device="cuda"):
    """Load policy weights and normalizer statistics from a policy
    checkpoint for evaluation, onto ``device``.

    Returns (params ``[P, ...]``, obs_stats, elo ``[P]``): the train
    policies, then the past ones unless ``train_only``; with
    ``single_policy`` only that entry. ``elo[i]`` stays the rating of
    policy i under every selector. Raises if the parameters do not fit
    ``policy``."""
    device = resolve_device(device, "eval_load_ckpt")
    raw = load_policy_checkpoint(ckpt_path, device)
    params, past, elo = raw["params"], raw["past_params"], raw["elo"]
    n_train = next(iter(params.values())).shape[0]
    if not train_only and past:
        params = {k: torch.cat([v, past[k]], 0) for k, v in params.items()}
    else:
        elo = elo[:n_train]
    if single_policy is not None:
        params = {k: v[single_policy:single_policy + 1]
                  for k, v in params.items()}
        elo = elo[single_policy:single_policy + 1]
    check_policy_params(params, policy)
    return params, raw["obs_stats"], elo


def eval_policies(dev, eval_cfg: EvalConfig, env, policy: Policy, params,
                  obs_stats, iter_cb: Optional[Callable] = None):
    """Run evaluation episodes on the classic env; returns a dict with the
    ELOs, the summed episode scores per world and team slot, the number
    of finished episodes and the matchups.

    Worlds pair the policies round robin (hiders play ``t0``, seekers
    ``t1``; with one policy, or ``eval_competitive`` off, both teams play
    the same one and the ELOs stay put). Episode results are credited to
    the policies in spawn order (``seekers_first``), and the ELOs update
    at every step from the episodes that ended. ``iter_cb(step_data)`` is
    called each step with the state, observations, actions, rewards,
    dones and episode results. The env starts from ``PRNGKey(7)`` and
    step ``i`` samples with ``key, sub = split(key)`` from ``PRNGKey(11)``
    (evaluate.py:99,154-158). ``dev`` is unused: the env's device is the
    run's."""
    cfg = env.cfg
    num_worlds, a_per_w = cfg.num_worlds, cfg.max_agents
    n_agents = num_worlds * a_per_w
    device = env.device
    norm = policy.obs_preprocess
    ac = policy.actor_critic
    n_pol = next(iter(params.values())).shape[0]
    buckets = tuple(eval_cfg.actions.actions_num_buckets)
    key = prng.key(11, device)

    def flat(o):
        return {k: v.reshape((n_agents,) + v.shape[2:])
                for k, v in norm.prep(o).items()}

    competitive = eval_cfg.eval_competitive and n_pol > 1
    w_idx = torch.arange(num_worlds, device=device)
    t0 = w_idx % n_pol
    t1 = (w_idx + 1 + w_idx // n_pol) % n_pol if competitive else t0

    elo = torch.full((n_pol,), elo_mod.ELO_START, device=device)
    total_scores = torch.zeros((num_worlds, 2), device=device)
    n_finished = torch.zeros((), dtype=torch.long, device=device)
    with torch.no_grad():
        state, result = env.init(prng.key(7, device))
        obs = flat(result.obs)
        rnn = ac.init_recurrent_state(n_agents, device)
        for step in range(eval_cfg.num_eval_steps):
            is_h = state.agent_type == AGENT_HIDER               # [W, A]
            assignments = torch.where(is_h, t0[:, None],
                                      t1[:, None]).reshape(-1)
            sf = state.seekers_first.to(torch.bool)
            team_pol = torch.stack([torch.where(sf, t1, t0),
                                    torch.where(sf, t0, t1)], -1)
            logits, _, new_rnn = apply_ensemble(
                policy, params, rnn, norm.normalize(obs_stats, obs),
                assignments, n_pol)
            dists = DiscreteActionDistributions(buckets, logits)
            if eval_cfg.use_deterministic_policy:
                actions = dists.best()
            else:
                key, sub = prng.split(key).unbind(0)
                actions = dists.sample(sub)
            state, result = env.step(
                state, actions.reshape(num_worlds, a_per_w, -1))
            obs = flat(result.obs)
            dones = result.dones.reshape(-1).to(torch.bool)
            rnn = ac.clear_recurrent_state(new_rnn, dones)
            dones_w = result.dones[:, 0, 0].to(torch.bool)
            if competitive:
                elo = elo_mod.update_elo_pairwise(
                    elo, *elo_mod.matches_from_episode_results(
                        result.episode_results, team_pol, dones_w))
            total_scores += result.episode_results * dones_w[:, None]
            n_finished += dones_w.sum()
            if iter_cb is not None:
                iter_cb({"step": step, "state": state, "obs": result.obs,
                         "actions": actions, "rewards": result.rewards,
                         "dones": result.dones,
                         "episode_results": result.episode_results})
    return {"elo": elo, "total_scores": total_scores,
            "episodes_finished": int(n_finished), "matchups": (t0, t1)}

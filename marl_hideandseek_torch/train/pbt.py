"""Population-based training: hyperparameter explore/exploit and the
past-policy refresh.

Port of ``marl_hideandseek_tpu/train/pbt.py``: learning rate and entropy
coefficient (and any configured reward hyperparameter) drawn per train
policy from their ``ParamExplore`` ranges; truncation selection copies the
best train policy's weights and optimizer state into the worst, with its
hyperparameters perturbed; past policies take snapshots of the best train
policy, round robin. Every draw comes from the ``torch.Generator`` passed
in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import torch

from marl_hideandseek_torch.train.cfg import ParamExplore, TrainConfig


def sample_param(gen: torch.Generator, spec: ParamExplore, shape=(),
                 device=None) -> torch.Tensor:
    """A value in the explore range around ``spec.base`` (pbt.py:20-29):
    a uniform scale in [min_scale, max_scale], log10-uniform with
    ``log10_scale``."""
    u = torch.rand(shape, generator=gen, device=device)
    if spec.log10_scale:
        lo, hi = math.log10(spec.min_scale), math.log10(spec.max_scale)
        scale = torch.pow(10.0, lo + u * (hi - lo))
    else:
        scale = spec.min_scale + u * (spec.max_scale - spec.min_scale)
    return spec.base * scale


def perturb_param(gen: torch.Generator, value: torch.Tensor,
                  spec: ParamExplore) -> torch.Tensor:
    """An inherited value times 1.2 or 1 / 1.2 (a fair coin), clamped to
    [base * min_scale, base * max_scale] (pbt.py:32-38)."""
    up = torch.rand((), generator=gen, device=value.device) < 0.5
    new = value * torch.where(up, 1.2, 1.0 / 1.2)
    return torch.clamp(new, spec.base * spec.min_scale,
                       spec.base * spec.max_scale)


def _reward_specs(cfg: TrainConfig) -> Dict[str, ParamExplore]:
    """The PBT-explorable reward hyperparameters (pbt.py:41-47)."""
    if cfg.pbt is None:
        return {}
    return dict(cfg.pbt.reward_hyper_params_explore or {})


def _explored(cfg: TrainConfig) -> Dict[str, ParamExplore]:
    """Every explored hyperparameter by name, in draw order: ``lr``,
    ``entropy_coef``, then the reward ones sorted by name."""
    specs = {"lr": cfg.lr, "entropy_coef": cfg.algo.entropy_coef}
    out = {k: v for k, v in specs.items() if isinstance(v, ParamExplore)}
    out.update(sorted(_reward_specs(cfg).items()))
    return out


def init_hyper_params(cfg: TrainConfig, gen: torch.Generator,
                      device=None) -> Dict[str, torch.Tensor]:
    """Per-train-policy hyperparameters ``[P]`` (pbt.py:50-67): each
    explored one drawn per policy, the others the configured scalars."""
    n = cfg.num_train_policies
    out = {"lr": cfg.lr, "entropy_coef": cfg.algo.entropy_coef}
    out = {k: torch.full((n,), float(v), device=device)
           for k, v in out.items() if not isinstance(v, ParamExplore)}
    for name, spec in _explored(cfg).items():
        out[name] = sample_param(gen, spec, (n,), device)
    return out


def explore_exploit(cfg: TrainConfig, gen: torch.Generator,
                    elo: torch.Tensor, params: Mapping[str, torch.Tensor],
                    opt_states, hyper_params: Mapping[str, torch.Tensor]):
    """Copy the best train policy's weights and optimizer state into the
    worst (by ELO; the first on ties), with each explored hyperparameter
    perturbed from the best's (pbt.py:70-107). With fewer than two train
    policies, nothing changes. Returns (params, opt_states,
    hyper_params)."""
    n = cfg.num_train_policies
    if n < 2:
        return params, opt_states, hyper_params
    best = int(torch.argmax(elo[:n]))
    worst = int(torch.argmin(elo[:n]))

    def copy_into(x):
        x = x.clone()
        x[worst] = x[best]
        return x

    params = {k: copy_into(v) for k, v in params.items()}
    opt_states = dataclasses.replace(
        opt_states, mu={k: copy_into(v) for k, v in opt_states.mu.items()},
        nu={k: copy_into(v) for k, v in opt_states.nu.items()},
        count=copy_into(opt_states.count))
    new_h = dict(hyper_params)
    for name, spec in _explored(cfg).items():
        new_h[name] = hyper_params[name].clone()
        new_h[name][worst] = perturb_param(gen, hyper_params[name][best],
                                           spec)
    return params, opt_states, new_h


def refresh_past_policies(cfg: TrainConfig, update_idx: int,
                          params: Mapping[str, torch.Tensor],
                          past_params: Mapping[str, torch.Tensor],
                          elo: torch.Tensor):
    """Snapshot the best train policy into past slot ``(update_idx //
    past_policy_update_interval) % num_past_policies``, its ELO with it
    (pbt.py:110-127). Returns (past_params, elo)."""
    pbt = cfg.pbt
    if pbt is None or pbt.num_past_policies == 0:
        return past_params, elo
    n_train = pbt.num_train_policies
    slot = (update_idx // max(pbt.past_policy_update_interval, 1)) % \
        pbt.num_past_policies
    best = int(torch.argmax(elo[:n_train]))
    new_past = {}
    for k, v in past_params.items():
        new_past[k] = v.clone()
        new_past[k][slot] = params[k][best]
    new_elo = elo.clone()
    new_elo[n_train + slot] = elo[best]
    return new_past, new_elo

"""Population-based training: hyperparameter explore/exploit and the
past-policy refresh.

Port of ``marl_hideandseek_tpu/train/pbt.py``: learning rate and entropy
coefficient (and any configured reward hyperparameter) drawn per train
policy from their ``ParamExplore`` ranges; truncation selection copies the
best train policy's weights and optimizer state into the worst, with its
hyperparameters perturbed; past policies take snapshots of the best train
policy, round robin. Every draw comes from the key passed in, in the JAX
version's key order (``prng.py``), so the same key gives JAX's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.train.cfg import ParamExplore, TrainConfig
from marl_hideandseek_torch.utils import tracing


def sample_param(key: torch.Tensor, spec: ParamExplore,
                 shape=()) -> torch.Tensor:
    """A value in the explore range around ``spec.base`` (pbt.py:20-29):
    a uniform scale in [min_scale, max_scale], log10-uniform with
    ``log10_scale``; float32 throughout, as JAX computes it."""
    u = prng.uniform(key, shape)
    if spec.log10_scale:
        f32 = dict(dtype=torch.float32, device=u.device)
        lo = torch.log10(torch.tensor(spec.min_scale, **f32))
        hi = torch.log10(torch.tensor(spec.max_scale, **f32))
        scale = torch.pow(torch.tensor(10.0, **f32), lo + u * (hi - lo))
    else:
        scale = spec.min_scale + u * (spec.max_scale - spec.min_scale)
    return spec.base * scale


def perturb_param(key: torch.Tensor, value: torch.Tensor,
                  spec: ParamExplore) -> torch.Tensor:
    """An inherited value times 1.2 or 1 / 1.2 (a fair coin,
    ``bernoulli(key)``), clamped to [base * min_scale, base * max_scale]
    (pbt.py:32-38)."""
    up = prng.bernoulli(key)
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


def init_hyper_params(cfg: TrainConfig,
                      key: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-train-policy hyperparameters ``[P]`` (pbt.py:50-67): each
    explored one drawn per policy, the others the configured scalars, on
    the key's device. ``k_lr, k_ec, *k_rw = split(key, 2 + max(R, 1))``
    for R explored reward hyperparameters."""
    n = cfg.num_train_policies
    device = key.device
    reward_specs = sorted(_reward_specs(cfg).items())
    keys = prng.split(key, 2 + max(len(reward_specs), 1))
    specs = {"lr": (cfg.lr, keys[0]),
             "entropy_coef": (cfg.algo.entropy_coef, keys[1])}
    specs.update((name, (spec, k)) for (name, spec), k in
                 zip(reward_specs, keys[2:]))
    out = {}
    for name, (v, k) in specs.items():
        out[name] = (sample_param(k, v, (n,)) if isinstance(v, ParamExplore)
                     else torch.full((n,), float(v), device=device))
    return out


def explore_exploit(cfg: TrainConfig, key: torch.Tensor,
                    elo: torch.Tensor, params: Mapping[str, torch.Tensor],
                    opt_states, hyper_params: Mapping[str, torch.Tensor]):
    """Copy the best train policy's weights and optimizer state into the
    worst (by ELO; the first on ties), with each explored hyperparameter
    perturbed from the best's (pbt.py:70-107): ``lr`` with
    ``split(key)[0]``, ``entropy_coef`` with ``split(key)[1]``, the
    reward ones with ``split(key, R + 2)[2:]``. With fewer than two train
    policies, nothing changes. Returns (params, opt_states,
    hyper_params)."""
    n = cfg.num_train_policies
    if n < 2:
        return params, opt_states, hyper_params
    with tracing.span("host_read.pbt_rank"):
        best = int(torch.argmax(elo[:n]))
    with tracing.span("host_read.pbt_rank"):
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
    k_lr, k_ec = prng.split(key)
    keys = {"lr": k_lr, "entropy_coef": k_ec}
    reward_specs = sorted(_reward_specs(cfg).items())
    if reward_specs:
        keys.update(zip((name for name, _ in reward_specs),
                        prng.split(key, len(reward_specs) + 2)[2:]))
    for name, spec in _explored(cfg).items():
        new_h[name] = hyper_params[name].clone()
        new_h[name][worst] = perturb_param(keys[name],
                                           hyper_params[name][best], spec)
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
    with tracing.span("host_read.pbt_rank"):
        best = int(torch.argmax(elo[:n_train]))
    new_past = {}
    for k, v in past_params.items():
        new_past[k] = v.clone()
        new_past[k][slot] = params[k][best]
    new_elo = elo.clone()
    new_elo[n_train + slot] = elo[best]
    return new_past, new_elo

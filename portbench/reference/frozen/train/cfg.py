# Frozen copy of marl_hideandseek_torch/train/cfg.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Training and evaluation configuration dataclasses.

Port of ``marl_hideandseek_tpu/train/cfg.py``: the action layout, the PPO
hyperparameters, the PBT setup with its explore ranges, the top-level
training config and the evaluation config. ``compute_dtype`` and
``policy_dtype`` are ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class ActionsConfig:
    """Discrete action space layout (reference: jax_train.py:146-148)."""

    actions_num_buckets: Sequence[int] = (5, 5, 5, 2, 2)


@dataclasses.dataclass(frozen=True)
class ParamExplore:
    """PBT hyperparameter perturbation range
    (reference: jax_train.py:124-137)."""

    base: float
    min_scale: float = 0.1
    max_scale: float = 10.0
    log10_scale: bool = False
    clip_perturb: bool = False


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (reference: jax_train.py:154-162)."""

    num_mini_batches: int = 1
    clip_coef: float = 0.2
    value_loss_coef: float = 1.0
    entropy_coef: Union[float, ParamExplore] = 0.01
    max_grad_norm: float = 5.0
    num_epochs: int = 2
    clip_value_loss: bool = False
    huber_value_loss: bool = False


@dataclasses.dataclass(frozen=True)
class PBTConfig:
    """Population-based training setup (reference: jax_train.py:100-112)."""

    num_teams: int = 2
    team_size: int = 3
    num_train_policies: int = 1
    num_past_policies: int = 0
    self_play_portion: float = 0.0
    cross_play_portion: float = 0.0
    past_play_portion: float = 1.0
    # How often (in updates) past policies are refreshed from train policies
    # and hyperparameters are explored/exploited.
    past_policy_update_interval: int = 500
    explore_interval: int = 500
    reward_hyper_params_explore: Mapping[str, ParamExplore] = \
        dataclasses.field(default_factory=dict)

    @property
    def total_policies(self) -> int:
        return self.num_train_policies + self.num_past_policies


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level training config (reference: jax_train.py:142-169)."""

    num_worlds: int
    num_agents_per_world: int
    num_updates: int
    actions: ActionsConfig
    steps_per_update: int = 40
    num_bptt_chunks: int = 4
    lr: Union[float, ParamExplore] = 1e-4
    gamma: float = 0.998
    gae_lambda: float = 0.95
    algo: PPOConfig = PPOConfig()
    pbt: Optional[PBTConfig] = None
    dreamer_v3_critic: bool = True
    value_normalizer_decay: float = 0.999
    compute_dtype: torch.dtype = torch.float32
    seed: int = 5
    metrics_buffer_size: int = 10
    # Grouped PPO: gather each train policy's agents before the epoch
    # loop instead of masking the full batch per policy, which halves the
    # learner's work under past-play PBT. Valid only when the trainable
    # slot count is N/2: symmetric fixed teams, past_play_portion 1.0
    # (ppo.py::use_grouped_ppo).
    ppo_group_trainable: bool = False

    def __post_init__(self):
        if self.steps_per_update % self.num_bptt_chunks != 0:
            raise ValueError("steps_per_update must divide into "
                             "num_bptt_chunks")

    @property
    def num_train_policies(self) -> int:
        return self.pbt.num_train_policies if self.pbt else 1

    @property
    def total_policies(self) -> int:
        return self.pbt.total_policies if self.pbt else 1


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation run config (reference: jax_infer.py:155-164)."""

    num_worlds: int
    num_teams: int
    team_size: int
    num_eval_steps: int
    actions: ActionsConfig
    policy_dtype: torch.dtype = torch.float32
    eval_competitive: bool = True
    use_deterministic_policy: bool = False

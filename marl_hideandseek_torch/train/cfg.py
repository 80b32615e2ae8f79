"""Evaluation configuration dataclasses: the part of
``marl_hideandseek_tpu/train/cfg.py`` that inference and evaluation use
(``ActionsConfig``, ``EvalConfig``)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ActionsConfig:
    """Discrete action space layout (reference: jax_train.py:146-148)."""

    actions_num_buckets: Sequence[int] = (5, 5, 5, 2, 2)


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

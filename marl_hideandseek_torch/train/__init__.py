"""Evaluation and the policy-ensemble forward of the PyTorch port: the
configs, ELO tracking, ``eval_load_ckpt`` and ``eval_policies`` of
``marl_hideandseek_tpu.train``. PPO, PBT and the training manager come
with the training slice.
"""

from marl_hideandseek_torch.train.cfg import ActionsConfig, EvalConfig
from marl_hideandseek_torch.train.elo import print_elos
from marl_hideandseek_torch.train.evaluate import (
    eval_load_ckpt,
    eval_policies,
)

__all__ = ["ActionsConfig", "EvalConfig", "print_elos", "eval_policies",
           "eval_load_ckpt"]

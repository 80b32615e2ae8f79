"""Training library of the PyTorch port: recurrent PPO with BPTT, PBT and
ELO on the packed env, and policy evaluation.

Port of ``marl_hideandseek_tpu.train``: rollout collection through the
policy ensemble, the PPO update with a per-policy Adam, PBT, the training
manager with its ``torch.save`` checkpoints, ELO evaluation, and the
metric writers. ``aot_compile`` and ``cfg_jax_mem`` configure XLA and
have no counterpart here.
"""

from marl_hideandseek_torch.train.cfg import (
    ActionsConfig,
    EvalConfig,
    PBTConfig,
    ParamExplore,
    PPOConfig,
    TrainConfig,
)
from marl_hideandseek_torch.train.manager import (
    TrainHooks,
    TrainingManager,
    init_training,
    ring_scalar,
    stop_training,
)
from marl_hideandseek_torch.train.elo import eval_elo, print_elos
from marl_hideandseek_torch.train.evaluate import (
    eval_load_ckpt,
    eval_policies,
)
from marl_hideandseek_torch.train.metrics import (
    TensorboardWriter,
    WandbWriter,
)

__all__ = [
    "ActionsConfig", "TrainConfig", "PPOConfig", "PBTConfig", "ParamExplore",
    "EvalConfig", "TrainHooks", "TrainingManager", "init_training",
    "stop_training", "ring_scalar", "eval_elo", "print_elos",
    "eval_policies", "eval_load_ckpt", "TensorboardWriter", "WandbWriter",
]

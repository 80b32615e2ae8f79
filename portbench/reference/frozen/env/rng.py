# Frozen copy of marl_hideandseek_torch/env/rng.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Episode keys: each world's episode draws come from its own key.

A world's episode key is ``fold_in(fold_in(base_key, world_id),
episode_counter)`` (the JAX package's env.py:262-263), with JAX's
threefry (``prng.py``): the same base key, id and counter give JAX's key
words, whatever batch or reset branch draws the world, and shards with
disjoint world ids draw disjoint episodes.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen import prng


def episode_keys(base_key: torch.Tensor, world_ids: torch.Tensor,
                 episode_counter: torch.Tensor) -> torch.Tensor:
    """``[k, 2]`` u32 episode keys of worlds ``world_ids [k]`` at
    episode ``episode_counter [k]``, from one base key ``[2]``."""
    return prng.fold_in(prng.fold_in(base_key, world_ids), episode_counter)

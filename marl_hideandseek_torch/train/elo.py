"""ELO tracking for policy populations.

Port of ``marl_hideandseek_tpu/train/elo.py``: a bounded per-pair ELO
update from batches of finished matches, the conversion of episode results
into matches, and ``eval_elo``, the module-level spelling of
``TrainingManager.eval_elo``.
"""

from __future__ import annotations

import numpy as np
import torch

from marl_hideandseek_torch.parallel.mesh import LOCAL, Mesh

ELO_K = 16.0
ELO_START = 1500.0


def elo_expected(elo_a, elo_b):
    return 1.0 / (1.0 + torch.pow(10.0, (elo_b - elo_a) / 400.0))


def update_elo_pairwise(elo: torch.Tensor, idx_a: torch.Tensor,
                        idx_b: torch.Tensor, score_a: torch.Tensor,
                        valid: torch.Tensor,
                        mesh: Mesh = LOCAL) -> torch.Tensor:
    """Batched ELO update from match results (elo.py:22-57).

    elo ``[P]``; idx_a / idx_b ``[M]`` policy indices; score_a ``[M]`` in
    {0, 0.5, 1}; valid ``[M]`` bool. Matches are aggregated into one
    average score per ordered pair, each pair moves the ratings by at most
    one K-scaled step per call, and the population mean is re-anchored at
    ELO_START. Self-play matches carry no information and are dropped.
    Over ``mesh`` the matches are this rank's, and the pairs' score sums
    and counts are summed over the ranks (whole numbers and halves: exact
    in any order).
    """
    p = elo.shape[0]
    v = (valid & (idx_a != idx_b)).to(torch.float32)
    # Invalid rows (possibly policy -1) add zero at pair 0, where JAX's
    # one-hot of an out-of-range pair is all zero.
    pair = torch.where(v > 0, idx_a * p + idx_b, 0).to(torch.long)
    score_sum = torch.zeros(p * p, device=elo.device).index_add_(
        0, pair, score_a.to(torch.float32) * v)
    count = torch.zeros(p * p, device=elo.device).index_add_(0, pair, v)
    score_sum, count = mesh.all_sum_many([score_sum, count])
    avg_score = score_sum / torch.clamp(count, min=1.0)
    have = (count > 0.0).to(torch.float32)
    exp_a = elo_expected(elo[:, None], elo[None, :])          # [P, P]
    d = ELO_K * (avg_score.reshape(p, p) - exp_a) * have.reshape(p, p)
    new_elo = elo + (d.sum(1) - d.sum(0))
    return new_elo - new_elo.mean() + ELO_START


def matches_from_episode_results(episode_results: torch.Tensor,
                                 team_policies: torch.Tensor,
                                 dones_w: torch.Tensor):
    """Finished-episode scores -> (idx_a, idx_b, score_a, valid).

    episode_results ``[.., W, 2]`` scores per team slot; team_policies
    ``[.., W, 2]`` policy of each team slot (-1: none); dones_w ``[.., W]``
    bool, the worlds that finished this step."""
    flat_res = episode_results.reshape(-1, 2)
    flat_pol = team_policies.reshape(-1, 2)
    valid = dones_w.reshape(-1) & (flat_pol[:, 0] >= 0) & \
        (flat_pol[:, 1] >= 0)
    return flat_pol[:, 0], flat_pol[:, 1], flat_res[:, 0], valid


def eval_elo(training_mgr):
    """A dedicated ELO evaluation pass of the training population
    (reference: madrona_learn.eval_elo, jax_train.py:243-244)."""
    return training_mgr.eval_elo()


def print_elos(elos) -> None:
    """Pretty printer (reference: scripts/common.py:1-16)."""
    elos = np.asarray(torch.as_tensor(elos).cpu())
    order = np.argsort(elos)[::-1]
    print("ELOs:")
    for rank, idx in enumerate(order):
        print(f"  #{rank + 1}  policy {idx}: {elos[idx]:.1f}")

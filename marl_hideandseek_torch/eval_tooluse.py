"""Tool-use evaluation of training checkpoints: the fort-building signal
(port of scripts/eval_tooluse.py).

    python -m marl_hideandseek_torch.eval_tooluse CKPT_DIR STEP [STEP ...]
        [--num-worlds 128] [--num-steps 480] [--num-hiders 2]
        [--num-seekers 2] [--device cuda|cpu]

For each training checkpoint ``<CKPT_DIR>/<STEP>.pt`` (``python -m
marl_hideandseek_torch.train``'s), its train policies play in self-play
teams on the packed env (``RandomFlipTeams | UseFixedWorld |
ZeroAgentVelocity``, seed 5, bf16 policy), and the run reports, over the
world-steps of the seek phase, the fraction of worlds with at least one
locked box, locked ramp or active grab, with a ramp moved more than 0.5
from its episode spawn (ramp-move), and with the hiders hidden. The six
counts (``tooluse_stats``) add up on the device and are read once at the
end.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, NUM_PREP_STEPS, SimFlags
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.models import DiscreteActionDistributions
from marl_hideandseek_torch.policy import make_policy
from marl_hideandseek_torch.train.evaluate import eval_load_ckpt
from marl_hideandseek_torch.train.rollout import apply_ensemble
from marl_hideandseek_torch.types import AGENT_HIDER, body_slot_ranges

BUCKETS = (5, 5, 5, 2, 2)
STAT_NAMES = ("seek_steps", "lock", "grab", "hidden", "ramp_lock",
              "ramp_move")


def tooluse_stats(cfg: EnvConfig, ps, team_reward, pre_step, spawn_ramp_xy):
    """One step's six counts (scripts/eval_tooluse.py:82-110), from packed
    state ``ps`` after the step, its hider-team reward ``[W]`` and the
    step counters before it: seek-phase worlds, and of those the worlds
    with a locked box, an active grab, hidden hiders, a locked ramp and a
    ramp moved more than 0.5 from ``spawn_ramp_xy [R, 2, W]`` (not counted
    on a world's reset step, whose positions are the new episode's).
    Returns (counts ``[6]`` int64, the spawn positions re-based on the
    worlds that start a fresh episode)."""
    (box_lo, box_hi), (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)
    b = ps.bodies
    in_seek = pre_step >= NUM_PREP_STEPS - 1
    locked_w = b.locked[box_lo:box_hi].any(0)
    ramp_locked_w = b.locked[ramp_lo:ramp_hi].any(0)
    ramp_xy = b.pos[ramp_lo:ramp_hi, :2]                    # [R, 2, W]
    ramp_moved_w = ((torch.linalg.vector_norm(ramp_xy - spawn_ramp_xy,
                                              dim=1) > 0.5) &
                    b.active[ramp_lo:ramp_hi]).any(0)
    grab_w = (ps.grab.target >= 0).any(0)
    hidden_w = team_reward > 0.0
    fresh = ps.step == 0
    counts = torch.stack([
        in_seek.sum(),
        (locked_w & in_seek).sum(),
        (grab_w & in_seek).sum(),
        (hidden_w & in_seek).sum(),
        (ramp_locked_w & in_seek).sum(),
        (ramp_moved_w & in_seek & ~fresh).sum()])
    spawn = torch.where(fresh[None, None, :], ramp_xy, spawn_ramp_xy)
    return counts, spawn


def eval_ckpt(ckpt_path: str, num_worlds: int, num_steps: int,
              num_hiders: int = 2, num_seekers: int = 2,
              device="cuda") -> dict:
    """The tool-use fractions of one training checkpoint (a file of
    ``TrainingManager.save_ckpt``): ``num_steps`` stochastic steps from
    ``init(PRNGKey(7))``, step ``i``'s actions sampled with ``key, sub =
    split(key)`` from ``PRNGKey(11)``; hiders play policy ``w % P``,
    seekers ``(w + 1) % P`` of the P train policies."""
    cfg = EnvConfig(
        num_worlds=num_worlds,
        min_hiders=num_hiders, max_hiders=num_hiders,
        min_seekers=num_seekers, max_seekers=num_seekers,
        sim_flags=(SimFlags.RandomFlipTeams | SimFlags.UseFixedWorld |
                   SimFlags.ZeroAgentVelocity), rand_seed=5)
    env = PackedEnv(cfg, device=device)
    dev = env.device
    policy = make_policy(dtype=torch.bfloat16, action_buckets=BUCKETS,
                         device=dev)
    params, obs_stats, _ = eval_load_ckpt(policy, ckpt_path, train_only=True,
                                          device=dev)
    n_pol = next(iter(params.values())).shape[0]
    norm, ac = policy.obs_preprocess, policy.actor_critic
    n_agents = num_worlds * cfg.max_agents
    _, (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)

    def flat(o):
        return {k: v.reshape((n_agents,) + v.shape[2:])
                for k, v in norm.prep(o).items()}

    w_idx = torch.arange(num_worlds, device=dev)
    t0, t1 = w_idx % n_pol, (w_idx + 1) % n_pol
    tot = torch.zeros(6, dtype=torch.long, device=dev)
    with torch.no_grad():
        ps, result = env.init(prng.key(7, dev))
        obs = flat(result.obs)
        rnn = ac.init_recurrent_state(n_agents, dev)
        key = prng.key(11, dev)
        spawn = ps.bodies.pos[ramp_lo:ramp_hi, :2]
        for _ in range(num_steps):
            key, sub = prng.split(key).unbind(0)
            is_h = (ps.agent_type == AGENT_HIDER).T              # [W, A]
            assigns = torch.where(is_h, t0[:, None], t1[:, None]).reshape(-1)
            logits, _, new_rnn = apply_ensemble(
                policy, params, rnn, norm.normalize(obs_stats, obs), assigns,
                n_pol)
            actions = DiscreteActionDistributions(BUCKETS, logits).sample(sub)
            pre_step = ps.step
            ps, result = env.step(
                ps, actions.reshape(num_worlds, cfg.max_agents,
                                    -1).permute(1, 2, 0))
            dones = result.dones.T.reshape(-1).to(torch.bool)
            rnn = ac.clear_recurrent_state(new_rnn, dones)
            obs = flat(result.obs)
            counts, spawn = tooluse_stats(cfg, ps, result.team_reward,
                                          pre_step, spawn)
            tot += counts
    tot = tot.tolist()
    seek = max(tot[0], 1)
    out = {"seek_steps": int(tot[0])}
    out.update({f"{k}_frac": tot[j] / seek
                for j, k in enumerate(STAT_NAMES) if j})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir")
    p.add_argument("steps", nargs="+", type=int)
    p.add_argument("--num-worlds", type=int, default=128)
    p.add_argument("--num-steps", type=int, default=480)
    p.add_argument("--num-hiders", type=int, default=2)
    p.add_argument("--num-seekers", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for s in args.steps:
        r = eval_ckpt(os.path.join(args.ckpt_dir, f"{s}.pt"),
                      args.num_worlds, args.num_steps, args.num_hiders,
                      args.num_seekers, args.device)
        print(f"ckpt {s}: lock {r['lock_frac'] * 100:.1f}%  "
              f"grab {r['grab_frac'] * 100:.1f}%  "
              f"hidden {r['hidden_frac'] * 100:.1f}%  "
              f"ramp_lock {r['ramp_lock_frac'] * 100:.1f}%  "
              f"ramp_move {r['ramp_move_frac'] * 100:.1f}%  "
              f"({r['seek_steps']} seek world-steps)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

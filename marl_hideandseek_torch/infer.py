"""Inference entry point: a policy checkpoint's policies act in the packed
env (port of scripts/infer.py).

    python -m marl_hideandseek_torch.infer --ckpt-path FILE
        [--num-worlds 16] [--num-steps 3600] [--num-hiders 3]
        [--num-seekers 3] [--record-log PATH] [--deterministic]
        [--single-policy K] [--train-only] [--bf16] [--print-obs]
        [--backbone pooled|attention|hash|openai_hns|impala_cnn]
        [--device cuda|cpu]

Loads a checkpoint written by ``bridge.save_policy_checkpoint`` (any
ensemble size; a JAX orbax checkpoint converts to one, README.md), runs
episodes on a fixed world (``UseFixedWorld | ZeroAgentVelocity``, seed
5) with round-robin team-against-team matchups, and prints the episode
scores, the wins per team slot and the policies' ELOs. The loop is
``run_inference``. With ``--record-log`` every step's worlds are written
to a checkpoint record log (``utils/ckptlog.py``), frame ``i`` the
checkpoint record of the state after step ``i``
(``env/checkpoint.py::record_frame``), which ``replay`` and ``replay3d``
render. infer.sh's arguments run as written. ``--backbone`` names the
checkpoint's policy; ``openai_hns`` acts with the env's force-based
movement (``UseFixedWorld`` alone); ``impala_cnn`` acts from each agent's
64x64 RGBD view, which the env renders every step
(``EnvConfig.render_frames``), with its previous action and reward.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Callable, Optional

import numpy as np
import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.checkpoint import record_frame
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.models import DiscreteActionDistributions, Policy
from marl_hideandseek_torch.policy import (
    BACKBONES,
    backbone_recipe,
    make_policy,
)
from marl_hideandseek_torch.train.elo import print_elos
from marl_hideandseek_torch.train.evaluate import eval_load_ckpt
from marl_hideandseek_torch.train.rollout import (
    apply_ensemble,
    core_inputs,
    initial_core_inputs,
)
from marl_hideandseek_torch.types import AGENT_HIDER, EnvState
from marl_hideandseek_torch.utils import tracing
from marl_hideandseek_torch.utils.ckptlog import CkptLogWriter


def run_inference(env: PackedEnv, policy: Policy, params, obs_stats,
                  num_steps: int, *, deterministic: bool = False,
                  iter_cb: Optional[Callable] = None,
                  state_cb: Optional[Callable[[int, EnvState], None]] = None,
                  timing: bool = False) -> dict:
    """``num_steps`` steps of the packed env from ``env.init(PRNGKey(7))``,
    the policies' actions from ``apply_ensemble`` (``best()`` when
    ``deterministic``, else sampled with step ``i``'s key: ``key, sub =
    split(key)`` from ``PRNGKey(7)``, as scripts/infer.py:123-131 draws
    them). Matchups are round robin over the policy axis and
    keyed by team membership at each step: a world's hiders play
    ``t0``, its seekers ``t1``. Recurrent state is cleared for agents
    whose episode ended. A policy with ``core_inputs`` gets each step's
    actions and rewards as the next step's observations
    (``train/rollout.py::core_inputs``).

    ``iter_cb(step_data)`` gets, per step: the forward's inputs (``obs``,
    prepped but not normalized, ``rnn``, ``assignments``), its outputs
    (``logits``, ``values``), the ``actions``, the recurrent state after
    the clear (``rnn_next``), the per-world ``dones`` and the env's
    ``result``. ``state_cb(i, env_state)`` gets the packed state after
    step ``i`` (the record log's hook). With ``timing``, the loop runs in
    a ``tracing.recording()`` of its own: each step's forward (normalize,
    ensemble, action draw) is the span ``serve.forward``, its env step
    ``env.step``.

    Returns the wins per team slot ``[2]``, the episodes finished, and
    with ``timing`` the mean forward and env-step milliseconds of those
    spans (the device clock's on CUDA, the host's on the CPU)."""
    cfg = env.cfg
    w, a = cfg.num_worlds, cfg.max_agents
    n = w * a
    dev = env.device
    norm = policy.obs_preprocess
    ac = policy.actor_critic
    buckets = ac.actor.buckets
    n_pol = next(iter(params.values())).shape[0]
    w_idx = torch.arange(w, device=dev)
    t0 = w_idx % n_pol
    t1 = (w_idx + 1 + w_idx // n_pol) % n_pol

    def flat(o):
        return {k: v.reshape((n,) + v.shape[2:])
                for k, v in norm.prep(o).items()}

    wins = torch.zeros(2, device=dev)
    finished = torch.zeros((), dtype=torch.long, device=dev)
    scope = tracing.recording() if timing else contextlib.nullcontext()
    with torch.no_grad(), scope as spans:
        key = prng.key(7, dev)
        env_state, result = env.init(prng.key(7, dev))
        obs = flat(result.obs)
        if policy.core_inputs:
            obs.update(initial_core_inputs(n, buckets, dev))
        rnn = ac.init_recurrent_state(n, dev)
        for i in range(num_steps):
            with tracing.span("serve.forward"):
                normalized = norm.normalize(obs_stats, obs)
                is_h = (env_state.agent_type == AGENT_HIDER).T   # [W, A]
                assignments = torch.where(is_h, t0[:, None],
                                          t1[:, None]).reshape(-1)
                logits, values, new_rnn = apply_ensemble(
                    policy, params, rnn, normalized, assignments, n_pol)
                dists = DiscreteActionDistributions(buckets, logits)
                if deterministic:
                    actions = dists.best()
                else:
                    key, sub = prng.split(key).unbind(0)
                    actions = dists.sample(sub)
            env_state, result = env.step(
                env_state, actions.reshape(w, a, -1).permute(1, 2, 0))
            dones = result.dones.T.reshape(-1).to(torch.bool)
            rnn_next = ac.clear_recurrent_state(new_rnn, dones)
            dones_w = result.dones[0].to(torch.bool)              # [W]
            wins += (result.episode_results.T * dones_w[:, None]).sum(0)
            finished += dones_w.sum()
            if iter_cb is not None:
                iter_cb({"step": i, "obs": obs, "rnn": rnn,
                         "assignments": assignments, "logits": logits,
                         "values": values, "actions": actions,
                         "rnn_next": rnn_next, "dones": dones_w,
                         "result": result})
            if state_cb is not None:
                state_cb(i, env_state)
            obs, rnn = flat(result.obs), rnn_next
            if policy.core_inputs:
                obs.update(core_inputs(actions, result.rewards.T.reshape(-1),
                                       dones, buckets))
        with tracing.span("host_read.episodes_finished"):
            out = {"wins": wins, "episodes_finished": int(finished)}
    if timing:
        taken = spans.take().spans
        for name, k in (("serve.forward", "forward_ms"),
                        ("env.step", "env_ms")):
            out[k] = float(np.mean([
                s.host_ms if s.device_ms is None else s.device_ms
                for s in taken if s.name == name and s.parent is None]))
    return out


class RecordLog:
    """``state_cb`` of ``run_inference`` that appends each step's
    checkpoint record to a record log at ``path``, opened at the first
    frame (a run of no steps writes no file): the record is computed on
    the env's device and copied to the host. (A pinned copy written a
    step later measured the same on the card: the cost is dispatching the
    record's ops, not waiting for the copy.)"""

    def __init__(self, cfg: EnvConfig, path: str):
        self.cfg = cfg
        self.path = path
        self.writer: Optional[CkptLogWriter] = None
        self.frames = 0

    def __call__(self, step: int, env_state: EnvState) -> None:
        frame = record_frame(self.cfg, env_state).cpu()
        if self.writer is None:
            self.writer = CkptLogWriter(self.path, *frame.shape)
        self.writer.append(frame)
        self.frames += 1

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt-path", type=str, required=True)
    p.add_argument("--num-worlds", type=int, default=16)
    p.add_argument("--num-steps", type=int, default=3600)
    p.add_argument("--num-hiders", type=int, default=3)
    p.add_argument("--num-seekers", type=int, default=3)
    p.add_argument("--record-log", type=str, default=None,
                   help="write every step's checkpoint records to this "
                        "record log")
    p.add_argument("--print-obs", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--single-policy", type=int, default=None,
                   help="evaluate one policy against itself")
    p.add_argument("--train-only", action="store_true",
                   help="drop past policies from the eval population")
    p.add_argument("--backbone", type=str, default="pooled",
                   choices=BACKBONES)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def infer_config(args) -> EnvConfig:
    """The env configuration of ``main``'s arguments: a fixed world,
    ``UseFixedWorld | ZeroAgentVelocity`` (``UseFixedWorld`` alone for
    ``--backbone openai_hns``, whose actions are forces), seed 5; frames
    rendered for ``--backbone impala_cnn``."""
    recipe = backbone_recipe(args.backbone)
    flags = SimFlags.UseFixedWorld
    if recipe.instant_velocity:
        flags |= SimFlags.ZeroAgentVelocity
    return EnvConfig(
        num_worlds=args.num_worlds,
        min_hiders=args.num_hiders, max_hiders=args.num_hiders,
        min_seekers=args.num_seekers, max_seekers=args.num_seekers,
        sim_flags=flags,
        rand_seed=5,
        render_frames=recipe.frames,
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = infer_config(args)
    env = PackedEnv(cfg, device=args.device)
    policy = make_policy(dtype=dtype, backbone=args.backbone,
                         device=env.device)
    params, obs_stats, elo = eval_load_ckpt(
        policy, args.ckpt_path, single_policy=args.single_policy,
        train_only=args.train_only, device=env.device)

    def report(d):
        dones = d["dones"].cpu().numpy()
        if dones.any():
            scores = d["result"].episode_results.T.cpu().numpy()
            print(f"step {d['step']}: episode scores {scores[dones]}")
        if args.print_obs:
            print({k: v[0, 0].cpu().numpy()
                   for k, v in d["result"].obs.items()})

    record = RecordLog(cfg, args.record_log) if args.record_log else None
    try:
        out = run_inference(env, policy, params, obs_stats, args.num_steps,
                            deterministic=args.deterministic, iter_cb=report,
                            state_cb=record)
    finally:
        if record is not None:
            record.close()
    print(f"total wins by team slot: {out['wins'].cpu().numpy()}")
    print_elos(elo)
    if record is not None and record.writer is not None:
        print(f"checkpoint record log -> {args.record_log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

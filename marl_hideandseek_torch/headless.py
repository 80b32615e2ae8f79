"""Headless soak runner of the classic env (port of scripts/headless.py;
reference: src/headless.cpp).

    python -m marl_hideandseek_torch.headless NUM_WORLDS NUM_STEPS
        [--rand-actions] [--record actions.npy] [--level N]
        [--device cuda|cpu]

Runs the reference's fixed configuration - 3 hiders, 2 seekers,
``SimFlags.Default``, seed 5 (headless.cpp:38-44) - on ``HideAndSeekEnv``,
with random or neutral actions, optionally after resetting every world to
debug level N (2-8). Raises if a reward or a state value turns NaN or
infinite (``act_hit_t`` is +inf on a ray miss), and prints the rate in
steps x worlds / s with the device it was measured on: the card's name
and power limit, as ``nvidia-smi`` reports them, on CUDA. With
``--record`` the actions are saved as one ``[steps, W, A, 5]`` int32
array (``np.save``, scripts/headless.py's layout), copied to the host
only then.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time

import numpy as np
import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from marl_hideandseek_torch.env.packed import DEFAULT_BUCKETS, INSTANT_BUCKETS


def device_line(device: torch.device) -> str:
    """The device a rate was measured on."""
    if device.type != "cuda":
        return "cpu (plain PyTorch path)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def check_finite(state, result, where: str) -> None:
    if not bool(torch.isfinite(result.rewards).all()):
        raise RuntimeError(f"NaN/Inf in rewards at {where}")
    for t in state.leaves():
        if t.is_floating_point() and bool(
                (~(torch.isfinite(t) | (t == math.inf))).any()):
            raise RuntimeError(f"NaN/-Inf in the state at {where}")


def headless_config(num_worlds: int) -> EnvConfig:
    """The reference's fixed configuration (headless.cpp:38-44)."""
    return EnvConfig(num_worlds=num_worlds, min_hiders=3, max_hiders=3,
                     min_seekers=2, max_seekers=2,
                     sim_flags=SimFlags.Default, rand_seed=5)


def soak(env: HideAndSeekEnv, num_steps: int, rand_actions: bool,
         level: int = 1, record: bool = False):
    """``env.init(PRNGKey(5))``, a reset of every world to ``level`` unless
    it is 1, then ``num_steps`` steps of random actions (step ``i``'s from
    ``fold_in(PRNGKey(5), i)``, scripts/headless.py:62-66) or neutral ones.
    Returns (state, result, seconds of the steps, the ``[steps, W, A, 5]``
    int32 actions on the host when ``record``, else None)."""
    cfg, dev = env.cfg, env.device
    w, na = cfg.num_worlds, cfg.max_agents
    n_move = INSTANT_BUCKETS if cfg.zero_agent_velocity else DEFAULT_BUCKETS
    neutral = torch.full((w, na, 5), n_move // 2, dtype=torch.int32,
                         device=dev)
    neutral[..., 3:] = 0
    key = prng.key(5, dev)
    state, result = env.init(key)
    if level != 1:
        resets = torch.full((w,), level, dtype=torch.int32, device=dev)
        state, result = env.step(state, neutral, resets)

    recorded = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    start = time.perf_counter()
    for i in range(num_steps):
        if rand_actions:
            k1, k2 = prng.split(prng.fold_in(key, i)).unbind(0)
            actions = torch.cat([prng.randint(k1, (w, na, 3), 0, n_move),
                                 prng.randint(k2, (w, na, 2), 0, 2)], dim=-1)
        else:
            actions = neutral
        if record:
            recorded.append(actions.to(torch.int32).cpu())
        state, result = env.step(state, actions)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - start
    actions = (torch.stack(recorded).numpy() if recorded else
               np.zeros((0, w, na, 5), np.int32)) if record else None
    return state, result, elapsed, actions


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("num_worlds", type=int)
    p.add_argument("num_steps", type=int)
    p.add_argument("--rand-actions", action="store_true")
    p.add_argument("--record", type=str, default=None,
                   help="save the actions to this .npy file")
    p.add_argument("--level", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    env = HideAndSeekEnv(headless_config(args.num_worlds), device=dev)
    state, result, elapsed, actions = soak(
        env, args.num_steps, args.rand_actions, args.level,
        record=args.record is not None)
    w = env.cfg.num_worlds
    check_finite(state, result, f"step {args.num_steps}")
    print(f"FPS: {args.num_steps * w / elapsed:.0f} steps x worlds / s "
          f"({args.num_steps} steps x {w} worlds in {elapsed:.3f} s) on "
          f"{device_line(dev)}")
    if args.record is not None:
        np.save(args.record, actions)
        print(f"recorded actions -> {args.record}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

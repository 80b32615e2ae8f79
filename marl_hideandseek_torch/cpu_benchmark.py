"""The classic env's plain PyTorch path on the host CPU, in env-steps/s
(port of scripts/cpu_benchmark.py).

    python -m marl_hideandseek_torch.cpu_benchmark [NUM_WORLDS [NUM_STEPS
        [H [S]]]]

Defaults: 2,000 worlds x 1,920 steps, 2 hiders and 2 seekers
(``ZeroAgentVelocity | RandomFlipTeams``, seed 10), random actions drawn
from ``fold_in(PRNGKey(10), step)`` as the JAX script draws them, in
chunks of 20 steps after one warm-up chunk. The one entry point whose
purpose is the CPU: it runs on ``torch.device("cpu")`` and prints the rate
as the host CPU's, with its model name.
"""

from __future__ import annotations

import platform
import sys
import time

import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.env import HideAndSeekEnv

CHUNK = 20


def cpu_name() -> str:
    """The host CPU's model name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def bench_actions(key, step: int, num_worlds: int, num_agents: int):
    """Step ``step``'s ``[W, A, 5]`` random actions: ``k1, k2 =
    split(fold_in(key, step))``, moves from ``k1`` in [0, 5), grab and
    lock from ``k2`` in [0, 2)."""
    k1, k2 = prng.split(prng.fold_in(key, step)).unbind(0)
    return torch.cat([prng.randint(k1, (num_worlds, num_agents, 3), 0, 5),
                      prng.randint(k2, (num_worlds, num_agents, 2), 0, 2)],
                     dim=-1)


def run(num_worlds: int, num_steps: int, num_hiders: int = 2,
        num_seekers: int = 2) -> dict:
    """Steps of the plain path on the CPU; returns the rate and what it
    counted."""
    cfg = EnvConfig(
        num_worlds=num_worlds,
        min_hiders=num_hiders, max_hiders=num_hiders,
        min_seekers=num_seekers, max_seekers=num_seekers,
        sim_flags=SimFlags.ZeroAgentVelocity | SimFlags.RandomFlipTeams,
        rand_seed=10)
    env = HideAndSeekEnv(cfg, device=torch.device("cpu"))
    key = prng.key(cfg.rand_seed)
    state, _ = env.init(key)

    def chunk(state, base):
        for i in range(CHUNK):
            state, _ = env.step(state, bench_actions(
                key, base + i, num_worlds, cfg.max_agents))
        return state

    state = chunk(state, 0)
    n_chunks = max(num_steps // CHUNK, 1)
    start = time.perf_counter()
    for c in range(n_chunks):
        state = chunk(state, (c + 1) * CHUNK)
    elapsed = time.perf_counter() - start
    steps = n_chunks * CHUNK
    return {"fps": steps * num_worlds / elapsed, "steps": steps,
            "elapsed": elapsed, "state": state}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    num_worlds = int(argv[0]) if len(argv) > 0 else 2000
    num_steps = int(argv[1]) if len(argv) > 1 else 1920
    num_hiders = int(argv[2]) if len(argv) > 2 else 2
    num_seekers = int(argv[3]) if len(argv) > 3 else 2
    r = run(num_worlds, num_steps, num_hiders, num_seekers)
    print(f"FPS: {r['fps']:.0f} env-steps/s on the host CPU ({cpu_name()}, "
          f"{torch.get_num_threads()} threads, plain PyTorch path; "
          f"worlds={num_worlds} steps={r['steps']} "
          f"elapsed={r['elapsed']:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

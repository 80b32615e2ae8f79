"""Replay a checkpoint record log as top-down PNG frames (port of
scripts/replay.py).

    python -m marl_hideandseek_torch.replay LOG [--out replay_frames]
        [--world 0] [--every 5] [--num-hiders 3] [--num-seekers 3]
        [--device cuda|cpu]

Reads a record log (``infer --record-log``, or the JAX package's), restores
every ``every``-th frame through ``unpack_checkpoints`` and
``HideAndSeekEnv.load_checkpoints`` (the level regenerated from the
stored keys, on the K1 raycast on the card) and writes
``frame_<i>.png`` of world ``world``: the top-down view of
``viz/render2d.py``, rasterized without matplotlib. The team sizes must
be the log's: a record of another size raises.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterator, Tuple

import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.checkpoint import unpack_checkpoints
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from marl_hideandseek_torch.types import EnvState
from marl_hideandseek_torch.utils.ckptlog import CkptLogReader
from marl_hideandseek_torch.viz.render2d import rasterize_world, write_png


def replay_env(reader: CkptLogReader, num_hiders: int, num_seekers: int,
               device) -> HideAndSeekEnv:
    """The classic env a log's frames load into (scripts/replay.py:53-58):
    the log's world count, the given teams, ``ZeroAgentVelocity``."""
    return HideAndSeekEnv(EnvConfig(
        num_worlds=reader.num_worlds,
        min_hiders=num_hiders, max_hiders=num_hiders,
        min_seekers=num_seekers, max_seekers=num_seekers,
        sim_flags=SimFlags.ZeroAgentVelocity), device=device)


def replay_states(reader: CkptLogReader, env: HideAndSeekEnv,
                  every: int) -> Iterator[Tuple[int, EnvState]]:
    """(frame index, world-major state) of every ``every``-th frame: each
    loaded over ``env.init(PRNGKey(0))``'s state in every world."""
    dev = env.device
    state, _ = env.init(prng.key(0, dev))
    load_all = torch.ones(env.cfg.num_worlds, dtype=torch.int32, device=dev)
    for i in range(0, reader.num_frames, every):
        blob = torch.from_numpy(reader.read(i).copy()).to(dev)
        ckpt = unpack_checkpoints(env.cfg, blob)
        loaded, _ = env.load_checkpoints(state, ckpt, load_all)
        yield i, loaded


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("log")
    p.add_argument("--out", type=str, default="replay_frames")
    p.add_argument("--world", type=int, default=0)
    p.add_argument("--every", type=int, default=5)
    p.add_argument("--num-hiders", type=int, default=3)
    p.add_argument("--num-seekers", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    with CkptLogReader(args.log) as reader:
        env = replay_env(reader, args.num_hiders, args.num_seekers,
                         args.device)
        os.makedirs(args.out, exist_ok=True)
        n = 0
        for i, state in replay_states(reader, env, args.every):
            write_png(os.path.join(args.out, f"frame_{i:06d}.png"),
                      rasterize_world(env.cfg, state, args.world))
            n += 1
    print(f"wrote {n} frames to {args.out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Console viewer: drive an agent and watch its world (port of
scripts/viewer.py).

    python -m marl_hideandseek_torch.viewer [--out viewer_frames]
        [--world 0] [--agent 0] [--num-hiders 2] [--num-seekers 2]
        [--follow] [--device cuda|cpu] < commands

One world of the classic env (``ZeroAgentVelocity | IgnoreEpisodeLength``,
started from ``PRNGKey(5)``). Commands are read from stdin, one a line,
so a script can be piped in; every step writes ``frame_<n>.png``, the
top-down view (``viz/render2d.py::rasterize_world``, no matplotlib
needed) and with the follow camera the driven agent's 64x64 RGB beside it
(``HideAndSeekEnv.rgbd``: the K5 kernel on the card).

Commands: w/a/s/d move, q/e turn, g grab, l lock, an empty line or any
other word an idle step, r reset, 1-8 reset to that debug level, m save
a checkpoint, n load it, p print the agent's observations, f toggle the
follow camera, x quit.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable, Optional

import numpy as np
import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from marl_hideandseek_torch.viz.render2d import rasterize_world, write_png

# Neutral action: the middle move bucket, no grab, no lock (the
# reference consumes actions to neutral, src/sim.cpp:363-369).
NEUTRAL_MOVE = 2
# Key -> (action component, bucket) of the driven agent
# (scripts/viewer.py:118-133).
KEYS = {"w": (1, 4), "s": (1, 0), "a": (0, 0), "d": (0, 4),
        "q": (2, 4), "e": (2, 0), "g": (3, 1), "l": (4, 1)}
# The follow camera: a 64 x 64 view drawn 7x beside the top-down frame.
FOLLOW_PX = 64
FOLLOW_SCALE = 7
FOLLOW_GAP = 20


def key_action(cmd: str, num_agents: int, agent: int) -> np.ndarray:
    """The ``[1, A, 5]`` int32 actions of one command: neutral for every
    agent, with the command's component set for ``agent``."""
    act = np.full((1, num_agents, 5), NEUTRAL_MOVE, np.int32)
    act[..., 3:] = 0
    if cmd in KEYS:
        comp, bucket = KEYS[cmd]
        act[0, agent, comp] = bucket
    return act


class Viewer:
    """The viewer's world, its saved checkpoint and its frames; ``command``
    runs one command."""

    def __init__(self, out: str, world: int = 0, agent: int = 0,
                 num_hiders: int = 2, num_seekers: int = 2,
                 follow: bool = False, device="cuda"):
        self.cfg = EnvConfig(
            num_worlds=1,
            min_hiders=num_hiders, max_hiders=num_hiders,
            min_seekers=num_seekers, max_seekers=num_seekers,
            sim_flags=(SimFlags.ZeroAgentVelocity |
                       SimFlags.IgnoreEpisodeLength))
        self.env = HideAndSeekEnv(self.cfg, device=device)
        self.out, self.world, self.agent = out, world, agent
        self.follow = follow
        self.state, self.result = self.env.init(prng.key(5, self.env.device))
        self.ckpt = None
        self.frame = 0
        self.written = []
        os.makedirs(out, exist_ok=True)
        self.draw()

    def draw(self) -> str:
        """Write the current frame; returns its path."""
        img = rasterize_world(self.cfg, self.state, self.world)
        if self.follow:
            rgb, _ = self.env.rgbd(self.state, FOLLOW_PX, FOLLOW_PX)
            cam = rgb[self.world, self.agent, ..., :3].cpu().numpy()
            cam = cam.repeat(FOLLOW_SCALE, 0).repeat(FOLLOW_SCALE, 1)
            side = np.full((img.shape[0], cam.shape[1] + FOLLOW_GAP, 3), 255,
                           np.uint8)
            top = (img.shape[0] - cam.shape[0]) // 2
            side[top:top + cam.shape[0], FOLLOW_GAP:] = cam
            img = np.concatenate([img, side], 1)
        path = os.path.join(self.out, f"frame_{self.frame:05d}.png")
        write_png(path, img)
        self.written.append(path)
        print(f"  -> {path} (step {int(self.state.step[0])})")
        return path

    def command(self, cmd: str) -> bool:
        """Run one command; False once it is ``x``."""
        cmd = cmd.strip().lower()
        dev = self.env.device
        if cmd == "x":
            return False
        resets: Optional[torch.Tensor] = None
        if cmd == "r":
            resets = torch.ones(1, dtype=torch.int32, device=dev)
        elif cmd.isdigit() and 1 <= int(cmd) <= 8:
            resets = torch.full((1,), int(cmd), dtype=torch.int32,
                                device=dev)
        elif cmd == "m":
            self.ckpt = self.env.save_checkpoints(self.state)
            print("  checkpoint saved")
            return True
        elif cmd == "n":
            if self.ckpt is None:
                print("  no checkpoint")
                return True
            self.state, self.result = self.env.load_checkpoints(
                self.state, self.ckpt,
                torch.ones(1, dtype=torch.int32, device=dev))
            self.frame += 1
            self.draw()
            return True
        elif cmd == "p":
            for k, v in self.result.obs.items():
                print(f"  {k}: {v[0, self.agent].cpu().numpy()}")
            return True
        elif cmd == "f":
            self.follow = not self.follow
            print(f"  follow camera {'on' if self.follow else 'off'}")
            self.frame += 1
            self.draw()
            return True
        act = torch.from_numpy(key_action(cmd, self.cfg.max_agents,
                                          self.agent)).to(dev)
        self.state, self.result = self.env.step(self.state, act, resets)
        self.frame += 1
        self.draw()
        return True

    def run(self, lines: Iterable[str]) -> None:
        """Run commands until ``x`` or the end of ``lines``."""
        for line in lines:
            if not self.command(line):
                break


def _stdin_commands():
    while True:
        try:
            yield input("viewer> ")
        except EOFError:
            return


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default="viewer_frames")
    p.add_argument("--world", type=int, default=0)
    p.add_argument("--agent", type=int, default=0)
    p.add_argument("--num-hiders", type=int, default=2)
    p.add_argument("--num-seekers", type=int, default=2)
    p.add_argument("--follow", action="store_true",
                   help="render the driven agent's first-person RGB view "
                        "beside the top-down frame")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    viewer = Viewer(args.out, args.world, args.agent, args.num_hiders,
                    args.num_seekers, args.follow, args.device)
    print(__doc__)
    viewer.run(_stdin_commands())
    return 0


if __name__ == "__main__":
    sys.exit(main())

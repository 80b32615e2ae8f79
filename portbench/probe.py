"""Copies of what the timed path produced, for the check after the window.

``EnvProbe`` wraps ``env.step`` of one ``PackedEnv`` instance (an instance
attribute over the class's method, so the program's own callers, the
rollout and the inference loop, go through it). At the chosen call
indices it keeps, for the chosen worlds, the state before, the actions,
the resets and the world ids, and the state and result after; every other
call passes straight through. The copies are a few small gathers on three
calls of a run.
"""

from __future__ import annotations

import torch

from portbench.drivers import common


def take_worlds(ps, idx: torch.Tensor):
    """The worlds ``idx`` of a packed state (world axis last), copied."""
    def leaf(x):
        if x.dtype == torch.uint32:
            return x.view(torch.int32)[..., idx].clone().view(torch.uint32)
        return x[..., idx].clone()
    return ps.map(leaf)


class EnvProbe:
    def __init__(self, env, worlds: torch.Tensor, calls):
        self.env = env
        self.worlds = worlds.to(env.device)
        self.calls = set(int(c) for c in calls)
        self.n = 0
        self.records = []
        self._step = env.step
        env.step = self.step

    def step(self, ps, actions, resets=None, base_key=None, world_ids=None):
        i = self.n
        self.n += 1
        if i not in self.calls:
            return self._step(ps, actions, resets, base_key, world_ids)
        idx = self.worlds
        pre = take_worlds(ps, idx)
        acts = actions[..., idx].clone()
        rs = None if resets is None else resets[idx].clone()
        ids = idx.clone() if world_ids is None else world_ids[idx].clone()
        ps2, res = self._step(ps, actions, resets, base_key, world_ids)
        self.records.append(dict(
            call=i, pre=pre, actions=acts, resets=rs, world_ids=ids,
            base_key=None if base_key is None else base_key.clone(),
            post=take_worlds(ps2, idx),
            obs={k: v[idx].clone() for k, v in res.obs.items()},
            rewards=res.rewards[:, idx].clone(),
            dones=res.dones[:, idx].clone()))
        return ps2, res

    def complete(self) -> bool:
        return len(self.records) == len(self.calls)

    def detach(self) -> None:
        """Put the class's ``step`` back."""
        self.env.__dict__.pop("step", None)

    def to_cpu(self) -> list:
        return [common.to_cpu(r) for r in self.records]

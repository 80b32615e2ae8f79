"""The simulator's window with staggered resets: ``sim.Driver``'s steps,
each passing resets through ``PackedEnv.step`` as bench.py draws them
(``resets = rand < reset_chance`` a world, level 1), on the card from the
run's seed. About 1 % of the worlds reset on every step, so most steps
take the compact reset branch (level generation and K1 for those worlds
alone); ``counters`` reports the steps of each branch.

The probed steps are drawn within the first ``first_within`` steps of the
window: every step resets worlds, and no episode end is waited for."""

from __future__ import annotations

import torch

from portbench.drivers import common, sim
from portbench.probe import EnvProbe


class Driver(sim.Driver):
    def __init__(self, run: common.Run):
        super().__init__(run)
        self.chance = float(self.mix["reset_chance"])

    def setup(self) -> None:
        super().setup()
        self.env.step = self.probe._step        # sim.Driver's probe off
        within = self.mix["probe"]["first_within"]
        calls = {common.draw_int(self.run.seed, 2 + i, 0, within)
                 for i in range(3)}
        self.probe_calls = sorted(calls)
        self.probe = EnvProbe(self.env, self.probe_worlds, calls)

    def unit(self, resets=None) -> None:
        if resets is None:
            r = torch.rand(self.w, generator=self.gen, device=self.run.device)
            resets = (r < self.chance).to(torch.int32)
        super().unit(resets)

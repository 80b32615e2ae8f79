"""The simulator's window: ``PackedEnv.step`` with uniform random actions
drawn on the card, as scripts/benchmark.py drives it, optionally followed
by ``ops.rgbd.render_rgbd_packed_fast`` into buffers allocated once. Each
step's observations, rewards and dones are consumed into a checksum on
the card; the images are not (the check reads the probed worlds' images).
``sim_sps`` is worlds x steps over the window."""

from __future__ import annotations

import time

import torch

from portbench import faults
from portbench.drivers import common
from portbench.probe import EnvProbe, take_worlds


class Driver:
    def __init__(self, run: common.Run):
        self.run = run
        self.mix = run.mix
        self.w = self.mix["num_worlds"]
        self.render = bool(self.mix.get("render", False))

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from marl_hideandseek_torch.env.packed import PackedEnv

        run, conf = self.run, self.run.conf
        dev = run.device
        self.cfg = common.env_config(common.PROGRAM, conf["env"],
                                     conf["env"]["flags"], self.w, run.seed)
        self.env = PackedEnv(self.cfg, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(run.seed & ((1 << 63) - 1))
        a = conf["actions"]
        self.shape_move = (self.cfg.max_agents, a["move_dims"], self.w)
        self.shape_bin = (self.cfg.max_agents, a["binary_dims"], self.w)
        self.n_move = a["move_buckets"]
        self.hw = (conf["render"]["height"], conf["render"]["width"])
        if self.render:
            from marl_hideandseek_torch.ops import rgbd
            self.rgbd = rgbd
            self.out = rgbd.rgbd_buffers(self.cfg, self.w, *self.hw, dev)
        self.ps, _ = self.env.init()
        self.chk = torch.zeros((), dtype=torch.float64, device=dev)
        # Warm-up: plain steps, one full reset, plain steps.
        ones = torch.ones(self.w, dtype=torch.int32, device=dev)
        for i in range(self.mix["warmup_steps"]):
            self.unit(ones if i == 1 else None)
        common.sync(dev)
        # The window starts a fresh episode after the warm-up's reset.
        self.episode_step = self.mix["warmup_steps"] - 2
        faults.plant_env(run.fault, self.env)
        p = self.mix["probe"]
        self.probe_worlds = common.sample_ids(run.seed, 1, self.w, p["worlds"])
        ep = self.cfg.episode_len
        to_end = ep - 1 - self.episode_step
        calls = {common.draw_int(run.seed, 2, 0, p["first_within"]), to_end,
                 to_end + 1 + common.draw_int(run.seed, 3, 0,
                                              p["first_within"])}
        self.probe_calls = sorted(calls)
        self.probe = EnvProbe(self.env, self.probe_worlds, calls)

    def actions(self) -> torch.Tensor:
        move = torch.randint(0, self.n_move, self.shape_move,
                             generator=self.gen, device=self.run.device)
        gl = torch.randint(0, 2, self.shape_bin, generator=self.gen,
                           device=self.run.device)
        return torch.cat([move, gl], 1).to(torch.int32)

    def unit(self, resets=None) -> None:
        """One step (and render), consumed into the checksum."""
        ps, res = self.env.step(self.ps, self.actions(), resets)
        # One reduction a tensor in its own dtype; the images are left out
        # (reading 2 GB a step would time the checksum, not the renderer):
        # the check reads the probed worlds' images.
        parts = [v.sum() for v in res.obs.values()]
        parts += [res.rewards.sum(), res.dones.sum()]
        if self.render:
            self.rgbd.render_rgbd_packed_fast(self.cfg, ps, *self.hw,
                                              out=self.out)
        self.chk += torch.stack([p.double() for p in parts]).sum()
        self.ps = ps

    def step_window(self) -> None:
        """One step of the window, with the traced run's reset span and
        the images of probed steps."""
        n_before = len(self.probe.records)
        if self.run.trace and self.episode_step == self.cfg.episode_len - 1:
            self.run.spans.timed("reset", self.unit)
        else:
            self.unit()
        self.episode_step = (self.episode_step + 1) % self.cfg.episode_len
        if self.render and len(self.probe.records) > n_before:
            idx = self.probe.worlds
            rgba = self.out[0].view(torch.int32)[..., idx]
            self.probe.records[-1].update(
                rgba=rgba.view(self.out[0].dtype),
                depth=self.out[1][..., idx].clone())

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float) -> dict:
        dev = self.run.device
        common.sync(dev)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.step_window()
            steps += 1
        common.sync(dev)
        elapsed = time.perf_counter() - t0
        self.steps = steps
        return {"metrics": {"sim_sps": self.w * steps / elapsed},
                "attempted": steps, "elapsed": elapsed}

    def finish_probes(self) -> None:
        """Steps past the window's close until every probed step has
        come (at most as many as the last one needs)."""
        for _ in range(max(self.probe_calls) + 1):
            if self.probe.complete() or self.probe.n > max(self.probe_calls):
                break
            self.step_window()

    # -- the traced run -----------------------------------------------------
    def profile_segment(self, out: dict) -> None:
        from portbench import trace

        steps = self.mix["trace_steps"]
        self.traced_state = take_worlds(self.ps, torch.arange(
            self.w, device=self.run.device))
        self.traced_actions = self.actions()
        with trace.profiled(out):
            for _ in range(steps):
                self.step_window()

    def layer_values(self) -> dict:
        """Least seconds of one K4 (and K5) launch on the traced window's
        first state, from the frozen counts."""
        from portbench.counts import kernel_ops, peaks
        from portbench.reference.compare import frozen_state
        from portbench.reference.frozen.env.observations import num_vis_targets
        from portbench.reference.frozen.ops import step as fstep
        from portbench.reference.frozen.types import on_bits

        fcfg = common.env_config(common.FROZEN, self.run.conf["env"],
                                 self.run.conf["env"]["flags"], self.w,
                                 self.run.seed)
        ps = frozen_state(self.traced_state)
        acts = self.traced_actions
        tally, chunk = {}, self.mix.get("count_chunk", 8192)
        with torch.no_grad():
            for lo in range(0, self.w, chunk):
                idx = torch.arange(lo, min(lo + chunk, self.w),
                                   device=self.run.device)
                sub = ps.map(on_bits(lambda x: x[..., idx]))
                fstep.megastep_plain(fcfg.replace(num_worlds=len(idx)), sub,
                                     acts[..., idx], tally)
        ops = kernel_ops.megastep_ops(fcfg, ps, tally)
        n_bytes = kernel_ops.megastep_bytes(fcfg, ps, num_vis_targets(fcfg))
        vals = {"k4_least_s": peaks.least_seconds(n_bytes, ops),
                "k4_ops": ops, "k4_bytes": n_bytes}
        if self.render:
            rgba, depth = self.out
            vals["k5_least_s"] = peaks.least_seconds(
                kernel_ops.rgbd_bytes(self.ps, rgba, depth),
                kernel_ops.rgbd_least_ops(depth))
        vals["reset_steps"] = float(len(self.run.spans.spans.get("reset", [])))
        return vals

    def counters(self) -> dict:
        from marl_hideandseek_torch.ops import rays, rgbd, step, threefry
        return {"resets": dict(self.env.reset_counts),
                "launches": {"megastep": step.MEGASTEP.launches,
                             "raycast": rays.RAYCAST.launches,
                             "threefry": threefry.THREEFRY.launches,
                             "rgbd": rgbd.RGBD.launches},
                "checksum": float(self.chk)}

    # -- the check ----------------------------------------------------------
    def release(self) -> None:
        self.records = self.probe.to_cpu()
        self.probe.detach()
        self.finite = bool(torch.isfinite(self.chk))
        del self.ps, self.env, self.probe
        if self.render:
            del self.out
        self.__dict__.pop("traced_state", None)

    def check(self) -> dict:
        from portbench.reference import compare

        fcfg = common.env_config(common.FROZEN, self.run.conf["env"],
                                 self.run.conf["env"]["flags"], self.w,
                                 self.run.seed)
        ctl = self.run.control
        nums = compare.env_numbers(self.records, fcfg, ctl)
        if self.render:
            nums.update(compare.rgbd_numbers(self.records, fcfg, self.hw, ctl))
        nums["probes_missing"] = float(len(self.probe_calls) -
                                       len(self.records))
        nums["checksum_not_finite"] = 0.0 if self.finite else 1.0
        return nums

"""The training window: ``TrainingManager.update_iter`` in a loop, after
the train CLI's ``build`` (as this file's configuration states it, with
the run's seed) and ``init_training``. ``train_sps`` counts as
scripts/train.py counts its FPS: worlds x steps per update for each whole
update finished in the window, over the time to the end of the last one.

Set-up drives the manager through its first updates, the same object the
window then runs; the first three are recorded for the check
(``reference/train_check.py``): their buffers, the parameters and Adam
state the PPO update took and gave, and its loss."""

from __future__ import annotations

import time

from portbench import faults
from portbench.drivers import common
from portbench.probe import EnvProbe

CHECKED = 3


class Driver:
    def __init__(self, run: common.Run):
        self.run = run
        self.mix = run.mix
        self.w = self.mix["num_worlds"]

    def setup(self) -> None:
        import dataclasses

        from marl_hideandseek_torch.env.packed import PackedEnv
        from marl_hideandseek_torch.train import TrainHooks, init_training
        from marl_hideandseek_torch.train import manager

        run, conf = self.run, self.run.conf
        dev = run.device
        faults.plant_training(run.fault)
        env_cfg = common.env_config(common.PROGRAM, conf["env"],
                                    conf["env"]["train_flags"], self.w,
                                    run.seed)
        env_cfg = env_cfg.replace(num_pbt_policies=conf["pbt"]["train_policies"])
        self.env = PackedEnv(env_cfg, device=dev)
        self.cfg = common.train_config(common.PROGRAM, conf, self.w, run.seed)
        policy = common.make_policy(common.PROGRAM, conf, 1, dev)
        spans = run.spans
        driver = self

        class Hooks(TrainHooks):
            def post_rollout(self, update_idx, buffer, metrics):
                if driver.timing:
                    common.sync(dev)
                    driver.t_rollout = time.perf_counter()
                return metrics

            def post_update(self, update_idx, metrics, train_state):
                if driver.timing:
                    common.sync(dev)
                    t = time.perf_counter()
                    spans.add("rollout", driver.t_rollout - driver.t_start)
                    spans.add("ppo", t - driver.t_rollout)
                return metrics

        self.timing = False
        self.mgr = init_training(dev, self.cfg, self.env, policy,
                                 hooks=Hooks())
        st = self.mgr.state
        n = self.w * env_cfg.max_agents
        self.n_agents = n
        self.rec = {"params0": common.to_cpu(st.params),
                    "hyper0": common.to_cpu(st.hyper_params), "updates": []}
        agents = common.sample_ids(run.seed, 1, n, self.mix["probe"]["agents"])
        orig = manager.ppo_update
        rec = self.rec

        def recording(cfg, pol, params, opt, obs_stats, value_stats, hyper,
                      buffer, key, mesh=manager.LOCAL):
            out = orig(cfg, pol, params, opt, obs_stats, value_stats, hyper,
                       buffer, key, mesh)
            rec["updates"].append({
                "buffer": {f.name: common.to_cpu(getattr(buffer, f.name))
                           for f in dataclasses.fields(buffer)},
                "agents": agents, "loss": out[3]["loss"].detach().cpu(),
                "mu": common.to_cpu(out[1].mu)})
            rec["params_end"] = common.to_cpu(out[0])
            return out

        # Probed env steps: two in the checked updates, and the episode end.
        steps = self.cfg.steps_per_update
        p = self.mix["probe"]
        calls = {common.draw_int(run.seed, 2, 0, CHECKED * steps),
                 common.draw_int(run.seed, 3, 0, CHECKED * steps),
                 env_cfg.episode_len - 1}
        self.probe_calls = sorted(calls)
        self.probe = EnvProbe(self.env, common.sample_ids(
            run.seed, 4, self.w, p["worlds"]), calls)
        manager.ppo_update = recording
        try:
            for _ in range(CHECKED):
                self.mgr = self.mgr.update_iter()
        finally:
            manager.ppo_update = orig
        for _ in range(self.mix["warmup_updates"] - CHECKED):
            self.mgr = self.mgr.update_iter()
        common.sync(dev)

    def unit(self) -> None:
        if self.timing:
            common.sync(self.run.device)
            self.t_start = time.perf_counter()
        self.mgr = self.mgr.update_iter()

    def window(self, seconds: float) -> dict:
        dev = self.run.device
        self.timing = self.run.trace
        common.sync(dev)
        t0 = time.perf_counter()
        updates = 0
        while time.perf_counter() - t0 < seconds:
            self.unit()
            updates += 1
        common.sync(dev)
        elapsed = time.perf_counter() - t0
        self.timing = False
        self.updates = updates
        sps = self.w * self.cfg.steps_per_update * updates / elapsed
        return {"metrics": {"train_sps": sps}, "attempted": updates,
                "elapsed": elapsed}

    def finish_probes(self) -> None:
        """Updates past the window's close until every probed env step
        has come (at most as many as the last one needs)."""
        need = max(self.probe_calls) // self.cfg.steps_per_update + 1
        for _ in range(need):
            if self.probe.complete() or self.probe.n > max(self.probe_calls):
                break
            self.unit()

    def profile_segment(self, out: dict) -> None:
        from portbench import trace

        with trace.profiled(out):
            for _ in range(self.mix["trace_updates"]):
                self.unit()

    def layer_values(self) -> dict:
        from portbench.counts import policy_flops

        pol = self.run.conf["policy"]
        steps = self.cfg.steps_per_update
        n_train = self.cfg.num_train_policies
        # Past-play: one side of every world plays a train policy, the
        # other a past policy (actor only); the bootstrap adds a step.
        assign = self.mgr.state.rollout.assignments
        n_tr = float((assign < n_train).sum())
        roll = (steps + 1) * policy_flops.forward_flops(
            pol, n_tr, self.n_agents - n_tr)
        ppo = policy_flops.ppo_flops(pol, n_tr * steps, self.cfg.algo.num_epochs)
        return {"update_flops": roll + ppo,
                "window_flops": (roll + ppo) * self.updates}

    def counters(self) -> dict:
        from marl_hideandseek_torch.ops import rays, step, threefry
        return {"resets": dict(self.env.reset_counts),
                "launches": {"megastep": step.MEGASTEP.launches,
                             "raycast": rays.RAYCAST.launches,
                             "threefry": threefry.THREEFRY.launches},
                "updates_done": self.mgr.state.update_idx}

    def release(self) -> None:
        self.env_records = self.probe.to_cpu()
        self.probe.detach()
        del self.mgr, self.env, self.probe

    def check(self) -> dict:
        from portbench.reference import compare
        from portbench.reference.train_check import train_numbers

        conf = self.run.conf
        fcfg = common.env_config(common.FROZEN, conf["env"],
                                 conf["env"]["train_flags"], self.w,
                                 self.run.seed)
        fcfg = fcfg.replace(num_pbt_policies=conf["pbt"]["train_policies"])
        nums = compare.env_numbers(self.env_records, fcfg, self.run.control)
        nums.update(train_numbers(self.rec, conf, self.w, self.run.seed,
                                  self.run.device, self.run.control))
        nums["probes_missing"] = float(len(self.probe_calls) -
                                       len(self.env_records) +
                                       CHECKED - len(self.rec["updates"]))
        return nums

"""The serve window: ``infer.run_inference`` (the inference loop of ``python
-m marl_hideandseek_torch.infer``, ``env.init`` included) on the flagship
policies, stochastic, for the window's seconds over the mix's nominal
step time (``step_s``, measured on the card), so every run of a given
length does the same work. ``serve_sps`` is worlds x steps over the call.

The loop draws its world and its actions from ``PRNGKey(7)``, as
scripts/infer.py does, so the seed enters through the weights and the
observation statistics, which this driver makes on the card."""

from __future__ import annotations

import math
import time

import torch

from portbench import faults
from portbench.drivers import common


def seeded_weights(params: dict, gen: torch.Generator) -> dict:
    """Every leaf drawn on the card from ``gen`` in one call: kernels
    N(0, 1/fan_in), biases N(0, 0.05^2), LayerNorm scales 1 + N(0, 0.05^2).
    ``params``: the policy's flat parameter dict (``[P, ...]`` leaves)."""
    names = list(params)
    sizes = [params[k].numel() for k in names]
    z = torch.randn(sum(sizes), generator=gen, device=gen.device)
    out = {}
    for k, part in zip(names, torch.split(z, sizes)):
        v = params[k]
        part = part.view(v.shape)
        if k.endswith("kernel"):
            fan_in = math.prod(v.shape[1:-1]) if v.dim() > 2 else v.shape[1]
            out[k] = part / math.sqrt(fan_in)
        elif k.endswith("scale"):
            out[k] = 1.0 + 0.05 * part
        else:
            out[k] = 0.05 * part
    return out


class Driver:
    def __init__(self, run: common.Run):
        self.run = run
        self.mix = run.mix
        self.w = self.mix["num_worlds"]

    def setup(self) -> None:
        from marl_hideandseek_torch.env.packed import PackedEnv
        from marl_hideandseek_torch.infer import run_inference
        from marl_hideandseek_torch.models.normalizer import NormalizerState

        run, conf = self.run, self.run.conf
        dev = run.device
        self.run_inference = run_inference
        self.cfg = common.env_config(common.PROGRAM, conf["env"],
                                     conf["env"]["serve_flags"], self.w,
                                     run.seed)
        self.env = PackedEnv(self.cfg, device=dev)
        n_pol = conf["serve_policies"]
        self.policy = common.make_policy(common.PROGRAM, conf, n_pol, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(run.seed & ((1 << 63) - 1))
        raw = dict(self.policy.actor_critic.named_parameters())
        self.weights = seeded_weights(raw, gen)
        with torch.no_grad():
            for k, v in raw.items():
                v.copy_(self.weights[k])
        self.params = raw
        norm = self.policy.obs_preprocess
        obs0 = self.env.init()[1].obs
        st = norm.init_state({k: v.flatten(0, 1)
                              for k, v in norm.prep(obs0).items()})
        mean = {k: 0.1 * torch.randn(v.shape, generator=gen, device=dev)
                for k, v in st.mean.items()}
        var = {k: 0.5 + 1.5 * torch.rand(v.shape, generator=gen, device=dev)
               for k, v in st.var.items()}
        self.stats = NormalizerState(mean=mean, var=var, count=st.count)
        self.n_agents = self.w * self.cfg.max_agents
        # Warm-up: the loop's shapes and one full reset.
        self.env.step(*self._ones_reset())
        run_inference(self.env, self.policy, self.params, self.stats,
                      self.mix["warmup_steps"])
        common.sync(dev)
        faults.plant_env(run.fault, self.env)
        faults.plant_actions(run.fault)
        p = self.mix["probe"]
        self.probe_agents = common.sample_ids(run.seed, 1, self.n_agents,
                                              p["agents"])
        self.probe_worlds = common.sample_ids(run.seed, 4, self.w,
                                              p["worlds"])
        ep = self.cfg.episode_len
        self.probe_steps = sorted({
            common.draw_int(run.seed, 2, 0, p["first_within"]), ep - 1,
            ep + common.draw_int(run.seed, 3, 0, p["first_within"])})
        self.min_steps = self.probe_steps[-1] + 1
        self.records = []

    def _ones_reset(self):
        """A fresh state, zero actions and every world reset: the
        full-reset branch's shapes."""
        ps, _ = self.env.init()
        acts = torch.zeros((self.cfg.max_agents, 5, self.w),
                           dtype=torch.int32, device=self.run.device)
        return ps, acts, torch.ones(self.w, dtype=torch.int32,
                                    device=self.run.device)

    def on_step(self, d) -> None:
        if d["step"] not in self.probe_steps:
            return
        from marl_hideandseek_torch.models.actor_critic import tree_map

        a = self.probe_agents_dev
        done = d["result"].dones.T.reshape(-1)[a].to(torch.bool)
        self.records.append(dict(
            step=d["step"], agents=self.probe_agents,
            obs={k: v[a].clone() for k, v in d["obs"].items()},
            rnn=tree_map(lambda x: x[:, a].clone(), d["rnn"]),
            assignments=d["assignments"][a].clone(),
            logits=d["logits"][a].clone(), values=d["values"][a].clone(),
            rnn_next=tree_map(lambda x: x[:, a].clone(), d["rnn_next"]),
            actions=d["actions"][a].clone(), done_agents=done))

    def window(self, seconds: float) -> dict:
        from portbench.probe import EnvProbe

        dev = self.run.device
        # A fixed number of steps for a given window: its seconds over the
        # mix's nominal step time, so that every run does the same work.
        steps = max(self.min_steps, round(seconds / self.mix["step_s"]))
        self.steps = steps
        self.probe_agents_dev = self.probe_agents.to(dev)
        self.probe = EnvProbe(self.env, self.probe_worlds, self.probe_steps)
        kw = {"timing": True} if self.run.trace and dev.type == "cuda" else {}
        common.sync(dev)
        t0 = time.perf_counter()
        self.out = self.run_inference(self.env, self.policy, self.params,
                                      self.stats, steps,
                                      iter_cb=self.on_step, **kw)
        common.sync(dev)
        elapsed = time.perf_counter() - t0
        self.probe.detach()
        return {"metrics": {"serve_sps": self.w * steps / elapsed},
                "attempted": steps, "elapsed": elapsed}

    def finish_probes(self) -> None:
        return None

    def profile_segment(self, out: dict) -> None:
        from portbench import trace

        with trace.profiled(out):
            self.run_inference(self.env, self.policy, self.params,
                               self.stats, self.mix["trace_steps"])

    def layer_values(self) -> dict:
        from portbench.counts import policy_flops

        per_step = policy_flops.forward_flops(self.run.conf["policy"],
                                              self.n_agents)
        return {"forward_ms": self.out.get("forward_ms"),
                "env_ms": self.out.get("env_ms"),
                "window_flops": per_step * self.steps}

    def counters(self) -> dict:
        from marl_hideandseek_torch.ops import rays, step, threefry
        return {"resets": dict(self.env.reset_counts),
                "launches": {"megastep": step.MEGASTEP.launches,
                             "raycast": rays.RAYCAST.launches,
                             "threefry": threefry.THREEFRY.launches},
                "episodes_finished": self.out["episodes_finished"]}

    def release(self) -> None:
        self.env_records = self.probe.to_cpu()
        self.records = common.to_cpu(self.records)
        self.weights = common.to_cpu(self.weights)
        self.stats_cpu = common.to_cpu({"mean": self.stats.mean,
                                        "var": self.stats.var,
                                        "count": self.stats.count})
        del self.env, self.policy, self.params, self.stats, self.probe

    def check(self) -> dict:
        from portbench.reference import compare

        fcfg = common.env_config(common.FROZEN, self.run.conf["env"],
                                 self.run.conf["env"]["serve_flags"], self.w,
                                 self.run.seed)
        nums = compare.env_numbers(self.env_records, fcfg, self.run.control)
        nums.update(compare.serve_numbers(
            self.records, self.run.conf, self.weights, self.stats_cpu,
            self.n_agents, self.run.device, self.run.control))
        nums["probes_missing"] = float(
            2 * len(self.probe_steps) - len(self.records) -
            len(self.env_records))
        return nums

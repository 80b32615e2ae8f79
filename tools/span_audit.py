"""The program's spans on the card: where the host waits, what the spans
cost, and how much of each phase their children cover.

    python3 tools/span_audit.py [--device cuda] [--out audit.json]
        [--phases ranges,syncs,costs,coverage]

Phases, each printing one JSON line (``--out`` writes them all):

- ``ranges``: a span around a product under ``torch.profiler`` with CPU
  and CUDA activity; the trace's events of the span's name and their
  device types, beside ``record_function``'s (which adds a device-side
  annotation). The span's must all be host events.
- ``syncs``: one unit of each benchmark cell's path, and the compact reset
  and PBT besides, under ``torch.cuda.set_sync_debug_mode("warn")`` and
  ``tracing.recording()``: each synchronizing statement by its innermost
  frame in the program, how often it ran, and the innermost span open
  around it (a ``host_read.*`` span, or it is reported as unwrapped).
- ``costs``: an empty span's host cost off, on and under the profiler,
  and a unit's time with tracing off, inside ``recording()`` and under the
  profiler, in turns, with each span name's count and host and device ms
  a unit: the simulator's step at 65,536 worlds and the training update
  at 4,096 worlds (``portbench``'s cells).
- ``coverage``: one training update under the profiler; for each span
  with children, the share of its host time they cover and its self time,
  with the count and the host and device ms of every span name.

``--device cpu`` runs every phase at a tiny size on the plain path (the
syncs phase then finds nothing: the CPU has no sync to report).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import timeit
import traceback
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from marl_hideandseek_torch.utils import tracing  # noqa: E402
from portbench import core  # noqa: E402
from portbench.drivers import common  # noqa: E402

PKG = os.sep + "marl_hideandseek_torch" + os.sep
BIG = {"sim": 65536, "train": 4096}
SMALL = {"sim": 1024, "serve": 1024, "train": 256, "rgbd": 256}
TINY = {"sim": 8, "serve": 8, "train": 8, "rgbd": 4}


def sync(dev):
    common.sync(dev)


def ranges_phase(dev) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    x = torch.randn(1024, 1024, device=dev)
    sync(dev)
    with profile(activities=acts) as prof:
        with tracing.span("audit.span"):
            y = x @ x
        with record_function("audit.record_function"):
            y = y @ x
        sync(dev)
    tracing.take()
    out = collections.Counter()
    for e in prof.events():
        if e.name.startswith("audit."):
            out[f"{e.name} {e.device_type}"] += 1
    return {"phase": "ranges", "events": dict(out),
            "span_on_device": sum(v for k, v in out.items()
                                  if k.startswith("audit.span ")
                                  and "CUDA" in k)}


class SyncLog:
    """``showwarning`` for the sync debug mode's warnings: each by its
    innermost program frame and the innermost open span."""

    def __init__(self):
        self.seen = collections.Counter()
        self.unit = None

    def __call__(self, message, category, filename, lineno, file=None,
                 line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        where = None
        for fr in reversed(stack):
            if PKG in fr.filename:
                rel = fr.filename[fr.filename.index(PKG) + 1:]
                where = f"{rel}:{fr.lineno}"
                break
        if where is None:       # the audit's own code, outside torch
            fr = next(f for f in reversed(stack)
                      if os.sep + "torch" + os.sep not in f.filename)
            where = (f"outside the program: "
                     f"{os.path.basename(fr.filename)}:{fr.lineno}")
        scope = tracing._scope
        span = scope.open[-1] if scope is not None and scope.open else None
        self.seen[(self.unit, where, span)] += 1


def audited(log, unit, dev, fn):
    """``fn()`` under the sync debug mode, its spans recorded; returns the
    span counts."""
    log.unit = unit
    sync(dev)
    with tracing.recording() as rec:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(s.name for s in rec.take().spans)


def sim_env(dev, w, flags_key="flags", conf_name="bench_2v2"):
    from marl_hideandseek_torch.env.packed import PackedEnv

    bench = core.benchmark()
    conf = core.load_json(core.config_file(bench, conf_name))
    cfg = common.env_config(common.PROGRAM, conf["env"],
                            conf["env"][flags_key], w, 2147483651)
    return PackedEnv(cfg, device=dev), conf


def random_actions(env, gen):
    cfg, w = env.cfg, env.cfg.num_worlds
    dev = env.device
    move = torch.randint(0, 5, (cfg.max_agents, 3, w), generator=gen,
                         device=dev)
    gl = torch.randint(0, 2, (cfg.max_agents, 2, w), generator=gen,
                       device=dev)
    return torch.cat([move, gl], 1).to(torch.int32)


def train_manager(dev, w):
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.train import init_training

    bench = core.benchmark()
    conf = core.load_json(core.config_file(bench, "flagship_2v2"))
    env_cfg = common.env_config(common.PROGRAM, conf["env"],
                                conf["env"]["train_flags"], w, 2147483651)
    env_cfg = env_cfg.replace(num_pbt_policies=conf["pbt"]["train_policies"])
    env = PackedEnv(env_cfg, device=dev)
    cfg = common.train_config(common.PROGRAM, conf, w, 2147483651)
    policy = common.make_policy(common.PROGRAM, conf, 1, dev)
    return init_training(dev, cfg, env, policy)


def near_episode_end(mgr, steps_left):
    ro = mgr.state.rollout
    st = ro.env_state
    return mgr.replace(state=mgr.state.replace(rollout=ro.replace(
        env_state=st.replace(step=torch.full_like(
            st.step, mgr.env.cfg.episode_len - steps_left)))))


def syncs_phase(dev, sizes) -> dict:
    from marl_hideandseek_torch.infer import run_inference
    from marl_hideandseek_torch.models.normalizer import NormalizerState
    from marl_hideandseek_torch.ops import rgbd
    from marl_hideandseek_torch.train import pbt

    log = SyncLog()
    spans = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = log

        # The simulator: a plain step, the episode-end full reset, a
        # compact reset of 3 worlds.
        env, _ = sim_env(dev, sizes["sim"])
        ps, _ = env.init()
        ps, _ = env.step(ps, random_actions(env, gen))
        sync(dev)
        box = {"ps": ps}

        def plain():
            box["ps"], _ = env.step(box["ps"], random_actions(env, gen))

        spans["sim.plain_step"] = audited(log, "sim.plain_step", dev, plain)
        box["ps"] = box["ps"].replace(step=torch.full_like(
            box["ps"].step, env.cfg.episode_len - 1))
        spans["sim.full_reset_step"] = audited(log, "sim.full_reset_step",
                                               dev, plain)
        resets = torch.zeros(env.cfg.num_worlds, dtype=torch.int32,
                             device=dev)
        resets[:3] = 1

        def compact():
            box["ps"], _ = env.step(box["ps"], random_actions(env, gen),
                                    resets)

        spans["sim.compact_reset_step"] = audited(
            log, "sim.compact_reset_step", dev, compact)
        del env, box

        # RGBD: a step and a render.
        env, conf = sim_env(dev, sizes["rgbd"])
        ps, _ = env.init()
        out = rgbd.rgbd_buffers(env.cfg, env.cfg.num_worlds, 64, 64, dev)

        def render():
            p2, _ = env.step(ps, random_actions(env, gen))
            rgbd.render_rgbd_packed_fast(env.cfg, p2, 64, 64, out=out)

        spans["rgbd.step_and_render"] = audited(log, "rgbd.step_and_render",
                                                dev, render)
        del env, out

        # Serve: run_inference's init and three steps, 4 policies.
        env, conf = sim_env(dev, sizes["serve"], "serve_flags",
                            "flagship_2v2")
        policy = common.make_policy(common.PROGRAM, conf, 4, dev)
        params = dict(policy.actor_critic.named_parameters())
        norm = policy.obs_preprocess
        obs0 = env.init()[1].obs
        st = norm.init_state({k: v.flatten(0, 1)
                              for k, v in norm.prep(obs0).items()})
        stats = NormalizerState(mean=st.mean, var=st.var, count=st.count)
        run_inference(env, policy, params, stats, 2)
        spans["serve.init_and_3_steps"] = audited(
            log, "serve.init_and_3_steps", dev,
            lambda: run_inference(env, policy, params, stats, 3))
        del env, policy, params

        # Train: an update across the episode end, then PBT.
        mgr = train_manager(dev, sizes["train"])
        mgr = mgr.update_iter()
        mgr = near_episode_end(mgr, 3)
        box = {"mgr": mgr}

        def update():
            box["mgr"] = box["mgr"].update_iter()

        spans["train.update_with_reset"] = audited(
            log, "train.update_with_reset", dev, update)
        mgr = box["mgr"]
        st = mgr.state

        def explore():
            p, o, h = pbt.explore_exploit(mgr.cfg, st.key, st.elo, st.params,
                                          st.opt_states, st.hyper_params)
            pbt.refresh_past_policies(mgr.cfg, 1, p, st.past_params, st.elo)

        spans["train.pbt"] = audited(log, "train.pbt", dev, explore)
        del mgr, box, st
    rows = [{"unit": u, "where": w, "span": s, "count": n,
             "wrapped": bool(s and s.startswith("host_read."))}
            for (u, w, s), n in sorted(log.seen.items(),
                                       key=lambda kv: str(kv[0]))]
    host_reads = {u: {k: v for k, v in c.items()
                      if k.startswith("host_read.")}
                  for u, c in spans.items()}
    return {"phase": "syncs", "syncs": rows, "host_read_spans": host_reads,
            "unwrapped": [r for r in rows if not r["wrapped"]]}


def span_ns(dev) -> dict:
    """Host ns of one empty span: off, on (``recording()``, with the
    device's events) and under the profiler; an empty call subtracted."""
    from torch.profiler import ProfilerActivity, profile

    def one():
        with tracing.span("x"):
            pass

    def empty():
        pass

    def best(fn, n):
        return min(timeit.timeit(fn, number=n) for _ in range(5)) / n

    base = best(empty, 1_000_000)
    out = {"off": (best(one, 1_000_000) - base) * 1e9}
    n = 20_000
    with tracing.recording() as rec:
        out["on"] = (best(one, n) - base) * 1e9
    rec.take()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts):
        out["prof"] = (best(one, n) - base) * 1e9
    tracing.take()
    return out


def per_name(spans, n):
    """{name: [count, host ms, device ms]} of the spans, per unit."""
    out = collections.defaultdict(lambda: [0.0, 0.0, 0.0])
    for s in spans:
        r = out[s.name]
        r[0] += 1 / n
        r[1] += s.host_ms / n
        r[2] += (s.device_ms or 0.0) / n
    return dict(sorted(out.items()))


def timed_units(dev, unit, n, mode):
    """Host seconds of ``n`` units, closed by a synchronize, in ``mode``:
    off, on (``recording()``), prof (under the profiler); and the spans'
    ``per_name`` (None when off)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    t0 = time.perf_counter()
    if mode == "off":
        for _ in range(n):
            unit()
        sync(dev)
        dt = time.perf_counter() - t0
        counts = None
    elif mode == "on":
        with tracing.recording() as rec:
            for _ in range(n):
                unit()
            sync(dev)
            dt = time.perf_counter() - t0
        counts = per_name(rec.take().spans, n)
    else:
        with profile(activities=acts):
            for _ in range(n):
                unit()
            sync(dev)
            dt = time.perf_counter() - t0
        counts = per_name(tracing.take().spans, n)
    return dt / n, counts


def spans_per_unit(counts):
    return sum(r[0] for r in counts.values()) if counts else None


def costs_phase(dev, sizes, sim_steps, updates) -> dict:
    out = {"phase": "costs", "ns_per_span": span_ns(dev)}
    gen = torch.Generator(device=dev).manual_seed(7)
    env, _ = sim_env(dev, sizes["sim"])
    box = {"ps": env.init()[0]}

    def step():
        box["ps"], _ = env.step(box["ps"], random_actions(env, gen))

    for _ in range(3):
        step()
    rows = []
    for mode in ("off", "on", "prof", "prof", "on", "off"):
        # Keep the episode end out of the timed steps.
        box["ps"] = box["ps"].replace(step=torch.zeros_like(box["ps"].step))
        s, counts = timed_units(dev, step, sim_steps, mode)
        rows.append({"mode": mode, "ms_per_step": 1e3 * s,
                     "spans_per_step": spans_per_unit(counts),
                     "per_step": counts})
    out["sim"] = {"worlds": sizes["sim"], "steps": sim_steps, "runs": rows}
    del env, box
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    mgr = train_manager(dev, sizes["train"])
    box = {"mgr": mgr.update_iter()}

    def update():
        box["mgr"] = box["mgr"].update_iter()

    update()
    rows = []
    for mode in ("off", "on", "prof", "prof", "on", "off"):
        s, counts = timed_units(dev, update, updates, mode)
        rows.append({"mode": mode, "s_per_update": s,
                     "spans_per_update": spans_per_unit(counts),
                     "per_update": counts})
    out["train"] = {"worlds": sizes["train"], "updates": updates,
                    "runs": rows}
    out["_mgr"] = box["mgr"]
    return out


def coverage_phase(dev, mgr) -> dict:
    """One update under the profiler: per span name its count, host and
    device ms; per parent name the share of its host time its children
    cover, and its self ms."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    with profile(activities=acts):
        mgr = mgr.update_iter()
        sync(dev)
    spans = tracing.take().spans
    by_name = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for s in spans:
        r = by_name[s.name]
        r[0] += 1
        r[1] += s.host_ms
        r[2] += s.device_ms or 0.0
    covered = collections.defaultdict(float)
    total = collections.defaultdict(float)
    for s in spans:
        total[s.name] += s.host_ms
        if s.parent is not None:
            covered[s.parent] += s.host_ms
    cover = {p: {"host_ms": total[p], "children_ms": covered[p],
                 "share": covered[p] / total[p] if total[p] else None,
                 "self_ms": total[p] - covered[p]}
             for p in covered}
    return {"phase": "coverage",
            "spans": {k: {"count": v[0], "host_ms": v[1], "device_ms": v[2]}
                      for k, v in sorted(by_name.items())},
            "cover": cover}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--phases", default="ranges,syncs,costs,coverage")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    common.float32_exact()
    phases = args.phases.split(",")
    cuda = dev.type == "cuda"
    results = []

    def emit(r):
        r = {k: v for k, v in r.items() if not k.startswith("_")}
        if cuda:
            r["device"] = torch.cuda.get_device_name(0)
        results.append(r)
        print(json.dumps(r), flush=True)

    if "ranges" in phases:
        emit(ranges_phase(dev))
    if "syncs" in phases:
        emit(syncs_phase(dev, SMALL if cuda else TINY))
    mgr = None
    if "costs" in phases:
        r = costs_phase(dev, BIG if cuda else TINY, 40 if cuda else 2,
                        2 if cuda else 1)
        mgr = r["_mgr"]
        emit(r)
    if "coverage" in phases:
        if mgr is None:
            mgr = train_manager(dev, (BIG if cuda else TINY)["train"])
            mgr = mgr.update_iter()
        emit(coverage_phase(dev, mgr))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

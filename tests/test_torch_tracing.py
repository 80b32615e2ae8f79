"""PyTorch port: the program's spans (``utils/tracing.py``) on the CPU, at
tiny sizes.

Off, a span is one shared object that records nothing and calls no
profiler function. Inside ``tracing.recording()``, one ``update_iter`` (2
chunks of 4 steps across an episode end, grouped PPO over 2 + 2 policies,
PBT every update) and ``PackedEnv.step``s through the plain, full-reset
and compact-reset branches give the span tree that PERF.md lists: names,
parents and counts. Under ``torch.profiler`` the same names show as host
events nested as in the store, none of them a device event. With tracing
on, the update's state and the env's steps are bit for bit those of
tracing off. ``take`` clears its store; the cap drops the oldest records
and counts them.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from marl_hideandseek_torch import policy as tpolicy
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.infer import run_inference
from marl_hideandseek_torch.train import cfg as tcfg
from marl_hideandseek_torch.train import manager as tmanager
from marl_hideandseek_torch.train.rollout import ROUTE
from marl_hideandseek_torch.types import SweepResults
from marl_hideandseek_torch.utils import tracing

torch.set_num_threads(1)

# 4 worlds, 1v1, the reduced capacity of tests/test_torch_train.py, a
# 104-step episode; a compact reset takes at most 2 worlds.
ENV = EnvConfig(num_worlds=4, min_hiders=1, max_hiders=1, min_seekers=1,
                max_seekers=1, max_boxes=3, max_ramps=2, episode_len=104,
                reset_budget=2,
                sim_flags=(SimFlags.RandomFlipTeams | SimFlags.UseFixedWorld
                           | SimFlags.ZeroAgentVelocity), rand_seed=5)
STEPS, CHUNKS = 8, 2
EPOCHS = 2


@pytest.fixture(scope="module")
def policy():
    return tpolicy.make_policy(num_rnn_channels=32, device="cpu")


def train_config():
    explore = dict(min_scale=0.1, max_scale=10.0, log10_scale=True)
    return tcfg.TrainConfig(
        num_worlds=ENV.num_worlds, num_agents_per_world=ENV.max_agents,
        num_updates=1, actions=tcfg.ActionsConfig(),
        steps_per_update=STEPS, num_bptt_chunks=CHUNKS,
        lr=tcfg.ParamExplore(1e-4, **explore),
        algo=tcfg.PPOConfig(entropy_coef=tcfg.ParamExplore(0.01, **explore),
                            num_epochs=EPOCHS),
        pbt=tcfg.PBTConfig(num_teams=2, team_size=1, num_train_policies=2,
                           num_past_policies=2, explore_interval=1,
                           past_policy_update_interval=1),
        ppo_group_trainable=True)


def manager(policy):
    """A fresh manager whose worlds end their episode at the rollout's
    third step."""
    env = PackedEnv(ENV, device="cpu")
    mgr = tmanager.init_training("cpu", train_config(), env, policy)
    ro = mgr.state.rollout
    return mgr.replace(state=mgr.state.replace(rollout=ro.replace(
        env_state=ro.env_state.replace(step=torch.full_like(
            ro.env_state.step, ENV.episode_len - 3)))))


def actions(w=ENV.num_worlds):
    g = torch.Generator().manual_seed(3)
    move = torch.randint(0, 5, (ENV.max_agents, 3, w), generator=g)
    return torch.cat([move, torch.randint(0, 2, (ENV.max_agents, 2, w),
                                          generator=g)], 1).to(torch.int32)


def env_steps(env):
    """A plain step, a full reset (every world) and a compact reset (one
    world); the states and results."""
    ps, _ = env.init()
    out = []
    w = ENV.num_worlds
    for resets in (None, torch.ones(w, dtype=torch.int32),
                   torch.tensor([0, 2, 0, 0], dtype=torch.int32)):
        ps, res = env.step(ps, actions(), resets)
        out.append((ps, res))
    return out


def tree(spans):
    return collections.Counter((s.name, s.parent) for s in spans)


def leaves(x):
    """The tensors of a state, a result or a nested tree, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (int, float)):
        return [torch.tensor(x)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    if hasattr(x, "leaves"):
        return list(x.leaves())
    return [t for v in vars(x).values() for t in leaves(v)]


def assert_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.uint32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y) or torch.equal(
            x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                  y.nan_to_num())


def test_spans_off_record_nothing_and_call_no_profiler(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a profiler or CUDA call with tracing off")

    monkeypatch.setattr(tracing, "_RANGE", refused)
    monkeypatch.setattr(tracing, "_event_pair", refused)
    assert tracing.span("a") is tracing.span("b") is tracing._OFF
    env_steps(PackedEnv(ENV, device="cpu"))
    with tracing.span("outer"), tracing.span("host_read.x"):
        pass
    assert tracing.take() == tracing.Taken([], 0)


# Copies of host constants to the device (each waits for the stream on
# the card): counted by the card's audit, here only placed.
CONSTS = ("host_read.levelgen_consts", "host_read.sweep_consts",
          "host_read.vec")


def split(spans):
    """(phases, host reads, the places of the constants' copies)."""
    got = tree(spans)
    reads = {k: v for k, v in got.items() if k[0].startswith("host_read.")}
    return (collections.Counter({k: v for k, v in got.items()
                                 if k not in reads}),
            collections.Counter({k: v for k, v in reads.items()
                                 if k[0] not in CONSTS}),
            {k for k in reads if k[0] in CONSTS})


def test_update_and_env_steps_give_the_span_tree(policy):
    mgr = manager(policy)
    with tracing.recording() as rec:
        mgr.update_iter()
    phases, reads, consts = split(rec.take().spans)
    mb = EPOCHS                      # one minibatch an epoch
    assert phases == collections.Counter({
        ("update", None): 1,
        ("rollout", "update"): 1,
        ("rollout.forward", "rollout"): STEPS + 1,
        # The routed ensemble: the plan and its gathers, the gather back.
        ("ensemble.route", "rollout.forward"): 2 * (STEPS + 1),
        ("rollout.record", "rollout"): STEPS,
        ("rollout.buffer", "rollout"): 1,
        ("env.step", "rollout"): STEPS,
        ("env.megastep", "env.step"): STEPS,
        # The plain megastep sweeps through the standalone sweep; K4, on
        # the card, inside the kernel.
        ("env.sweep", "env.megastep"): STEPS,
        ("env.observations", "env.step"): STEPS,
        # The episode end at the third step: a full reset.
        ("env.reset", "env.step"): 1,
        ("env.levelgen", "env.reset"): 1,
        ("env.sweep", "env.reset"): 1,
        ("normalizer", "update"): 1,
        ("ppo", "update"): 1,
        ("ppo.gae", "ppo"): 1,
        ("ppo.batch", "ppo"): 2,     # the groups, then the one minibatch
        ("ppo.loss", "ppo"): mb,
        ("ppo.adam", "ppo"): mb,
        ("elo", "update"): 1,
        ("pbt", "update"): 1,
    })
    assert reads == collections.Counter({
        ("host_read.reset_trigger", "env.step"): STEPS,
        ("host_read.obs_consts", "env.observations"): 2 * STEPS,
        ("host_read.route", "ensemble.route"): STEPS + 1,
        ("host_read.bin_centers", "rollout.forward"): STEPS + 1,
        ("host_read.bin_centers", "ppo.loss"): mb,
        ("host_read.key", "env.reset"): 1,
        ("host_read.levels", "env.levelgen"): 2,     # unique, tolist
        ("host_read.pbt_rank", "pbt"): 3,
    })
    assert consts == {("host_read.levelgen_consts", "env.levelgen"),
                      ("host_read.sweep_consts", "env.sweep"),
                      ("host_read.vec", "env.levelgen"),
                      ("host_read.vec", "env.sweep"),
                      ("host_read.vec", "env.megastep")}

    env = PackedEnv(ENV, device="cpu")
    ps0, _ = env.init()
    with tracing.recording() as rec:
        env_steps(env)
    phases, reads, consts = split(rec.take().spans)
    n_merged = len(list(ps0.leaves())) + len(SweepResults._fields)
    assert phases == collections.Counter({
        ("env.init", None): 1, ("env.levelgen", "env.init"): 1,
        ("env.sweep", "env.init"): 1, ("env.observations", "env.init"): 1,
        ("env.step", None): 3, ("env.megastep", "env.step"): 3,
        ("env.sweep", "env.megastep"): 3,
        ("env.observations", "env.step"): 3,
        ("env.reset", "env.step"): 2, ("env.levelgen", "env.reset"): 2,
        ("env.sweep", "env.reset"): 2,
    })
    assert reads == collections.Counter({
        ("host_read.reset_trigger", "env.step"): 3,
        ("host_read.obs_consts", "env.observations"): 2 * 4,
        ("host_read.key", "env.init"): 1,
        ("host_read.key", "env.reset"): 2,
        ("host_read.levels", "env.levelgen"): 2 * 3,     # init, resets
        ("host_read.compact_cols", "env.reset"): 1,
        ("host_read.compact_merge", "env.reset"): n_merged,
    })
    assert {p for _, p in consts} == {"env.levelgen", "env.sweep",
                                      "env.megastep"}
    assert env.reset_counts == {"full": 1, "compact": 1}


def test_openai_hns_attention_spans_nest_in_forward_and_loss():
    """The ``openai_hns`` policy's update: a ``model.attn`` span for each
    attention block's forward, inside ``rollout.forward`` (the actor and
    the critic, each over every policy's routed agents, each step)
    and ``ppo.loss`` (both encoders, each epoch); its visible-key tally
    moves on the device with no host read, and the update's reads are the
    flagship's less the Dreamer critic's bin centres."""
    import dataclasses

    pol = tpolicy.make_policy(backbone="openai_hns", num_rnn_channels=32,
                              device="cpu")
    env = PackedEnv(ENV.replace(sim_flags=SimFlags.RandomFlipTeams |
                                SimFlags.UseFixedWorld), device="cpu")
    cfg = dataclasses.replace(
        train_config(), dreamer_v3_critic=False,
        actions=tcfg.ActionsConfig(tpolicy.FORCE_ACTION_BUCKETS))
    mgr = tmanager.init_training("cpu", cfg, env, pol)
    ro = mgr.state.rollout
    mgr = mgr.replace(state=mgr.state.replace(rollout=ro.replace(
        env_state=ro.env_state.replace(step=torch.full_like(
            ro.env_state.step, ENV.episode_len - 3)))))
    routed = ROUTE.read()
    with tracing.recording() as rec:
        mgr.update_iter()
    phases, reads, _ = split(rec.take().spans)
    _, needed, run = (a - b for a, b in zip(ROUTE.read(), routed))
    attn = {k: v for k, v in phases.items() if k[0] == "model.attn"}
    assert attn == {("model.attn", "rollout.forward"): 2 * (STEPS + 1),
                    ("model.attn", "ppo.loss"): 2 * EPOCHS}
    assert not any(parent == "model.attn" for _, parent in reads)
    assert reads == collections.Counter({
        ("host_read.reset_trigger", "env.step"): STEPS,
        ("host_read.obs_consts", "env.observations"): 2 * STEPS,
        ("host_read.route", "ensemble.route"): STEPS + 1,
        ("host_read.key", "env.reset"): 1,
        ("host_read.levels", "env.levelgen"): 2,
        ("host_read.pbt_rank", "pbt"): 3,
    })
    keys = pol.actor_critic.backbone.actor_encoder.net.visible_keys
    tally = keys.sums
    assert tally.device.type == "cpu" and tally.dtype == torch.float64
    n = ENV.num_worlds * ENV.max_agents
    # Each rollout forward: the actor on every policy's routed rows (its
    # agents and the padding up to the cap); each epoch: the two train
    # policies' groups of n / 2 slots, every step.
    assert needed == n * (STEPS + 1)
    assert float(tally[1]) == run + EPOCHS * 2 * (n // 2) * STEPS
    assert 1.0 <= keys.read() <= 17.0
    assert pol.actor_critic.backbone.critic_encoder.net.visible_keys is None


def test_impala_cnn_torso_and_render_spans_nest_in_the_update():
    """The ``impala_cnn`` policy's update on an env that renders frames: a
    ``model.torso`` span for each torso forward, inside
    ``rollout.forward`` (every step and the bootstrap) and ``ppo.loss``
    (each epoch); K5's ``rgbd.render`` inside every ``env.step``; neither
    reads a device value; the update's reads are the flagship's less the
    Dreamer critic's bin centres; the torso's frame count is each
    forward's routed rows and each epoch's two groups."""
    import dataclasses

    pol = tpolicy.make_policy(backbone="impala_cnn", num_rnn_channels=32,
                              device="cpu")
    env = PackedEnv(ENV.replace(render_frames=True), device="cpu")
    cfg = dataclasses.replace(train_config(), dreamer_v3_critic=False)
    mgr = tmanager.init_training("cpu", cfg, env, pol)
    ro = mgr.state.rollout
    mgr = mgr.replace(state=mgr.state.replace(rollout=ro.replace(
        env_state=ro.env_state.replace(step=torch.full_like(
            ro.env_state.step, ENV.episode_len - 3)))))
    routed = ROUTE.read()
    net = pol.actor_critic.backbone.encoder.net
    frames0 = net.torso_frames
    with tracing.recording() as rec:
        mgr.update_iter()
    phases, reads, _ = split(rec.take().spans)
    _, _, run = (a - b for a, b in zip(ROUTE.read(), routed))
    assert {k: v for k, v in phases.items() if k[0] == "model.torso"} == {
        ("model.torso", "rollout.forward"): STEPS + 1,
        ("model.torso", "ppo.loss"): EPOCHS}
    assert {k: v for k, v in phases.items() if k[0] == "rgbd.render"} == {
        ("rgbd.render", "env.step"): STEPS}
    assert not any(parent in ("model.torso", "rgbd.render")
                   for _, parent in reads)
    assert reads == collections.Counter({
        ("host_read.reset_trigger", "env.step"): STEPS,
        ("host_read.obs_consts", "env.observations"): 2 * STEPS,
        ("host_read.route", "ensemble.route"): STEPS + 1,
        ("host_read.key", "env.reset"): 1,
        ("host_read.levels", "env.levelgen"): 2,
        ("host_read.pbt_rank", "pbt"): 3,
    })
    n = ENV.num_worlds * ENV.max_agents
    assert net.torso_frames - frames0 == run + EPOCHS * 2 * (n // 2) * STEPS


def test_profiler_sees_spans_as_host_ranges_nested_as_stored():
    """One plain step (a reset step's level generation holds some 10^5
    host events, too many to read here)."""
    env = PackedEnv(ENV, device="cpu")
    ps, _ = env.init()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("env.step") is not tracing._OFF
        env.step(ps, actions())
    taken = tracing.take()
    assert taken.dropped == 0 and tracing.take().spans == []
    names = {s.name for s in taken.spans}
    assert names == {"env.step", "env.megastep", "env.sweep",
                     "host_read.reset_trigger", "env.observations",
                     "host_read.obs_consts", "host_read.sweep_consts",
                     "host_read.vec"}
    events = [e for e in prof.events() if e.name in names]
    assert tree(taken.spans) == collections.Counter(
        (e.name, _span_parent(e, names)) for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in events)
    # The profiler's ranges nest as the host clocks of the store.
    for s in taken.spans:
        assert s.end_ns >= s.start_ns and s.device_ms is None


def _span_parent(event, names):
    e = event.cpu_parent
    while e is not None and e.name not in names:
        e = e.cpu_parent
    return None if e is None else e.name


def test_tracing_changes_no_state_or_output(policy):
    off = manager(policy).update_iter()
    with tracing.recording() as rec:
        on = manager(policy).update_iter()
    assert rec.take().spans
    assert_bitwise(off.state_tree(), on.state_tree())

    off = env_steps(PackedEnv(ENV, device="cpu"))
    with tracing.recording():
        on = env_steps(PackedEnv(ENV, device="cpu"))
    assert_bitwise(off, on)


def test_take_clears_and_the_cap_drops_the_oldest():
    with tracing.recording(cap=3) as rec:
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    taken = rec.take()
    assert [s.name for s in taken.spans] == ["s2", "s3", "s4"]
    assert taken.dropped == 2
    assert rec.take() == tracing.Taken([], 0)
    # A recording inside a profiled stretch keeps its spans to itself.
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("profiled"):
            with tracing.recording() as inner:
                with tracing.span("scoped"):
                    pass
    assert [s.name for s in tracing.take().spans] == ["profiled"]
    assert [(s.name, s.parent) for s in inner.take().spans] == [
        ("scoped", None)]


def test_run_inference_times_its_forward_and_env_step_by_spans(policy):
    env = PackedEnv(ENV.replace(reset_budget=256), device="cpu")
    params = dict(policy.actor_critic.named_parameters())
    norm = policy.obs_preprocess
    obs = {k: v.flatten(0, 1) for k, v in norm.prep(env.init()[1].obs).items()}
    stats = norm.init_state(obs)
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_inference(env, policy, params, stats, 3, timing=True)
    assert out["forward_ms"] > 0 and out["env_ms"] > 0
    assert tracing.take().spans == []
    plain = run_inference(env, policy, params, stats, 3)
    assert "forward_ms" not in plain
    assert plain["episodes_finished"] == out["episodes_finished"]

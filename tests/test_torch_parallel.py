"""PyTorch port: data parallelism (``parallel/mesh.py``,
``utils/runtime.py`` and the mesh through training) on the CPU: two gloo
ranks, spawned, against one process.

The rule is JAX's: R ranks with W / R worlds each compute what one process
computes with W worlds. The sharded packed step runs no collective and
equals the one-process step bit for bit; so does a rollout before the
first update (per-world arithmetic, the same threefry words). An update
differs by the order of its sums only, so its parameters, moments and
losses are held at ``tests/test_torch_train.py``'s bars, or at the
update's rounding bars (``testing.rounding_bars``) where those are larger.
ELO (sums of whole numbers and halves), matchups and PBT state are equal.
One spawn runs every rank-side case; the one-process side is held to JAX
by ``tests/test_torch_train.py``. No JAX env is compiled.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from marl_hideandseek_tpu import types as jtypes
from marl_hideandseek_tpu.parallel import mesh as jmesh
from jax.sharding import PartitionSpec

from marl_hideandseek_torch import bridge, testing
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.parallel import mesh as tmesh
from marl_hideandseek_torch.policy import make_policy
from marl_hideandseek_torch.train import init_training
from marl_hideandseek_torch.train import cfg as tcfg
from marl_hideandseek_torch.train import manager as tmanager
from marl_hideandseek_torch.train import ppo
from marl_hideandseek_torch.train.rollout import RolloutBuffer
from marl_hideandseek_torch.utils import runtime

torch.set_num_threads(1)

RANKS = 2
# The sharded step: the reduced capacity of tests/test_pallas_kernels.py
# (W = 128: 3 boxes, 1 ramp, 1v1), a 6-step episode, 8 steps.
STEP_ENV = EnvConfig(num_worlds=128, min_hiders=1, max_hiders=1,
                     min_seekers=1, max_seekers=1, max_boxes=3, max_ramps=1,
                     episode_len=6, sim_flags=SimFlags.ZeroAgentVelocity)
STEP_STEPS = 8
# Training: tests/test_torch_train.py's slice (1v1, 3 boxes, 2 ramps,
# train.py's flags, LSTM width 32) at 32 worlds, the worlds set to step
# 100 of a 112-step episode (the seek phase, which scores) so that the
# second update crosses its end, 8 steps an update in 2 BPTT chunks,
# grouped PBT 2 + 2 with PBT after the second update. 16 worlds a
# rank: PyTorch's CPU kernels run a vectorised loop's tail in scalar code,
# whose transcendental functions round otherwise, so a shard whose sizes
# leave other tails than the whole batch's (4 of 8 worlds did) differs
# from it in the last bit.
TRAIN_ENV = EnvConfig(num_worlds=32, min_hiders=1, max_hiders=1,
                      min_seekers=1, max_seekers=1, max_boxes=3, max_ramps=2,
                      episode_len=112,
                      sim_flags=(SimFlags.RandomFlipTeams |
                                 SimFlags.UseFixedWorld |
                                 SimFlags.ZeroAgentVelocity), rand_seed=5)
START_STEP = 100
RNN = 32
UPDATES = 2
MINIBATCHES = (1, 2)


def train_config(num_mb):
    explore = dict(min_scale=0.1, max_scale=10.0, log10_scale=True)
    return tcfg.TrainConfig(
        num_worlds=TRAIN_ENV.num_worlds, num_agents_per_world=2,
        num_updates=UPDATES, actions=tcfg.ActionsConfig(),
        steps_per_update=8, num_bptt_chunks=2,
        lr=tcfg.ParamExplore(1e-4, **explore),
        algo=tcfg.PPOConfig(entropy_coef=tcfg.ParamExplore(0.01, **explore),
                            num_mini_batches=num_mb),
        pbt=tcfg.PBTConfig(num_teams=2, team_size=1, num_train_policies=2,
                           num_past_policies=2, past_play_portion=1.0,
                           explore_interval=2,
                           past_policy_update_interval=2),
        ppo_group_trainable=True)


def train(mesh, num_mb, ckpt_dir=None, restore=None):
    """``init_training`` and UPDATES updates over ``mesh`` (one with
    ``restore``, from that file); with ``ckpt_dir`` a checkpoint after
    the first. Returns the state trees before and after each update and
    each ``ppo_update``'s inputs and result."""
    env = PackedEnv(TRAIN_ENV, device="cpu")
    policy = make_policy(num_rnn_channels=RNN, device="cpu")
    updates = []

    def recording(cfg, policy, *args):
        out = ppo.ppo_update(cfg, policy, *args)
        updates.append({"args": args[:-1], "out": out})
        return out

    mgr = init_training("cpu", train_config(num_mb), env, policy,
                        restore_ckpt=restore, mesh=mesh)
    if restore is None:
        ro = mgr.state.rollout
        mgr = mgr.replace(state=mgr.state.replace(rollout=ro.replace(
            env_state=ro.env_state.replace(step=torch.full_like(
                ro.env_state.step, START_STEP)))))
    states = [mgr.state_tree()]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmanager, "ppo_update", recording)
        for i in range(1 if restore else UPDATES):
            mgr = mgr.update_iter()
            states.append(mgr.state_tree())
            if ckpt_dir is not None and i == 0:
                mgr.save_ckpt(ckpt_dir)
    for u in updates:                  # the buffer as a dict of leaves
        u["args"] = u["args"][:5] + (dict(vars(u["args"][5])),) + \
            u["args"][6:]
    return {"states": states, "updates": updates}


def sharded_steps(mesh):
    """The packed env at STEP_ENV over ``mesh``: init and STEP_STEPS steps
    of seeded actions (the same global draw on every rank, sliced); the
    states after each, gathered once at the end."""
    env = PackedEnv(STEP_ENV, device="cpu")
    step = tmesh.make_sharded_packed_step(env, mesh)
    ps, res = tmesh.sharded_packed_init(env, mesh)
    lo, hi = mesh.world_range(STEP_ENV.num_worlds)
    gen = torch.Generator().manual_seed(3)
    out = [ps]
    for _ in range(STEP_STEPS):
        acts = torch.randint(0, 5, (2, 5, STEP_ENV.num_worlds),
                             generator=gen)
        acts[:, 3:] %= 2
        ps, res = step(ps, acts[..., lo:hi])
        out.append(ps)
    return {"states": [bridge.state_to_tree(s) for s in out],
            "gathered": bridge.state_to_tree(
                tmesh.gather_packed_state(ps, mesh)),
            "obs": res.obs, "rewards": res.rewards,
            "resets": dict(env.reset_counts)}


def _rank(rank, nprocs, address, out_dir, ref_ckpt):
    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    dev = runtime.init_distributed(address, nprocs, rank, backend="gloo",
                                   device="cpu")
    try:
        mesh = tmesh.make_mesh()
        got = {"device": str(dev), "rank": mesh.rank, "size": mesh.size,
               "primary": runtime.is_primary_host(),
               "metric_mean": runtime.global_metric_mean(10.0 * (rank + 1))}
        runtime.sync_hosts("start")
        got["steps"] = sharded_steps(mesh)
        for num_mb in MINIBATCHES:
            got[f"train{num_mb}"] = train(
                mesh, num_mb, ckpt_dir=str(out / f"ranks{num_mb}"))
        got["resumed"] = train(mesh, 1, restore=ref_ckpt)
        torch.save(got, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The one-process references, then one spawn of RANKS gloo ranks
    running every case; (reference, [rank results])."""
    out = tmp_path_factory.mktemp("dp")
    ref = {"steps": sharded_steps(tmesh.LOCAL)}
    for num_mb in MINIBATCHES:
        ref[f"train{num_mb}"] = train(tmesh.LOCAL, num_mb,
                                      ckpt_dir=str(out / f"one{num_mb}"))
    ref_ckpt = str(out / "one1" / "1.pt")
    testing.spawn_ranks(_rank, RANKS, (str(out), ref_ckpt), timeout=300)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    ref["resumed"] = train(tmesh.LOCAL, 1,
                           restore=str(out / "ranks1" / "1.pt"))
    return ref, ranks


def _leaves(tree, prefix=""):
    """Nested dicts, tuples and dataclasses -> {"a.b.0": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _bits(x):
    x = torch.as_tensor(x)
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def assert_equal(got, want, where):
    """Every leaf of two trees equal bit for bit."""
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), where
    for k in w:
        a, b = _bits(g[k]), _bits(w[k])
        assert a.dtype == b.dtype and torch.equal(a, b), (where, k)


def rollout_slice(ro, r):
    """Rank r's slice of one process's rollout tree: the packed env state
    on its last axis, observations and matchups on axis 0, LSTM states
    ``[L, N, H]`` on axis 1."""
    w = ro["env_state"]["step"].shape[-1] // RANKS
    n = ro["assignments"].shape[0] // RANKS
    agents = slice(r * n, (r + 1) * n)
    return {"env_state": tree_map(lambda x: x[..., r * w:(r + 1) * w],
                                  ro["env_state"]),
            "obs": {k: v[agents] for k, v in ro["obs"].items()},
            "rnn_states": tree_map(lambda x: x[:, agents], ro["rnn_states"]),
            "assignments": ro["assignments"][agents], "key": ro["key"]}


def buffer_slice(buf, r):
    """Rank r's slice of one process's buffer: agents on axis 2 (the
    bootstrap values on axis 0)."""
    n = buf["bootstrap_value"].shape[0] // RANKS
    agents = slice(r * n, (r + 1) * n)
    return {k: v[agents] if k == "bootstrap_value" else
            tree_map(lambda x: x[:, :, agents], v) for k, v in buf.items()}


def check_update(got, want, num_mb):
    """A ``ppo_update`` result against one process's at its rounding
    bars (the CPU tests' fixed bars where larger); returns the worst
    reading of each kind."""
    params, opt, stats, vs, hyper, buf, key = want["args"]
    cfg = train_config(num_mb)
    policy = make_policy(num_rnn_channels=RNN, device="cpu")

    def update(obs):
        return ppo.ppo_update(cfg, policy, params, opt, stats, vs, hyper,
                              RolloutBuffer(**{**buf, "obs": obs}), key)

    _, bars = testing.rounding_bars(update, buf["obs"], testing.ALL_KINDS)
    cmp = testing.compare_updates(got["out"], want["out"], params, bars,
                                  float(hyper["lr"].max()),
                                  cfg.algo.num_epochs)
    assert cmp["violations"] == [], cmp
    return cmp["worst"]


# -- (a) the world-axis rule -------------------------------------------------------

def _jax_state(tree, cls=jtypes.EnvState):
    subs = {"bodies": jtypes.RigidBodies, "statics": jtypes.StaticGeom,
            "grab": jtypes.GrabState}
    return cls(**{f.name: (_jax_state(tree[f.name], subs[f.name])
                           if f.name in subs else
                           np.asarray(_bits(tree[f.name])))
                  for f in dataclasses.fields(cls)})


def test_packed_env_specs_match_jax():
    """The port's rule (worlds on the last axis of every leaf) equals
    JAX's ``packed_env_specs`` (mesh.py:82-87) on every leaf of a packed
    state, passed to JAX as numpy leaves."""
    ps, _ = PackedEnv(STEP_ENV.replace(num_worlds=4), device="cpu").init()
    got = tmesh.packed_env_specs(ps).leaves()
    want = jax.tree.leaves(jmesh.packed_env_specs(
        _jax_state(bridge.state_to_tree(ps))),
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(got) == len(want) == len(ps.leaves()) > 30
    for g, w, leaf in zip(got, want, ps.leaves()):
        assert g == tuple(w), (g, w)
        assert len(g) == leaf.dim() and g[-1] == "data"


# -- (b) the sharded packed step --------------------------------------------------

def test_sharded_packed_step_equals_one_process(run):
    """2 x 64 worlds stepped through ``make_sharded_packed_step`` across
    the episode-end reset equal one process's 128 worlds bit for bit on
    every leaf of every state, observation and reward; the gathered state
    equals the whole."""
    ref, ranks = run
    one = ref["steps"]
    assert one["resets"]["full"] + one["resets"]["compact"] >= 1
    w = STEP_ENV.num_worlds // RANKS
    for r, got in enumerate(ranks):
        assert got["steps"]["resets"] == one["resets"]
        for i, (g, s) in enumerate(zip(got["steps"]["states"],
                                       one["states"])):
            assert_equal(g, tree_map(lambda x: x[..., r * w:(r + 1) * w],
                                     s), (r, i))
        assert_equal(got["steps"]["gathered"], one["states"][-1], r)
        assert_equal(got["steps"]["obs"], {k: v[r * w:(r + 1) * w] for
                                           k, v in one["obs"].items()}, r)
        assert_equal(got["steps"]["rewards"],
                     one["rewards"][:, r * w:(r + 1) * w], r)


# -- (c) training: rollout, update, ELO and PBT ------------------------------------

def gathered_update(ranks_run, i):
    """Update ``i`` of the ranks as one process would make it from the
    ranks' inputs: their replicated state (equal on every rank) and their
    buffers joined."""
    args = [got["updates"][i]["args"] for got in ranks_run]
    for other in args[1:]:
        assert_equal(other[:5] + other[6:], args[0][:5] + args[0][6:],
                     "replicated inputs")
    bufs = [a[5] for a in args]
    buf = {k: torch.cat([b[k] for b in bufs]) if k == "bootstrap_value"
           else tree_map(lambda *xs: torch.cat(xs, 2), *[b[k] for b in bufs])
           for k in bufs[0]}
    return args[0][:5] + (buf,) + args[0][6:]


@pytest.mark.parametrize("num_mb", MINIBATCHES)
def test_ranks_train_as_one_process(run, num_mb):
    """Two updates of grouped PBT 2 + 2 at 2 x 16 worlds against one
    process at 32 (one and two minibatches). The first rollout's buffer
    and post-rollout state equal one process's bit for bit, and the first
    update is at the bars against its update. After it the runs carry
    rounding apart, so each later update is held, at its bars, to one
    process's update of the ranks' own inputs; the second rollout's
    actions, rewards, dones, matchups and observations still equal one
    process's. After each update ELO, hyperparameters, Adam counts,
    matchups and the update count equal one process's, and the ranks'
    replicated state equals bit for bit."""
    ref, ranks = run
    one = ref[f"train{num_mb}"]
    mine = [got[f"train{num_mb}"] for got in ranks]
    for r, run_r in enumerate(mine):
        assert_equal(run_r["updates"][0]["args"][5],
                     buffer_slice(one["updates"][0]["args"][5], r), r)
        assert_equal(run_r["states"][1]["rollout"],
                     rollout_slice(one["states"][1]["rollout"], r), r)
        check_update(run_r["updates"][0], one["updates"][0], num_mb)
        for i in range(1, UPDATES):
            got_b = run_r["updates"][i]["args"][5]
            want_b = buffer_slice(one["updates"][i]["args"][5], r)
            assert_equal({k: got_b[k] for k in ("actions", "rewards",
                                                "dones", "assignments",
                                                "obs")},
                         {k: want_b[k] for k in ("actions", "rewards",
                                                 "dones", "assignments",
                                                 "obs")}, (r, i))
        for i in range(UPDATES):
            st, want = run_r["states"][i + 1], one["states"][i + 1]
            for k in ("elo", "hyper_params", "update_idx"):
                assert_equal(st[k], want[k], (r, i, k))
            assert_equal(st["opt_states"]["count"],
                         want["opt_states"]["count"], (r, i))
            assert_equal(st["rollout"]["assignments"],
                         rollout_slice(want["rollout"], r)["assignments"],
                         (r, i))
    policy = make_policy(num_rnn_channels=RNN, device="cpu")
    for i in range(1, UPDATES):
        args = gathered_update(mine, i)
        want = {"args": args, "out": ppo.ppo_update(
            train_config(num_mb), policy, *args[:5],
            RolloutBuffer(**args[5]), args[6])}
        for run_r in mine:
            check_update(run_r["updates"][i], want, num_mb)
    a, b = (run_r["states"][-1] for run_r in mine)
    a.pop("rollout"), b.pop("rollout")
    assert_equal(a, b, "replicated state")
    assert float((a["elo"] - 1500.0).abs().max()) > 0.0


# -- (d) runtime ---------------------------------------------------------------------

def test_runtime_at_two_ranks_and_one_process(run):
    """``init_distributed`` gives each rank its device and the group;
    ``is_primary_host`` is rank 0; ``global_metric_mean`` is the mean of
    the ranks' values; ``sync_hosts`` returns. In one process without a
    group: primary, the identity, nothing to wait for, the ``LOCAL``
    mesh."""
    _, ranks = run
    for r, got in enumerate(ranks):
        assert (got["rank"], got["size"], got["device"]) == (r, RANKS, "cpu")
        assert got["primary"] == (r == 0)
        assert got["metric_mean"] == 15.0
    assert not dist.is_initialized()
    assert runtime.is_primary_host()
    assert runtime.global_metric_mean(3.5) == 3.5
    runtime.sync_hosts("one")
    assert tmesh.make_mesh() is tmesh.LOCAL
    with pytest.raises(ValueError):
        tmesh.make_mesh(model_parallel=2)


# -- (e) checkpoints across rank counts ----------------------------------------------

def test_checkpoints_move_between_rank_counts(run):
    """A checkpoint written by 2 ranks holds one process's rollout and
    restores in one process, which continues as the ranks continue; one
    written by one process restores on 2 ranks, which continue as it
    continues: the next rollout bit for bit, the update at its bars."""
    ref, ranks = run
    one, resumed = ref["train1"], ref["resumed"]
    ranks_run = [got["train1"] for got in ranks]
    # 2 ranks -> 1 process.
    assert_equal(resumed["states"][0]["rollout"],
                 one["states"][1]["rollout"], "file")
    for r, mine in enumerate(ranks_run):
        assert_equal(mine["updates"][1]["args"][5],
                     buffer_slice(resumed["updates"][0]["args"][5], r), r)
        check_update(mine["updates"][1], resumed["updates"][0], 1)
    # 1 process -> 2 ranks.
    for r, got in enumerate(ranks):
        mine = got["resumed"]
        assert mine["states"][0]["update_idx"] == 1
        assert_equal(mine["updates"][0]["args"][5],
                     buffer_slice(one["updates"][1]["args"][5], r), r)
        check_update(mine["updates"][0], one["updates"][1], 1)

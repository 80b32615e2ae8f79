"""PyTorch port: training (train/rollout.py, ppo.py, pbt.py, manager.py and
the training checkpoint) against the JAX package.

Both sides get the same numpy inputs from a seed, and the same keys: the
port's draws follow JAX's key tree (``prng.py``), so ``init_training``
from one seed gives JAX's initial state and a rollout's actions,
matchups and the PBT draws equal JAX's functions on the same keys. The
parameters of the update tests are drawn by the port's initialisers
(with the all-zero and all-one leaves moved by a seeded normal, so that
biases and the critic take part) and cross as the flax tree. The policy
is the flagship at an LSTM width of 32 (the MLP and embeddings at full
width), except where the tracked checkpoint needs 256. No JAX env is
compiled: the slice runs on the port's CPU ``PackedEnv`` and JAX sees
its observations as numpy. JAX's ``ppo_update`` is compiled three times
(P = 1 masked, PBT masked, and the grouped case that the slice shares).

The loss has kinks: leaky-relu's slope steps from 0.01 to 1 at 0, and a
max-pool's gradient moves between entities where the two largest values
meet. An input within rounding distance of one (~1e-7 here: XLA and
PyTorch sum in other orders) may fall on either side of it on the two
sides, and one such element moves a leaf's gradient by about 1 % of its
largest (a LayerNorm output 7e-8 from 0 did so on one seed tried). The
seeds below meet none.

Bars: GAE, the return statistics and the losses within 1e-5 relative;
gradients within 1e-4 of each leaf's largest |g|; Adam's steps within
1e-6 relative of optax's; after a whole ``ppo_update``, parameters
within 1e-6 on all but 0.1 % of each leaf's elements (rounded up: one
element of a 512-element leaf) and within 2 x lr x epochs on all (Adam
divides by the root of the second moment, so an element whose gradient
is near 0 turns a rounding difference into a step of another size),
Adam's moments within 1e-4 (mu) and 2e-4 (nu) of each leaf's largest,
counts, group indices and dropped fractions exact; stored
log-probabilities and values within 1e-5 of JAX's ``apply_ensemble`` on
the stored observations.
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu import policy as jpolicy
from marl_hideandseek_tpu.models import DiscreteActionDistributions as JDists
from marl_hideandseek_tpu.models.normalizer import NormalizerState as JStats
from marl_hideandseek_tpu.train import cfg as jcfg
from marl_hideandseek_tpu.train import pbt as jpbt
from marl_hideandseek_tpu.train import ppo as jppo
from marl_hideandseek_tpu.train import rollout as jrollout

from marl_hideandseek_torch import bridge, prng, testing
from marl_hideandseek_torch import policy as tpolicy
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.models.layers import draw_params
from marl_hideandseek_torch.models.normalizer import NormalizerState as TStats
from marl_hideandseek_torch.train import cfg as tcfg
from marl_hideandseek_torch.train import manager as tmanager
from marl_hideandseek_torch.train import pbt as tpbt
from marl_hideandseek_torch.train import ppo as tppo
from marl_hideandseek_torch.train import rollout as trollout

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "ckpts" / "r4_learn" / "50000"
RNN = 32
C, T = 2, 4                    # BPTT chunks, steps a chunk
BUCKETS = (5, 5, 5, 2, 2)
# The slice's env: 4 worlds, 1v1, the reduced capacity of
# tests/test_pallas_kernels.py:20-26 with 2 ramps (as
# tests/test_torch_infer.py), train.py's flags, a 104-step episode.
ENV = EnvConfig(num_worlds=4, min_hiders=1, max_hiders=1, min_seekers=1,
                max_seekers=1, max_boxes=3, max_ramps=2, episode_len=104,
                sim_flags=(SimFlags.RandomFlipTeams | SimFlags.UseFixedWorld
                           | SimFlags.ZeroAgentVelocity), rand_seed=5)
A = ENV.max_agents
REL = 1e-5
GRAD = 1e-4


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------

def t(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def configs(kind, worlds=ENV.num_worlds, agents=A, **algo):
    """(JAX, port) TrainConfig: ``single`` (no PBT), ``masked`` (2 train +
    2 past policies, half self-play) or ``grouped`` (2 + 2, past-play
    only, grouped PPO), with ``agents`` a world in two teams."""
    common = dict(num_worlds=worlds, num_agents_per_world=agents,
                  num_updates=2, steps_per_update=C * T, num_bptt_chunks=C)
    out = []
    for mod in (jcfg, tcfg):
        pbt = None
        if kind != "single":
            pbt = mod.PBTConfig(
                num_teams=2, team_size=agents // 2, num_train_policies=2,
                num_past_policies=2,
                self_play_portion=0.5 if kind == "masked" else 0.0,
                past_play_portion=0.5 if kind == "masked" else 1.0)
        explore = dict(min_scale=0.1, max_scale=10.0, log10_scale=True)
        out.append(mod.TrainConfig(
            **common, actions=mod.ActionsConfig(), pbt=pbt,
            lr=mod.ParamExplore(1e-4, **explore) if pbt else 1e-4,
            algo=mod.PPOConfig(**{
                "entropy_coef": (mod.ParamExplore(0.01, **explore) if pbt
                                 else 0.01), **algo}),
            dreamer_v3_critic=not (algo.get("clip_value_loss") or
                                   algo.get("huber_value_loss")),
            ppo_group_trainable=kind == "grouped"))
    return tuple(out)


_POLICIES = {}


def policies(rnn=RNN):
    """(JAX policy, port policy on the CPU) at LSTM width ``rnn``."""
    if rnn not in _POLICIES:
        _POLICIES[rnn] = (jpolicy.make_policy(num_rnn_channels=rnn),
                          tpolicy.make_policy(num_rnn_channels=rnn,
                                              device="cpu"))
    return _POLICIES[rnn]


def raw_obs(rng, lead):
    """Observations as the packed env emits them at ENV's capacity."""
    def normal(*f):
        return rng.standard_normal(lead + f).astype(np.float32)

    def mask(e):
        return (rng.uniform(size=lead + (e,)) < 0.5).astype(np.float32)

    return {
        "prep_counter": rng.integers(0, 97, lead + (1,)).astype(np.int32),
        "self_data": normal(13),
        "self_type": rng.integers(0, 2, lead + (1,)).astype(np.int32),
        "self_mask": np.ones(lead + (1,), np.float32),
        "self_lidar": rng.uniform(size=lead + (30,)).astype(np.float32),
        "agent_data": normal(70), "box_data": normal(51),
        "ramp_data": normal(28), "vis_agents_mask": mask(5),
        "vis_boxes_mask": mask(3), "vis_ramps_mask": mask(2),
    }


def prepped(obs):
    tpol = policies()[1]
    return {k: v.numpy() for k, v in tpol.obs_preprocess.prep(
        {k: t(v) for k, v in obs.items()}).items()}


def seeded_stats(rng):
    """Normalizer statistics (port, JAX) with means around 0 and
    variances in [0.5, 2)."""
    tpol = policies()[1]
    st = tpol.obs_preprocess.init_state(
        {k: t(v) for k, v in prepped(raw_obs(rng, (1,))).items()})
    mean = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in st.mean.items()}
    var = {k: (0.5 + 1.5 * rng.uniform(size=v.shape)).astype(np.float32)
           for k, v in st.var.items()}
    return port_stats(mean, var, 3.0), jax_stats(mean, var, 3.0)


def port_stats(mean, var, count):
    return TStats(mean={k: t(v) for k, v in mean.items()},
                  var={k: t(v) for k, v in var.items()},
                  count=torch.tensor(float(count)))


def jax_stats(mean, var, count):
    return JStats(mean={k: jnp.asarray(v) for k, v in mean.items()},
                  var={k: jnp.asarray(v) for k, v in var.items()},
                  count=jnp.asarray(count, jnp.float32))


def stats_np(st):
    return ({k: v.numpy() for k, v in st.mean.items()},
            {k: v.numpy() for k, v in st.var.items()}, float(st.count))


def perturbed(params, seed=0, scale=0.05):
    """Flax params with every all-zero and all-one leaf moved by a seeded
    normal, as numpy."""
    rng = np.random.default_rng(seed)

    def bump(x):
        x = np.asarray(x, np.float32)
        if np.all(x == 0) or np.all(x == 1):
            x = x + scale * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree.map(bump, params)


def seeded_params(num, seed):
    """``num`` stacked policies drawn by the port's initialisers from
    ``seed``, perturbed, as the flax tree of numpy arrays (JAX's own init
    is an eager vmap that takes seconds a call)."""
    flat = draw_params(policies()[1].actor_critic,
                       prng.split(prng.key(seed), num))
    return perturbed(np_tree(to_flax(flat)), seed)


def to_flax(flat):
    """Port flat parameters -> the flax tree ``{"params": {...}}``."""
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v.detach().numpy())
    return {"params": tree}


def draw_assignments(rng, kind, dones_w, agents=A):
    """[S, W * agents] per-step assignments: each world one train policy
    (0-1) against a past one (2-3) or, in ``masked``, itself half the
    time; a coin for which team (the first or second half of the world's
    slots) plays which; redrawn where the world's episode ended on the
    step before."""
    s, w = dones_w.shape
    team = agents // 2
    if kind == "single":
        return np.zeros((s, w * agents), np.int32)

    def draw():
        t0 = rng.integers(0, 2, w)
        other = rng.integers(2, 4, w)
        if kind == "masked":
            other = np.where(rng.uniform(size=w) < 0.5, t0, other)
        first = rng.uniform(size=w) < 0.5
        return np.repeat(np.stack([np.where(first, t0, other),
                                   np.where(first, other, t0)], -1),
                         team, -1).reshape(-1)

    cur, out = draw(), []
    for i in range(s):
        out.append(cur)
        cur = np.where(np.repeat(dones_w[i], agents), draw(), cur)
    return np.stack(out).astype(np.int32)


def make_buffer(rng, kind, worlds, rnn=RNN, agents=A):
    """A seeded rollout buffer as numpy (``agents`` a world): old
    log-probabilities near the fresh policy's (so the ratio is near 1 and
    some samples clip)."""
    n = worlds * agents
    lead = (C, T, n)
    dones_w = rng.uniform(size=(C * T, worlds)) < 0.15
    return {
        "obs": prepped(raw_obs(rng, lead)),
        "actions": np.stack([rng.integers(0, b, lead) for b in BUCKETS],
                            -1).astype(np.int32),
        "log_probs": (-np.log(500.0) + 0.08 * rng.standard_normal(lead)
                      ).astype(np.float32),
        "values": (0.5 * rng.standard_normal(lead)).astype(np.float32),
        "rewards": (rng.standard_normal(lead) *
                    (rng.uniform(size=lead) < 0.5)).astype(np.float32),
        "dones": np.repeat(dones_w, agents, axis=1).reshape(lead),
        "assignments": draw_assignments(rng, kind, dones_w,
                                        agents).reshape(lead),
        "rnn_start": tuple(tuple(
            (0.5 * rng.standard_normal((C, 1, n, rnn))).astype(np.float32)
            for _ in range(2)) for _ in range(2)),
        "bootstrap": (0.5 * rng.standard_normal(n)).astype(np.float32),
    }


def port_buffer(b):
    return trollout.RolloutBuffer(
        obs={k: t(v) for k, v in b["obs"].items()},
        actions=t(b["actions"]).long(), log_probs=t(b["log_probs"]),
        values=t(b["values"]), rewards=t(b["rewards"]),
        dones=t(b["dones"]), assignments=t(b["assignments"]),
        rnn_start_states=tree_map(t, b["rnn_start"]),
        bootstrap_value=t(b["bootstrap"]))


def jax_buffer(b):
    return jrollout.RolloutBuffer(
        obs={k: jnp.asarray(v) for k, v in b["obs"].items()},
        actions=jnp.asarray(b["actions"]),
        log_probs=jnp.asarray(b["log_probs"]),
        values=jnp.asarray(b["values"]), rewards=jnp.asarray(b["rewards"]),
        dones=jnp.asarray(b["dones"]),
        assignments=jnp.asarray(b["assignments"]),
        rnn_start_states=jax.tree.map(jnp.asarray, b["rnn_start"]),
        bootstrap_value=jnp.asarray(b["bootstrap"]))


def buffer_np(buf):
    """A port RolloutBuffer -> make_buffer's numpy layout."""
    return {"obs": {k: v.numpy() for k, v in buf.obs.items()},
            "actions": buf.actions.numpy().astype(np.int32),
            "log_probs": buf.log_probs.numpy(), "values": buf.values.numpy(),
            "rewards": buf.rewards.numpy(), "dones": buf.dones.numpy(),
            "assignments": buf.assignments.numpy(),
            "rnn_start": tree_map(lambda x: x.numpy(), buf.rnn_start_states),
            "bootstrap": buf.bootstrap_value.numpy()}


_JIT = {}


def jax_ppo(kind, cfg, *args):
    """JAX's ppo_update for one case on ``args``, jitted once (the slice
    reuses the grouped case's)."""
    if kind not in _JIT:
        jpol = policies()[0]
        tx = jppo.make_optimizer(cfg)
        _JIT[kind] = jax.jit(
            lambda params, opt, stats, vs, hyper, buf: jppo.ppo_update(
                cfg, jpol, tx, params, opt, stats, vs, hyper, buf,
                jax.random.PRNGKey(0)))
    return _JIT[kind](*args)


def check_update(got, want, lr, epochs):
    """A port ppo_update result against JAX's at the module's bars."""
    params_t, opt_t, vs_t, met_t = got
    params_j, opt_j, vs_j, met_j = want
    flat_j = bridge.flatten_tree(np_tree(params_j)["params"])
    assert set(flat_j) == set(params_t)
    for k, v in flat_j.items():
        d = np.abs(params_t[k].numpy() - v)
        # 0.1 % of the elements, rounded up: one of a 512-element leaf.
        assert (d > 1e-6).sum() <= np.ceil(0.001 * d.size), (k, d.max())
        assert d.max() <= 2 * lr * epochs, (k, d.max())
    adam_j = np_tree(opt_j[1])
    np.testing.assert_array_equal(opt_t.count.numpy(), adam_j.count)
    for name, bar in (("mu", 1e-4), ("nu", 2e-4)):
        flat = bridge.flatten_tree(getattr(adam_j, name)["params"])
        for k, v in flat.items():
            got_m = getattr(opt_t, name)[k].numpy()
            assert np.abs(got_m - v).max() <= bar * np.abs(v).max(), (name,
                                                                        k)
    for k in ("mu", "sigma"):
        np.testing.assert_allclose(vs_t[k].numpy(), np.asarray(vs_j[k]),
                                   rtol=REL)
    for k in ("loss", "action_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(met_t[k].numpy(), np.asarray(met_j[k]),
                                   rtol=REL, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(met_t["dropped_agent_frac"].numpy(),
                                  np.asarray(met_j["dropped_agent_frac"]))


def run_both(kind, tcf, jcf, b, params_np, stats, vs, hyper):
    """One ppo_update on each side from the same inputs."""
    tpol = policies()[1]
    tstats, jstats = stats
    params_t = bridge.policy_params_from_numpy(params_np, tpol)
    got = tppo.ppo_update(tcf, tpol, params_t,
                          tppo.init_opt_state(params_t), tstats,
                          {k: t(v) for k, v in vs.items()},
                          {k: t(v) for k, v in hyper.items()},
                          port_buffer(b), prng.key(0))
    tx = jppo.make_optimizer(jcf)
    jparams = jax.tree.map(jnp.asarray, params_np)
    want = jax_ppo(kind, jcf, jparams, jax.vmap(tx.init)(jparams), jstats,
                   {k: jnp.asarray(v) for k, v in vs.items()},
                   {k: jnp.asarray(v) for k, v in hyper.items()},
                   jax_buffer(b))
    return got, want


# --------------------------------------------------------------------------
# GAE, return statistics, the loss, the optimizer
# --------------------------------------------------------------------------

def test_gae_and_value_stats_match_jax():
    rng = np.random.default_rng(0)
    jc, tc = configs("masked", clip_value_loss=True)
    b = make_buffer(rng, "masked", 6)
    adv_j, ret_j = jrollout.compute_gae(jc, jax_buffer(b))
    adv_t, ret_t = trollout.compute_gae(tc, port_buffer(b))
    for got, want in ((adv_t, adv_j), (ret_t, ret_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=REL,
                                   atol=REL * np.abs(want).max())
    vs = {"mu": np.array([0.3, -0.2, 0.1, 0.0], np.float32),
          "sigma": np.array([1.5, 0.7, 1.0, 2.0], np.float32)}
    want = jppo.update_value_stats(jc, {k: jnp.asarray(v) for k, v in
                                        vs.items()}, ret_j,
                                   jnp.asarray(b["assignments"]))
    got = tppo.update_value_stats(tc, {k: t(v) for k, v in vs.items()},
                                  ret_t, t(b["assignments"]))
    for k in vs:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=REL)
    assert not np.allclose(got["mu"].numpy()[:2], vs["mu"][:2])
    np.testing.assert_array_equal(got["mu"].numpy()[2:], vs["mu"][2:])


@pytest.mark.parametrize("critic", ["dreamer", "clip_value_loss",
                                    "huber_value_loss"])
def test_policy_loss_and_gradients_match_jax(critic):
    """Two train policies over one shared minibatch (the masked path),
    each policy's losses and gradients against JAX's value_and_grad of
    its own loss; the port takes both in one backward."""
    algo = {} if critic == "dreamer" else {critic: True}
    jc, tc = configs("masked", **algo)
    rng = np.random.default_rng(1)
    jpol, tpol = policies()
    b = make_buffer(rng, "masked", 6)
    lead = b["log_probs"].shape
    mb = {k: b[k] for k in ("obs", "actions", "log_probs", "values", "dones",
                            "assignments")}
    mb["rnn_start"] = b["rnn_start"]
    mb["advantages"] = rng.standard_normal(lead).astype(np.float32)
    mb["returns"] = (3.0 * rng.standard_normal(lead)).astype(np.float32)
    tstats, jstats = seeded_stats(rng)
    vs = {"mu": np.array([0.4, -0.3, 0.0, 0.0], np.float32),
          "sigma": np.array([1.7, 0.6, 1.0, 1.0], np.float32)}
    params_np = seeded_params(2, 1)
    ent = 0.01

    def total(p, idx):
        a_l, v_l, e, *_ = jppo._policy_loss(
            jc, jpol, p, jstats, {k: jnp.asarray(v) for k, v in vs.items()},
            jax.tree.map(jnp.asarray, mb), idx)
        return a_l + v_l - ent * e, (a_l, v_l, e)

    jfn = jax.jit(jax.value_and_grad(total, has_aux=True))
    params_t = bridge.policy_params_from_numpy(params_np, tpol)
    leaves = {k: v.clone().requires_grad_() for k, v in params_t.items()}
    mb_t = {k: (tree_map(t, v) if k in ("obs", "rnn_start") else t(v))
            for k, v in mb.items()}
    mb_t["actions"] = mb_t["actions"].long()
    a_t, v_t, e_t, ratio, mask, denom = tppo._policy_loss(
        tc, tpol, leaves, tstats, {k: t(v) for k, v in vs.items()}, mb_t,
        torch.arange(2))
    grads = torch.autograd.grad((a_t + v_t - ent * e_t).sum(),
                                list(leaves.values()))
    grads = dict(zip(leaves, grads))
    assert ratio.shape == mask.shape == (2, T, C * lead[2])
    for p in range(2):
        (_, (a_j, v_j, e_j)), g_j = jfn(
            jax.tree.map(lambda x: x[p], params_np), p)
        for got, want in ((a_t, a_j), (v_t, v_j), (e_t, e_j)):
            np.testing.assert_allclose(got[p].item(), float(want),
                                       rtol=REL, atol=1e-7)
        assert float(denom[p]) == float((b["assignments"] == p).sum())
        flat = bridge.flatten_tree(np_tree(g_j)["params"])
        assert set(flat) == set(grads)
        for k, want in flat.items():
            err = np.abs(grads[k][p].numpy() - want).max()
            assert err <= GRAD * np.abs(want).max(), (k, err)
            assert np.abs(want).max() > 0.0 or critic != "dreamer" \
                or "critic" in k, k


def test_clipped_adam_matches_optax():
    """Three steps of two policies; on the second, policy 0's gradient is
    large enough to be clipped and policy 1's is not: the norm is each
    policy's own."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal((2,) + s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jppo.make_optimizer(configs("masked")[0])
    j_state = jax.vmap(tx.init)(jax.tree.map(jnp.asarray, params))
    t_state = tppo.init_opt_state({k: t(v) for k, v in params.items()})
    for step in range(3):
        grads = {k: (0.3 * rng.standard_normal((2,) + s)).astype(np.float32)
                 for k, s in shapes.items()}
        if step == 1:
            for g in grads.values():
                g[0] *= 100.0
        norms = np.sqrt(sum((g.reshape(2, -1) ** 2).sum(1)
                            for g in grads.values()))
        assert (norms[0] > 5.0) == (step == 1) and norms[1] < 5.0
        j_up, j_state = jax.vmap(tx.update)(
            jax.tree.map(jnp.asarray, grads), j_state)
        t_up, t_state = tppo.clipped_adam({k: t(v) for k, v in grads.items()},
                                          t_state, 5.0)
        for k in shapes:
            np.testing.assert_allclose(t_up[k].numpy(), np.asarray(j_up[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(t_state.mu[k].numpy(),
                                       np.asarray(j_state[1].mu[k]),
                                       rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(t_state.nu[k].numpy(),
                                       np.asarray(j_state[1].nu[k]),
                                       rtol=1e-6, atol=1e-10)
        np.testing.assert_array_equal(t_state.count.numpy(),
                                      np.asarray(j_state[1].count))
    assert t_state.count.tolist() == [3, 3]


# --------------------------------------------------------------------------
# ppo_update end to end
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,agents", [("single", A), ("masked", A),
                                         ("grouped", A), ("grouped", 6)],
                         ids=["single", "masked", "grouped", "grouped_3v3"])
def test_ppo_update_matches_jax(kind, agents):
    """One minibatch, two epochs at the slice's 4 worlds: P = 1 with the
    plain clipped critic (value statistics move), PBT with a self-play
    portion (masked), PBT past-play (grouped), and grouped PBT with
    scripts/train.py's default 3v3 teams."""
    algo = {"clip_value_loss": True} if kind == "single" else {}
    worlds = ENV.num_worlds
    jc, tc = configs(kind, worlds=worlds, agents=agents, **algo)
    assert tppo.use_grouped_ppo(tc) == jppo.use_grouped_ppo(jc) == \
        (kind == "grouped")
    rng = np.random.default_rng(4)
    b = make_buffer(rng, kind, worlds, agents=agents)
    p = tc.num_train_policies
    vs = {"mu": np.full(tc.total_policies, 0.2, np.float32),
          "sigma": np.full(tc.total_policies, 1.3, np.float32)}
    hyper = {"lr": np.array([1e-4, 3e-4][:p], np.float32),
             "entropy_coef": np.array([0.01, 0.003][:p], np.float32)}
    got, want = run_both(kind if agents == A else f"{kind}_{agents}", tc,
                         jc, b, seeded_params(p, 4),
                         seeded_stats(rng), vs, hyper)
    check_update(got, want, 3e-4, tc.algo.num_epochs)
    assert got[1].count.tolist() == [2] * p


@pytest.fixture(scope="module")
def fault_setup():
    """The grouped update of ``test_ppo_update_matches_jax`` (the port
    alone), with its gradient clip planted at half the smallest gradient
    norm of its first step when the recipe's 5 does not bite: the update
    as a function of the observations, its result and rounding bars, the
    norms, and the leaf with the most lenient mu bar."""
    _, tc = configs("grouped")
    rng = np.random.default_rng(4)
    b = make_buffer(rng, "grouped", ENV.num_worlds)
    tpol = policies()[1]
    params = bridge.policy_params_from_numpy(seeded_params(2, 4), tpol)
    stats = seeded_stats(rng)[0]
    hyper = {"lr": t(np.array([1e-4, 3e-4], np.float32)),
             "entropy_coef": t(np.array([0.01, 0.003], np.float32))}
    vs = tppo.init_value_stats(tc)

    def update(cfg, obs):
        buf = dataclasses.replace(port_buffer(b), obs=obs)
        return tppo.ppo_update(cfg, tpol, params, tppo.init_opt_state(params),
                               stats, vs, hyper, buf, prng.key(0))

    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tppo, "clipped_adam",
                   functools.partial(testing.grad_norms, seen=seen))
        update(tc, port_buffer(b).obs)
    norm = float(seen[0].min())
    if norm < tc.algo.max_grad_norm:
        tc = dataclasses.replace(tc, algo=dataclasses.replace(
            tc.algo, max_grad_norm=0.5 * norm))
    obs = port_buffer(b).obs
    base, bars = testing.rounding_bars(lambda o: update(tc, o), obs)
    leaf = max(base[1].mu, key=lambda k: bars[("mu", k)])
    return dict(update=lambda: update(tc, obs), base=base, bars=bars,
                params=params, leaf=leaf, norms=seen[0].tolist(),
                clip=tc.algo.max_grad_norm, epochs=tc.algo.num_epochs)


@pytest.mark.parametrize("fault", (None,) + testing.PLANTED_FAULTS)
def test_rounding_bars_catch_planted_faults(fault_setup, fault, monkeypatch):
    """The per-leaf rounding bars pass the update against itself and fail
    it with each planted fault of Adam: the bias correction dropped, the
    gradient clip skipped (planted at half the first step's norm, since
    the recipe's 5 does not bite at this size), the most leniently barred
    leaf's update zeroed."""
    s = fault_setup
    assert s["clip"] < 5.0 and min(s["norms"]) > s["clip"]
    if fault is not None:
        monkeypatch.setattr(tppo, "clipped_adam",
                            testing.planted_fault(fault, s["leaf"]))
    cmp = testing.compare_updates(s["update"](), s["base"], s["params"],
                                  s["bars"], 3e-4, s["epochs"])
    print(fault, len(cmp["violations"]), cmp["worst"])
    assert (cmp["violations"] == []) == (fault is None), cmp


def test_group_indices_and_dropped_fraction_match_jax():
    rng = np.random.default_rng(6)
    worlds = 1024
    dones_w = rng.uniform(size=(8, worlds)) < 0.02
    assign = draw_assignments(rng, "grouped", dones_w)[:, None]   # [8,1,N]
    n = worlds * A
    g_t, cap_t = tppo.group_gather_indices(2, n, t(assign[0, 0]))
    g_j, cap_j = jppo.group_gather_indices(2, n, jnp.asarray(assign[0, 0]))
    assert cap_t == cap_j == 640
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    got = tppo.grouped_dropped_frac(t(assign), g_t, 2)
    want = jppo.grouped_dropped_frac(jnp.asarray(assign), g_j, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.0 < float(got.max()) < 0.1


# --------------------------------------------------------------------------
# PBT and matchmaking
# --------------------------------------------------------------------------

def test_explore_exploit_and_past_refresh_match_jax():
    """Which slot copies, the ELO rotation, and the perturbed and clamped
    hyperparameters equal JAX's from the same key; over keys, the
    factor (1.2 or 1 / 1.2) takes both values."""
    jc, tc = configs("grouped")
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((2, 3, 2)).astype(np.float32)}
    past = {"w": rng.standard_normal((2, 3, 2)).astype(np.float32)}
    mu = {"w": rng.standard_normal((2, 3, 2)).astype(np.float32)}
    count = np.array([7, 9], np.int32)
    elo = np.array([1490.0, 1530.0, 1480.0, 1500.0], np.float32)
    # lr of the best at the top of its range: x 1.2 clamps.
    hyper = {"lr": np.array([2e-4, 1e-3], np.float32),
             "entropy_coef": np.array([0.02, 0.005], np.float32)}
    j_opt = {"mu": jnp.asarray(mu["w"]), "count": jnp.asarray(count)}
    factors = set()
    for seed in range(16):
        jp, jo, jh = jpbt.explore_exploit(
            jc, jax.random.PRNGKey(seed), jnp.asarray(elo),
            {"w": jnp.asarray(params["w"])}, j_opt,
            {k: jnp.asarray(v) for k, v in hyper.items()})
        t_opt = tppo.AdamState(mu={"w": t(mu["w"])}, nu={"w": t(mu["w"])},
                               count=t(count))
        tp, to, th = tpbt.explore_exploit(
            tc, prng.key(seed), t(elo),
            {"w": t(params["w"])}, t_opt, {k: t(v) for k, v in hyper.items()})
        np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
        np.testing.assert_array_equal(to.mu["w"].numpy(),
                                      np.asarray(jo["mu"]))
        np.testing.assert_array_equal(to.count.numpy(),
                                      np.asarray(jo["count"]))
        for k in ("lr", "entropy_coef"):
            np.testing.assert_allclose(th[k].numpy(), np.asarray(jh[k]),
                                       rtol=1e-6, err_msg=k)
            assert th[k][1] == hyper[k][1]
            factors.add((k, float(th[k][0])))
    np.testing.assert_array_equal(tp["w"][0].numpy(), params["w"][1])
    assert len(factors) == 4                         # both points, each key

    for update_idx in (500, 1000, 1500):
        jpast, jelo = jpbt.refresh_past_policies(
            jc, update_idx, {"w": jnp.asarray(params["w"])},
            {"w": jnp.asarray(past["w"])}, jnp.asarray(elo))
        tpast, telo = tpbt.refresh_past_policies(
            tc, update_idx, {"w": t(params["w"])}, {"w": t(past["w"])},
            t(elo))
        np.testing.assert_array_equal(tpast["w"].numpy(),
                                      np.asarray(jpast["w"]))
        np.testing.assert_array_equal(telo.numpy(), np.asarray(jelo))


def test_hyper_params_draw_in_range():
    """init_hyper_params from a key: JAX's values, inside the explore
    ranges; without PBT the configured scalars."""
    jc, tc = configs("grouped")
    hp = tpbt.init_hyper_params(tc, prng.key(0))
    want = jpbt.init_hyper_params(jc, jax.random.PRNGKey(0))
    assert set(hp) == {"lr", "entropy_coef"} == set(want)
    for k, spec in (("lr", tc.lr), ("entropy_coef", tc.algo.entropy_coef)):
        assert hp[k].shape == (2,)
        assert bool(((hp[k] >= spec.base * 0.1 * (1 - 1e-6)) &
                     (hp[k] <= spec.base * 10 * (1 + 1e-6))).all())
        np.testing.assert_allclose(hp[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    _, ts = configs("single")
    hp = tpbt.init_hyper_params(ts, prng.key(0))
    assert hp["lr"].tolist() == [pytest.approx(1e-4)]


def test_resample_assignments_past_play_invariants():
    """2v2 worlds with shuffled teams: the new matchups equal JAX's from
    the same key; each world that ended gets one train policy on one
    team and one past policy on the other, each team on one policy; the
    others keep theirs; both roles get the train side."""
    jc, tc = configs("grouped")
    tc = dataclasses.replace(tc, num_agents_per_world=4)
    rng = np.random.default_rng(8)
    w, a = 256, 4
    agent_type = np.stack([rng.permutation([0, 0, 1, 1]) for _ in range(w)])
    dones_w = rng.uniform(size=w) < 0.5
    old = rng.integers(0, 4, w * a).astype(np.int32)
    new = trollout._resample_assignments(
        prng.key(1), t(dones_w), t(old), tc, w, a,
        t(agent_type).to(torch.int32)).numpy().reshape(w, a)
    want = jrollout._resample_assignments(
        jax.random.PRNGKey(1), jnp.asarray(dones_w), jnp.asarray(old),
        dataclasses.replace(jc, num_agents_per_world=4), w, a,
        jnp.asarray(agent_type, jnp.int32))
    np.testing.assert_array_equal(new.reshape(-1), np.asarray(want))
    old = old.reshape(w, a)
    np.testing.assert_array_equal(new[~dones_w], old[~dones_w])
    hider = agent_type == 1
    train_hiders = 0
    for i in np.flatnonzero(dones_w):
        h, s = set(new[i][hider[i]]), set(new[i][~hider[i]])
        assert len(h) == len(s) == 1
        h, s = h.pop(), s.pop()
        assert sorted([h < 2, s < 2]) == [False, True], (h, s)
        train_hiders += h < 2
    assert 0 < train_hiders < dones_w.sum()


# --------------------------------------------------------------------------
# The slice as a whole
# --------------------------------------------------------------------------

def _u32(x):
    return x.view(torch.int32).numpy().view(np.uint32)


def test_init_training_matches_jax():
    """init_training from one seed at 4 worlds, PBT 2 + 2, against JAX's
    init_training's key tree (manager.py:376-424) and functions: the
    state's and the rollout's keys, the hyperparameters, the first
    matchups and the episode keys exactly; the parameters (flax's init of
    each train policy from split(k_param, 2)) within 1e-5; the past
    policies copies of policy 0. The worlds themselves are held to JAX's
    generator in tests/test_torch_levelgen.py (no JAX env compile here)."""
    from marl_hideandseek_tpu.config import EnvConfig as JEnvCfg
    from marl_hideandseek_tpu.env import env as jenv

    jc, tc = configs("grouped")
    jpol, tpol = policies()
    st = tmanager.init_training("cpu", tc, PackedEnv(ENV, device="cpu"),
                                tpol).state
    k_env, k_param, k_roll, k_hyper, k_state = jax.random.split(
        jax.random.PRNGKey(tc.seed), 5)
    k_roll, k_assign0 = jax.random.split(k_roll)
    np.testing.assert_array_equal(_u32(st.key), np.asarray(k_state))
    np.testing.assert_array_equal(_u32(st.rollout.key), np.asarray(k_roll))
    hyper = jpbt.init_hyper_params(jc, k_hyper)
    for k, v in hyper.items():
        np.testing.assert_allclose(st.hyper_params[k].numpy(), np.asarray(v),
                                   rtol=1e-6, err_msg=k)
    jenv_cfg = JEnvCfg(**{f: getattr(ENV, f) for f in (
        "num_worlds", "min_hiders", "max_hiders", "min_seekers",
        "max_seekers", "max_boxes", "max_ramps", "episode_len",
        "rand_seed")}, sim_flags=int(ENV.sim_flags))
    ep_key, level_key, n_h, n_s, flip = jax.vmap(
        lambda w: jenv._draw_episode(jenv_cfg, k_env, w, jnp.uint32(0)))(
            jnp.arange(ENV.num_worlds, dtype=jnp.uint32))
    es = st.rollout.env_state
    np.testing.assert_array_equal(_u32(es.ep_key), np.asarray(ep_key).T)
    np.testing.assert_array_equal(_u32(es.level_key),
                                  np.asarray(level_key).T)
    np.testing.assert_array_equal(es.num_hiders.numpy(), np.asarray(n_h))
    np.testing.assert_array_equal(es.seekers_first.numpy(), np.asarray(flip))
    assign = jrollout._resample_assignments(
        k_assign0, jnp.ones((ENV.num_worlds,), bool),
        jnp.zeros((ENV.num_worlds * A,), jnp.int32), jc, ENV.num_worlds, A,
        jnp.asarray(es.agent_type.T.numpy()))
    np.testing.assert_array_equal(st.rollout.assignments.numpy(),
                                  np.asarray(assign))
    obs = {k: jnp.asarray(v.numpy()) for k, v in st.rollout.obs.items()}
    rnn0 = jpol.actor_critic.init_recurrent_state(ENV.num_worlds * A)
    jparams = jax.jit(jax.vmap(lambda k: jpol.actor_critic.init(
        k, rnn0, obs)))(jax.random.split(k_param, 2))
    flat = bridge.flatten_tree(np_tree(jparams)["params"])
    assert set(flat) == set(st.params)
    for k, v in flat.items():
        np.testing.assert_allclose(st.params[k].numpy(), v, rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(st.past_params[k].numpy(),
                                      np.repeat(st.params[k][:1].numpy(), 2,
                                                0))


def test_rollout_keys_and_epoch_permutations_match_jax():
    """The rollout's step keys (rollout.py:228,331-338) and ppo_update's
    epoch permutations (ppo.py:284,340) from one key, as JAX splits
    them."""
    key = jax.random.PRNGKey(31)
    nxt, step_keys = trollout.rollout_keys(prng.key(31), 8)
    j_next, sub = jax.random.split(key)
    j_steps = jax.vmap(jax.random.split)(jax.random.split(sub, 8))
    np.testing.assert_array_equal(_u32(nxt), np.asarray(j_next))
    np.testing.assert_array_equal(_u32(step_keys), np.asarray(j_steps))
    for n in (64, 2000):
        perms = tppo.epoch_permutations(prng.key(31), 3, n)
        want = jax.vmap(lambda k: jax.random.permutation(k, n))(
            jax.random.split(key, 3))
        np.testing.assert_array_equal(perms.numpy(), np.asarray(want))


def _jax_sample(k_act, logits):
    """JAX's ``DiscreteActionDistributions.sample`` of ``k_act`` on
    ``logits`` [N, 19], and where each bucket's top two of Gumbel noise
    plus logits differ by more than 1e-4 (off near-ties)."""
    keys = jax.random.split(k_act, len(BUCKETS))
    acts, clear, lo = [], [], 0
    for k, b in zip(keys, BUCKETS):
        z = logits[:, lo:lo + b] + np.asarray(jax.random.gumbel(
            k, (logits.shape[0], b)))
        top2 = np.sort(z, -1)[:, -2:]
        acts.append(z.argmax(-1))
        clear.append(top2[:, 1] - top2[:, 0] > 1e-4)
        lo += b
    return np.stack(acts, -1), np.stack(clear, -1)


class _Capture(tmanager.TrainHooks):
    def __init__(self):
        self.buffers = []

    def post_rollout(self, update_idx, buffer, metrics):
        self.buffers.append(buffer)
        return metrics


def test_training_slice_matches_jax():
    """init_training and two update_iter on the port's CPU PackedEnv at 4
    worlds, 1v1, PBT 2 + 2, grouped. Each step's sampled actions equal
    JAX's from the rollout's step keys (off near-ties) and its new
    matchups JAX's ``_resample_assignments``. The worlds start at step 98, just
    before the seek phase, so rewards flow and the 104-step episode ends
    in the first rollout (LSTM clears, new matchups, ELO). Each stored
    step's log-probabilities and values against JAX's apply_ensemble on
    the stored observations, JAX carrying its own LSTM state; the port's
    chunk-start states against that carried state; the first update
    against JAX's ppo_update from the same parameters and buffer."""
    jc, tc = configs("grouped")
    jpol, tpol = policies()
    env = PackedEnv(ENV, device="cpu")
    hooks = _Capture()
    mgr = tmanager.init_training("cpu", tc, env, tpol, hooks=hooks)
    # The post-step teams each step's new matchups are keyed by.
    post_types = []
    env_step = env.step

    def recording_step(*args, **kwargs):
        out = env_step(*args, **kwargs)
        post_types.append(out[0].agent_type.T.clone())
        return out

    env.step = recording_step
    ro = mgr.state.rollout
    mgr = mgr.replace(state=mgr.state.replace(rollout=ro.replace(
        env_state=ro.env_state.replace(step=torch.full_like(
            ro.env_state.step, 98)))))
    # Matchups: each world one train policy against one past policy.
    wa = mgr.state.rollout.assignments.reshape(-1, A)
    assert bool(((wa < 2).sum(1) == 1).all())
    states = [mgr.state]
    for _ in range(2):
        mgr = mgr.update_iter()
        states.append(mgr.state)
    assert mgr.update_idx == 2 and len(hooks.buffers) == 2
    assert sum(int(b.dones.any()) for b in hooks.buffers) >= 1
    assert mgr.state.opt_states.count.tolist() == [4, 4]
    assert float((mgr.state.elo - 1500.0).abs().max()) > 0.0

    jfwd = jax.jit(lambda params, stats, rnn, obs, assign: jrollout
                   .apply_ensemble(jpol, params, rnn,
                                   jpol.obs_preprocess.normalize(stats, obs),
                                   assign, 4, num_train=2))
    compared = 0
    for u, buf in enumerate(hooks.buffers):
        st = states[u]
        params = to_flax({k: torch.cat([v, st.past_params[k]]) for k, v in
                          st.params.items()})
        stats = jax_stats(*stats_np(st.obs_stats))
        rnn = tree_map(lambda x: jnp.asarray(x.numpy()), st.rollout.rnn_states)
        # JAX's key tree of this rollout: each step's (action, matchup)
        # keys; the matchups each step leaves (the next step's, or the
        # rollout's last).
        _, sub = jax.random.split(jnp.asarray(_u32(st.rollout.key)))
        step_keys = jax.random.split(sub, C * T)
        assigns = [buf.assignments[c, s] for c in range(C)
                   for s in range(T)] + [states[u + 1].rollout.assignments]
        for c in range(C):
            for a, b_ in zip(jax.tree.leaves(rnn),
                             jax.tree.leaves(tree_map(
                                 lambda x: x[c].numpy(),
                                 buf.rnn_start_states))):
                np.testing.assert_allclose(b_, np.asarray(a), rtol=0,
                                           atol=REL)
            for s in range(T):
                obs = {k: v[c, s].numpy() for k, v in buf.obs.items()}
                logits, values, new_rnn = jfwd(
                    params, stats, rnn, obs, buf.assignments[c, s].numpy())
                lp = JDists(BUCKETS, logits).log_prob(
                    buf.actions[c, s].numpy().astype(np.int32))
                np.testing.assert_allclose(buf.log_probs[c, s].numpy(),
                                           np.asarray(lp), rtol=0, atol=REL)
                np.testing.assert_allclose(buf.values[c, s].numpy(),
                                           np.asarray(values), rtol=0,
                                           atol=REL)
                g = c * T + s
                k_act, k_assign = jax.random.split(step_keys[g])
                acts, clear = _jax_sample(k_act, np.asarray(logits))
                np.testing.assert_array_equal(
                    buf.actions[c, s].numpy()[clear], acts[clear])
                compared += int(clear.sum())
                dones_w = buf.dones[c, s].numpy().reshape(-1, A)[:, 0]
                want_assign = jrollout._resample_assignments(
                    k_assign, jnp.asarray(dones_w),
                    jnp.asarray(assigns[g].numpy()), jc, ENV.num_worlds, A,
                    jnp.asarray(post_types[u * C * T + g].numpy()))
                np.testing.assert_array_equal(assigns[g + 1].numpy(),
                                              np.asarray(want_assign))
                rnn = jpol.actor_critic.clear_recurrent_state(
                    new_rnn, buf.dones[c, s].numpy())

    assert compared > 0.99 * 2 * C * T * ENV.num_worlds * A * len(BUCKETS)

    # The first update: the normalizer updated from the buffer, then PPO.
    st0, st1 = states[0], states[1]
    b0 = buffer_np(hooks.buffers[0])
    jstats0 = jax_stats(*stats_np(st0.obs_stats))
    want_stats = jpol.obs_preprocess.update_state(jstats0, {
        k: jnp.asarray(v.reshape((-1,) + v.shape[3:]))
        for k, v in b0["obs"].items()})
    for k in want_stats.mean:
        np.testing.assert_allclose(st1.obs_stats.mean[k].numpy(),
                                   np.asarray(want_stats.mean[k]), atol=1e-6)
        np.testing.assert_allclose(st1.obs_stats.var[k].numpy(),
                                   np.asarray(want_stats.var[k]), rtol=REL)
    hyper = {k: v.numpy() for k, v in st0.hyper_params.items()}
    vs = {k: v.numpy() for k, v in st0.value_stats.items()}
    params_np = np_tree(to_flax(st0.params))
    got, want = run_both("grouped", tc, jc, b0, params_np,
                         (st1.obs_stats, jax_stats(*stats_np(st1.obs_stats))),
                         vs, hyper)
    check_update(got, want, float(st0.hyper_params["lr"].max()),
                 tc.algo.num_epochs)
    assert float(got[3]["dropped_agent_frac"].max()) > 0.0
    for k, v in got[0].items():     # update_iter ran that same update
        torch.testing.assert_close(st1.params[k], v, rtol=1e-6, atol=1e-8)


# --------------------------------------------------------------------------
# Training state carried across from the TPU, checkpoints and the CLI
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def orbax_tree():
    """The tracked r4_learn/50000 TrainingState, read without a target
    (on this CPU: the saved shardings name TPU devices), as numpy."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    meta = ckptr.metadata(str(CKPT))
    meta = getattr(meta, "item_metadata", meta)
    sharding = jax.sharding.SingleDeviceSharding(jax.local_devices()[0])
    target = jax.tree.map(lambda m: jax.ShapeDtypeStruct(
        m.shape, m.dtype, sharding=sharding), meta)
    return np_tree(ckptr.restore(str(CKPT), target))


def _cut_rollout(conv, worlds, agents=4):
    """A converted training state whose rollout keeps its first
    ``worlds`` packed worlds and their ``agents`` agents each."""
    ro, n = conv["rollout"], worlds * agents
    return dict(conv, rollout={
        "env_state": tree_map(lambda x: x[..., :worlds].contiguous(),
                              ro["env_state"]),
        "obs": {k: v[:n] for k, v in ro["obs"].items()},
        "rnn_states": tree_map(lambda x: x[:, :n].contiguous(),
                               ro["rnn_states"]),
        "assignments": ro["assignments"][:n], "key": ro["key"]})


def _two_world_manager(tpol, path):
    """init_training of a 2-world, 2v2 CPU run restoring ``path``."""
    cfg = dataclasses.replace(configs("grouped", worlds=2)[1],
                              num_agents_per_world=4)
    env = PackedEnv(EnvConfig(num_worlds=2, min_hiders=2, max_hiders=2,
                              min_seekers=2, max_seekers=2,
                              sim_flags=ENV.sim_flags, rand_seed=5),
                    device="cpu")
    return tmanager.init_training("cpu", cfg, env, tpol, restore_ckpt=path)


def test_tpu_training_state_converts_and_restores(orbax_tree, tmp_path):
    """bridge.training_state_from_numpy on r4_learn/50000 (PBT 2 + 2,
    flagship at full width): Adam's count, mu and nu, the
    hyperparameters, ELOs, update count and metric ring equal the orbax
    tree's; restored through init_training, the state gives JAX's policy
    outputs on a few agents' observations."""
    raw = orbax_tree
    jpol, tpol = policies(256)
    conv = bridge.training_state_from_numpy(raw, tpol)
    adam = raw["opt_states"][1]
    np.testing.assert_array_equal(conv["opt_states"]["count"].numpy(),
                                  adam["count"])
    assert conv["opt_states"]["count"].tolist() == [100000, 100000]
    for name in ("mu", "nu"):
        flat = bridge.flatten_tree(adam[name]["params"])
        assert set(flat) == set(conv["opt_states"][name])
        for k, v in flat.items():
            np.testing.assert_array_equal(
                conv["opt_states"][name][k].numpy(), v)
    for k in ("hyper_params", "metrics", "value_stats"):
        assert set(conv[k]) == set(raw[k])
        for name, v in raw[k].items():
            np.testing.assert_array_equal(conv[k][name].numpy(), v)
    np.testing.assert_array_equal(conv["elo"].numpy(), raw["elo"])
    assert conv["update_idx"] == 50000
    path = tmp_path / "50000.pt"
    bridge.save_training_checkpoint(path, _cut_rollout(conv, 2))
    mgr = _two_world_manager(tpol, path)
    st = mgr.state
    assert mgr.update_idx == 50000
    assert st.opt_states.count.tolist() == [100000, 100000]
    assert float(st.obs_stats.count) == 50000.0
    # The ring predates dropped_agent_frac and the ramp rates: kept at 0.
    for k in ("dropped_agent_frac", "ramp_lock_rate", "ramp_move_rate"):
        assert float(st.metrics[k].abs().max()) == 0.0
    np.testing.assert_array_equal(st.metrics["loss"].numpy(),
                                  raw["metrics"]["loss"])

    rng = np.random.default_rng(9)
    n = 6
    obs = {k: v[:n].numpy() for k, v in mgr.state.rollout.obs.items()}
    obs["self_data"] = obs["self_data"] + rng.standard_normal(
        obs["self_data"].shape).astype(np.float32)
    assign = np.array([0, 1, 2, 3, 0, 2], np.int32)
    rnn = tree_map(lambda x: (0.3 * rng.standard_normal(
        (1, n, 256))).astype(np.float32), mgr.state.rollout.rnn_states)
    jparams = {"params": jax.tree.map(
        lambda a, b: np.concatenate([a, b]), raw["params"]["params"],
        raw["past_params"]["params"])}
    jstats = JStats(mean=raw["obs_stats"]["mean"],
                    var=raw["obs_stats"]["var"],
                    count=raw["obs_stats"]["count"])
    lg_j, val_j, rnn_j = jax.jit(lambda pr, r, o, a: jrollout.apply_ensemble(
        jpol, pr, r, jpol.obs_preprocess.normalize(jstats, o), a, 4,
        num_train=2))(jparams, rnn, obs, assign)
    with torch.no_grad():
        lg_t, val_t, rnn_t = trollout.apply_ensemble(
            tpol, mgr.all_params(), tree_map(t, rnn),
            tpol.obs_preprocess.normalize(
                st.obs_stats, {k: t(v) for k, v in obs.items()}),
            t(assign), 4, num_train=2)
    # tests/test_torch_infer.py's bar for this checkpoint's outputs.
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=0,
                               atol=1e-4 * max(1.0, np.abs(val_j).max()))
    for a, b_ in zip(jax.tree.leaves(rnn_j), jax.tree.leaves(rnn_t)):
        np.testing.assert_allclose(b_.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)


def test_tpu_training_state_carries_its_rollout_and_keys(orbax_tree,
                                                        tmp_path):
    """r4_learn/50000 converts with its rollout (1,024 packed worlds, the
    bf16 observations widened to float32, the LSTM state, the matchups)
    and its keys, all equal to the orbax tree's; the first step keys the
    port splits from it equal JAX's; and a checkpoint of two of its
    worlds restores into a two-world run with that rollout and keys."""
    raw = orbax_tree
    _, tpol = policies(256)
    conv = bridge.training_state_from_numpy(raw, tpol)
    ro, want = conv["rollout"], raw["rollout"]
    np.testing.assert_array_equal(_u32(conv["key"]), raw["key"])
    np.testing.assert_array_equal(_u32(ro["key"]), want["key"])
    got_state = bridge.flatten_tree(ro["env_state"])
    for k, v in bridge.flatten_tree(want["env_state"]).items():
        g = got_state[k]
        g = _u32(g) if g.dtype == torch.uint32 else g.numpy()
        np.testing.assert_array_equal(g, v, err_msg=k)
    for k, v in want["obs"].items():
        assert ro["obs"][k].dtype == torch.float32
        np.testing.assert_array_equal(ro["obs"][k].numpy(),
                                      np.asarray(v, np.float32))
    for a, b_ in zip(jax.tree.leaves(want["rnn_states"]),
                     jax.tree.leaves(ro["rnn_states"], is_leaf=lambda x:
                                     isinstance(x, torch.Tensor))):
        np.testing.assert_array_equal(b_.numpy(), a)
    np.testing.assert_array_equal(ro["assignments"].numpy(),
                                  want["assignments"])
    _, steps = trollout.rollout_keys(ro["key"], 40)
    _, sub = jax.random.split(jnp.asarray(want["key"]))
    first = jax.random.split(jax.random.split(sub, 40)[0])
    np.testing.assert_array_equal(_u32(steps[0]), np.asarray(first))

    path = tmp_path / "50000.pt"
    bridge.save_training_checkpoint(path, _cut_rollout(conv, 2))
    st = _two_world_manager(tpol, path).state
    np.testing.assert_array_equal(_u32(st.key), raw["key"])
    np.testing.assert_array_equal(_u32(st.rollout.key), want["key"])
    np.testing.assert_array_equal(st.rollout.assignments.numpy(),
                                  want["assignments"][:8])
    np.testing.assert_array_equal(st.rollout.env_state.bodies.pos.numpy(),
                                  want["env_state"]["bodies"]["pos"][..., :2])
    assert st.rollout.obs["self_data"].dtype == torch.float32


@pytest.mark.parametrize("fault", ["worlds", "keys"])
def test_restore_refuses_a_rollout_it_cannot_resume(orbax_tree, tmp_path,
                                                    fault):
    """A checkpoint whose rollout has another world count than the run,
    or that holds no threefry keys (an older port's generator states),
    raises instead of resuming with a fresh rollout or fresh keys."""
    _, tpol = policies(256)
    conv = bridge.training_state_from_numpy(orbax_tree, tpol)
    if fault == "worlds":
        tree, msg = _cut_rollout(conv, 3), "3 worlds and 12 agents"
    else:
        tree, msg = _cut_rollout(conv, 2), "no threefry keys"
        del tree["rollout"]["key"]
    path = tmp_path / "50000.pt"
    bridge.save_training_checkpoint(path, tree)
    with pytest.raises(ValueError, match=msg):
        _two_world_manager(tpol, path)


def test_train_cli_runs_saves_and_resumes(tmp_path, monkeypatch):
    """``python -m marl_hideandseek_torch.train`` on the CPU: 10 updates of
    the recipe's PBT 2 + 2 at 2 worlds, 1v1, 2 steps an update, then
    eval_elo and a checkpoint; ``--restore 10`` reads it back, and
    init_training restores the same state."""
    from marl_hideandseek_torch.train import __main__ as cli

    monkeypatch.setenv("MHS_METRICS_JSONL", "1")
    base = ["--ckpt-dir", str(tmp_path / "ckpt"), "--tb-dir",
            str(tmp_path / "tb"), "--run-name", "r", "--num-worlds", "2",
            "--steps-per-update", "2", "--num-bptt-chunks", "1",
            "--eval-frequency", "10", "--num-hiders", "1", "--num-seekers",
            "1", "--pbt-ensemble-size", "2", "--pbt-past-policies", "2",
            "--device", "cpu"]
    assert cli.main(base + ["--num-updates", "10"]) == 0
    path = tmp_path / "ckpt" / "r" / "10.pt"
    assert path.exists()
    lines = (tmp_path / "tb" / "r" / "metrics.jsonl").read_text().splitlines()
    assert any('"train/loss"' in ln for ln in lines)
    assert cli.main(base + ["--num-updates", "10", "--restore", "10"]) == 0

    args = cli.parse_args(base + ["--num-updates", "10"])
    env, cfg, policy = cli.build(args)
    mgr = tmanager.init_training("cpu", cfg, env, policy,
                                 restore_ckpt=str(path))
    saved = bridge.load_training_checkpoint(path)
    assert mgr.update_idx == 10
    for k, v in saved["params"].items():
        torch.testing.assert_close(mgr.state.params[k], v, rtol=0, atol=0)
    for a, b_ in zip(mgr.state.rollout.env_state.leaves(),
                     bridge.state_from_numpy(
                         saved["rollout"]["env_state"]).leaves()):
        assert torch.equal(a, b_)
    assert mgr.state.opt_states.count.tolist() == [20, 20]

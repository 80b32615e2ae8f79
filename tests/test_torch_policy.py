"""PyTorch port: the policy layer (models/, policy.py, train/rollout.py's
apply_ensemble) against the JAX package, one function at a time.

Each JAX module is initialised with a PRNGKey; its parameters (with the
zero-initialised leaves perturbed, so that biases and the critic take
part) go to the port through ``bridge.policy_params_from_numpy`` or by
name, and both sides get the same numpy inputs from a seed. Bars: float32
outputs and LSTM states within 1e-5 absolute after one step, 1e-4 after 8
chained steps (the two sides sum their products in other orders);
``best``, ``log_prob`` and ``entropy`` at float32 rounding; ``sample`` by a
frequency bound, and equal to ``jax.random.categorical``'s draws from the
same keys. The
bf16 policy is held at BF16_BAR (see its test).
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu import models as jm
from marl_hideandseek_tpu import policy as jpolicy
from marl_hideandseek_tpu.models import rnn as jrnn
from marl_hideandseek_tpu.train import rollout as jrollout
from flax import linen as nn

from marl_hideandseek_torch import bridge, prng
from marl_hideandseek_torch import policy as tpolicy
from marl_hideandseek_torch.models import layers as tl
from marl_hideandseek_torch.models import normalizer as tnorm
from marl_hideandseek_torch.models.rnn import LSTM
from marl_hideandseek_torch.train.rollout import apply_ensemble

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 6
ONE_STEP = 1e-5
CHAINED = 1e-4


def perturbed(params, seed=0, scale=0.05):
    """Flax params with every leaf that is all zeros or all ones moved by
    a seeded normal, as numpy."""
    rng = np.random.default_rng(seed)

    def bump(x):
        x = np.asarray(x, np.float32)
        if np.all(x == 0) or np.all(x == 1):
            x = x + scale * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree.map(bump, params)


def load_by_name(module, flax_params):
    """A flax tree (no policy axis) into a port module with P = 1."""
    flat = bridge.flatten_tree(flax_params["params"])
    own = dict(module.named_parameters())
    assert set(flat) == set(own), (sorted(flat), sorted(own))
    with torch.no_grad():
        for k, v in flat.items():
            own[k].copy_(torch.from_numpy(np.asarray(v))[None])


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


def fake_obs(seed, n=N, flat=False):
    """Observations as the env emits them (int counters and types,
    0/1 masks), in the reference [.., E, F] layout or the packed flat
    one."""
    rng = np.random.default_rng(seed)
    obs = {
        "prep_counter": rng.integers(0, 97, (n, 1)).astype(np.int32),
        "self_data": rng.standard_normal((n, 13)).astype(np.float32),
        "self_type": rng.integers(0, 2, (n, 1)).astype(np.int32),
        "self_mask": np.ones((n, 1), np.float32),
        "self_lidar": rng.uniform(size=(n, 30)).astype(np.float32),
        "agent_data": rng.standard_normal((n, 5, 14)).astype(np.float32),
        "box_data": rng.standard_normal((n, 9, 17)).astype(np.float32),
        "ramp_data": rng.standard_normal((n, 2, 14)).astype(np.float32),
        "vis_agents_mask": (rng.uniform(size=(n, 5, 1)) < 0.5),
        "vis_boxes_mask": (rng.uniform(size=(n, 9, 1)) < 0.5),
        "vis_ramps_mask": (rng.uniform(size=(n, 2, 1)) < 0.5),
    }
    if flat:
        for k in ("agent_data", "box_data", "ramp_data"):
            obs[k] = obs[k].reshape(n, -1)
        for k in ("vis_agents_mask", "vis_boxes_mask", "vis_ramps_mask"):
            obs[k] = obs[k][..., 0]
    return obs


def rnn_state(seed, n=N, c=256):
    rng = np.random.default_rng(seed)
    return tuple(tuple(0.5 * rng.standard_normal((1, n, c)).astype(np.float32)
                       for _ in range(2)) for _ in range(2))


def to_torch_tree(tree):
    return jax.tree.map(t, tree)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

LAYERS = {
    "layernorm": (lambda: jm.LayerNorm(),
                  lambda: tl.LayerNorm(1, 33), (4, 7, 33)),
    "rnn_norm": (lambda: nn.LayerNorm(),
                 lambda: tl.FlaxLayerNorm(1, 33), (4, 7, 33)),
    "mlp": (lambda: jm.MLP(num_channels=48, num_layers=3),
            lambda: tl.MLP(1, 33, 48, 3), (4, 7, 33)),
    "embed": (lambda: jm.layers.EmbedBlock(24),
              lambda: tl.EmbedBlock(1, 33, 24), (4, 7, 33)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make_j, make_t, shape = LAYERS[name]
    x = 3.0 * np.random.default_rng(1).standard_normal(shape).astype(
        np.float32) + 1.0
    jmod = make_j()
    params = perturbed(jmod.init(jax.random.PRNGKey(0), x))
    want = jmod.apply(params, x)
    mod = make_t()
    load_by_name(mod, params)
    got = mod(t(x)[None])
    assert got.shape == (1,) + want.shape
    close(got[0], want, ONE_STEP)


def test_lstm_step_and_sequence_match_jax():
    """Two layers, 16 channels: one step, then a 8-step sequence with
    episode ends set mid-sequence; the clear keeps NaN as NaN."""
    rng = np.random.default_rng(2)
    n, f, c, steps = 5, 10, 16, 8
    jl = jrnn.LSTM(num_hidden_channels=c, num_layers=2)
    x = rng.standard_normal((n, f)).astype(np.float32)
    st = tuple(rng.standard_normal((2, n, c)).astype(np.float32)
               for _ in range(2))
    params = perturbed(jl.init(jax.random.PRNGKey(3), st, x))
    out_j, (h_j, c_j) = jl.apply(params, st, x)
    tl_ = LSTM(1, f, c, num_layers=2)
    load_by_name(tl_, params)
    out_t, (h_t, c_t) = tl_(tuple(t(s)[None] for s in st), t(x)[None])
    close(out_t[0], out_j, ONE_STEP)
    close(h_t[0], h_j, ONE_STEP)
    close(c_t[0], c_j, ONE_STEP)

    seq_x = rng.standard_normal((steps, n, f)).astype(np.float32)
    ends = np.zeros((steps, n), bool)
    ends[2, 1] = ends[5, 3] = ends[5, 0] = True
    want = jl.apply(params, st, ends, seq_x, method=jrnn.LSTM.sequence)
    got = tl_.sequence(tuple(t(s)[None] for s in st), t(ends),
                       t(seq_x)[None])
    close(got[0], want, CHAINED)

    nan = (torch.full((2, n, c), float("nan")), torch.zeros((2, n, c)))
    h, _ = LSTM.clear_recurrent_state(nan, torch.ones(n, dtype=torch.bool))
    assert bool(torch.isnan(h).all())


def test_dreamer_critic_and_two_hot_loss_match_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((N, 32)).astype(np.float32)
    jc = jm.DreamerV3Critic()
    params = perturbed(jc.init(jax.random.PRNGKey(0), feats), scale=0.2)
    want = jc.apply(params, feats)
    tc = tl.DreamerV3Critic(1, 32)
    load_by_name(tc, params)
    np.testing.assert_array_equal(tc.bin_centers().numpy(),
                                  np.asarray(jc.bin_centers()))
    got = tc(t(feats)[None])
    close(got["logits"][0], want["logits"], ONE_STEP)
    # symexp multiplies the expected bin's rounding by 1 + |value|: the
    # value is held at 1e-5 plus 2e-6 of itself (values reach 15 here).
    np.testing.assert_allclose(got["value"][0].detach().numpy(),
                               np.asarray(want["value"]), rtol=2e-6,
                               atol=ONE_STEP)
    targets = np.concatenate([rng.standard_normal(N) * 30.0,
                              [0.0, -1e9, 1e9, 4.5]]).astype(np.float32)
    logits = rng.standard_normal((targets.size, 255)).astype(np.float32)
    close(tc.two_hot_loss(t(logits), t(targets)),
          jc.two_hot_loss(logits, targets), ONE_STEP)


def test_action_distributions_match_jax():
    rng = np.random.default_rng(5)
    buckets = (5, 5, 5, 2, 2)
    logits = (2.0 * rng.standard_normal((64, 19))).astype(np.float32)
    logits[0, :5] = 1.0                                  # a tie: first wins
    acts = np.stack([rng.integers(0, b, 64) for b in buckets], -1)
    jd = jm.DiscreteActionDistributions(buckets, jnp.asarray(logits))
    td = tl.DiscreteActionDistributions(buckets, t(logits))
    np.testing.assert_array_equal(td.best().numpy(), np.asarray(jd.best()))
    # Float32 rounding: a few units in the last place of sums near 10.
    for got, want in ((td.log_prob(t(acts)), jd.log_prob(acts)),
                      (td.entropy(), jd.entropy())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    # sample: frequencies of 40,000 draws within 5 standard errors of the
    # softmax probabilities, per bucket of every action dim.
    n_draw = 40000
    one = tl.DiscreteActionDistributions(
        buckets, t(np.repeat(logits[1:2], n_draw, 0)))
    draws = one.sample(prng.key(0)).numpy()
    off = 0
    for i, b in enumerate(buckets):
        p = np.asarray(jax.nn.softmax(logits[1, off:off + b]))
        freq = np.bincount(draws[:, i], minlength=b) / n_draw
        assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n_draw))
        off += b
    # The same draws as JAX's from the same key (a near tie aside: the
    # Gumbel noise differs by an ulp of log).
    for seed in range(4):
        np.testing.assert_array_equal(
            td.sample(prng.key(seed)).numpy(),
            np.asarray(jd.sample(jax.random.PRNGKey(seed))))


def test_normalizer_matches_jax():
    jpol = jpolicy.make_policy()
    tpol = tpolicy.make_policy(device="cpu")
    obs = fake_obs(6, flat=True)
    jn, tn = jpol.obs_preprocess, tpol.obs_preprocess
    jprep = jn.prep({k: jnp.asarray(v) for k, v in obs.items()})
    tprep = tn.prep({k: t(v) for k, v in obs.items()})
    assert set(jprep) == set(tprep)
    for k in jprep:
        np.testing.assert_array_equal(tprep[k].numpy(), np.asarray(jprep[k]))
    js = jn.init_state(jprep)
    ts = tn.init_state(tprep)
    obs2 = {k: v * 3.0 + 1.0 for k, v in fake_obs(7, flat=True).items()
            if v.dtype == np.float32}
    for o in (jprep, {**jprep, **obs2}):
        js = jn.update_state(js, o)
        ts = tn.update_state(ts, {k: t(np.asarray(v)) for k, v in o.items()})
    # EMA with decay 0.99999 barely moves: rescale the variance for the
    # normalize check so it divides by something other than ~1.
    js = js.replace(var={k: v * 4.0 for k, v in js.var.items()})
    ts = tnorm.NormalizerState(mean=ts.mean, count=ts.count,
                               var={k: v * 4.0 for k, v in ts.var.items()})
    assert float(ts.count) == float(js.count) == 2.0
    for k in js.mean:
        close(ts.mean[k], js.mean[k], 1e-7)
        close(ts.var[k], js.var[k], 1e-6)
    want = jn.normalize(js, jprep)
    got = tn.normalize(ts, tprep)
    for k in want:
        close(got[k], want[k], 1e-6)


@pytest.mark.parametrize("flat", [False, True], ids=["reference", "packed"])
def test_split_obs_matches_jax(flat):
    obs = {k: v.astype(np.float32) for k, v in fake_obs(8, flat=flat).items()}
    want = jpolicy.split_obs({k: jnp.asarray(v) for k, v in obs.items()})
    got = tpolicy.split_obs({k: t(v) for k, v in obs.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# Whole policies
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_policy(backbone, dtype):
    """(JAX policy, its perturbed params) initialised on fake_obs, cached
    per (backbone, dtype)."""
    pol = jpolicy.make_policy(dtype=dtype, backbone=backbone)
    obs = pol.obs_preprocess.prep(fake_obs(0))
    ac = pol.actor_critic
    params = jax.jit(ac.init)(jax.random.PRNGKey(1),
                              ac.init_recurrent_state(N), obs)
    return pol, perturbed(params, 1)


def forward_pair(backbone, dtype_j, dtype_t, steps):
    """``steps`` chained forwards of the JAX policy and its port on the
    same observations; yields (JAX outputs, port outputs) per step."""
    jpol, params = jax_policy(backbone, dtype_j)
    tpol = tpolicy.make_policy(dtype=dtype_t, backbone=backbone,
                               device="cpu")
    bridge.policy_params_from_numpy(params, tpol, "cpu")
    def japply(p, s, o):
        d, c, st = jpol.actor_critic.apply(p, s, o)
        return d.logits, c["value"], st

    st_j = st_t = rnn_state(9, c=256)
    st_t = to_torch_tree(st_t)
    for i in range(steps):
        obs = fake_obs(10 + i)
        jl, jv, st_j = japply(params, st_j, jpol.obs_preprocess.prep(obs))
        td, tc, st_t = tpol.actor_critic(
            st_t, tpol.obs_preprocess.prep({k: t(v) for k, v in obs.items()}))
        st_t = jax.tree.map(lambda x: x[0], st_t,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
        yield ((jl, jv, st_j),
               (td.logits[0], tc["value"][0], st_t))


def assert_outputs_close(want, got, tol):
    close(got[0], want[0], tol)
    close(got[1], want[1], tol)
    for a, b in zip(jax.tree.leaves(want[2]),
                    jax.tree.leaves(got[2], is_leaf=lambda x: isinstance(
                        x, torch.Tensor))):
        close(b, a, tol)


@pytest.mark.parametrize("backbone", ["pooled", "attention", "hash"])
def test_make_policy_matches_jax(backbone):
    """One step within 1e-5; the flagship also over 8 chained steps."""
    steps = 8 if backbone == "pooled" else 1
    for i, (want, got) in enumerate(forward_pair(backbone, jnp.float32,
                                                 torch.float32, steps)):
        assert_outputs_close(want, got, ONE_STEP if i == 0 else CHAINED)


@pytest.mark.parametrize("backbone", ["pooled", "attention", "hash"])
def test_make_policy_init_matches_flax(backbone):
    """The port draws each parameter as flax's ``init`` does from the
    same key (PRNGKey(1), ``jax_policy``'s): every drawn leaf (orthogonal
    kernels, the simhash projection and its He-normal table) within 1e-5;
    the constant leaves (zeros, ones) are the ones ``perturbed`` moved."""
    from marl_hideandseek_torch.models.layers import draw_params

    _, params = jax_policy(backbone, jnp.float32)
    want = bridge.flatten_tree(params["params"])
    tpol = tpolicy.make_policy(backbone=backbone, device="cpu")
    got = draw_params(tpol.actor_critic, prng.key(1)[None])
    assert set(got) == set(want)
    drawn = 0
    for k, v in got.items():
        v = v[0].numpy()
        if np.all(v == 0) or np.all(v == 1):
            continue
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        drawn += 1
    assert drawn >= 8


# bf16: both sides round the dense layers' inputs, kernels and outputs to
# bf16 (8 significant bits, a relative step of 2**-8 = 0.0039), but round
# at other points (torch's baddbmm adds the bias before the one rounding,
# flax rounds the product and then the sum), and LayerNorms after them
# re-scale the differences. Logits (orthogonal 0.01 head) and the LSTM
# states, float32 outside the dense layers, stay within 0.05 of JAX's; the
# critic's value, a symexp, within 0.05 too at these weights.
BF16_BAR = 5e-2


def test_pooled_policy_bf16_matches_jax():
    (want, got), = forward_pair("pooled", jnp.bfloat16, torch.bfloat16, 1)
    assert got[0].dtype == torch.bfloat16
    assert_outputs_close(want, got, BF16_BAR)


def ensemble_params(p):
    """(JAX flagship policy, p policies stacked on a leading axis): the
    initialised policy, each copy moved by its own seeded noise."""
    pol, params = jax_policy("pooled", jnp.float32)

    def moved(seed):
        rng = np.random.default_rng(100 + seed)
        return jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(
            x.shape).astype(np.float32), params)

    return pol, jax.tree.map(lambda *xs: np.stack(xs),
                             *[moved(i) for i in range(p)])


@pytest.mark.parametrize("p,num_train", [(1, None), (4, None), (4, 2)],
                         ids=["P1", "P4", "P4_train2"])
def test_apply_ensemble_matches_jax(p, num_train):
    jpol, params = ensemble_params(p)
    tpol = tpolicy.make_policy(device="cpu")
    tparams = bridge.policy_params_from_numpy(params, tpol, "cpu")
    assert next(iter(tparams.values())).shape[0] == p
    obs = fake_obs(20)
    assign = np.random.default_rng(21).integers(0, p, N).astype(np.int32)
    st = rnn_state(22)
    fn = jax.jit(lambda pr, s, o, a: jrollout.apply_ensemble(
        jpol, pr, s, o, a, p, num_train))
    want = fn(params, st, jpol.obs_preprocess.prep(obs), assign)
    got = apply_ensemble(
        tpol, tparams, to_torch_tree(st),
        tpol.obs_preprocess.prep({k: t(v) for k, v in obs.items()}),
        t(assign), p, num_train)
    assert_outputs_close(want, got, ONE_STEP)
    if num_train:
        past = assign >= num_train
        assert past.any() and not bool(got[1][t(past)].any())


def test_graft_entry_matches_jax():
    """``__graft_entry__.entry``: the flagship forward on its own 8-agent
    inputs and PRNGKey(1) weights."""
    import __graft_entry__

    fn, (params, rnn0, obs) = __graft_entry__.entry()
    want = fn(params, rnn0, obs)
    tpol = tpolicy.make_policy(device="cpu")
    bridge.policy_params_from_numpy(jax.tree.map(np.asarray, params), tpol,
                                    "cpu")
    td, tc, st = tpol.actor_critic(to_torch_tree(rnn0),
                                   {k: t(v) for k, v in obs.items()})
    close(td.logits[0], want[0], ONE_STEP)
    close(tc["value"][0], want[1], ONE_STEP)
    for a, b in zip(jax.tree.leaves(want[2]),
                    [x[0] for x in (*st[0], *st[1])]):
        close(b, a, ONE_STEP)


def test_bridge_rejects_missing_extra_and_misshaped_leaves():
    _, params = jax_policy("pooled", jnp.float32)
    tpol = tpolicy.make_policy(device="cpu")
    tree = jax.tree.map(np.asarray, params)["params"]
    missing = {**tree, "critic": {}}
    extra = {**tree, "bogus": {"kernel": np.zeros((2, 2), np.float32)}}
    wrong = jax.tree.map(lambda x: x, tree)
    wrong["actor"]["Dense_0"]["bias"] = np.zeros(18, np.float32)
    for bad, what in ((missing, "missing"), (extra, "extra"),
                      (wrong, "shape")):
        with pytest.raises(ValueError, match=what):
            bridge.policy_params_from_numpy(bad, tpol, "cpu")


def test_port_sources_import_no_jax():
    """No module of the port, and no line of chip_smoke.py, imports jax,
    flax, orbax or the JAX package."""
    banned = ("jax", "flax", "orbax", "marl_hideandseek_tpu")
    files = sorted((ROOT / "marl_hideandseek_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in banned]
    assert len(files) > 20 and not bad, bad

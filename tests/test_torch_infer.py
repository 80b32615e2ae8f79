"""PyTorch port: the inference path against the JAX package, on a trained
checkpoint.

``runs/ckpts/r4_learn/50000`` (4 flagship policies: 2 train, 2 past) is
read by the JAX package's ``eval_load_ckpt``, converted through the bridge
and written as the port's policy checkpoint (``save_policy_checkpoint``),
then read back by the port's ``eval_load_ckpt`` under each selector. The
slice as a whole: the port's inference loop (``infer.run_inference``) on
the port's CPU ``PackedEnv`` at 8 worlds and reduced capacity, 12
deterministic steps across an episode end, with the JAX normalize and
``apply_ensemble`` fed the port's observations as numpy and carrying
their own LSTM state alongside: logits and LSTM states within 1e-4, and
the same actions wherever the top two logits of a bucket differ by more
than 1e-4; then 12 stochastic steps whose sampled actions equal
``jax.random.categorical``'s from the same keys off such near-ties. The
ELO functions against JAX's on seeded match batches.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu import policy as jpolicy
from marl_hideandseek_tpu.models.normalizer import NormalizerState
from marl_hideandseek_tpu.train import elo as jelo
from marl_hideandseek_tpu.train import evaluate as jevaluate
from marl_hideandseek_tpu.train.rollout import apply_ensemble as japply

from marl_hideandseek_torch import bridge, prng
from marl_hideandseek_torch import policy as tpolicy
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.infer import run_inference
from marl_hideandseek_torch.models.normalizer import NormalizerState as TState
from marl_hideandseek_torch.train import elo as telo
from marl_hideandseek_torch.train.evaluate import eval_load_ckpt

torch.set_num_threads(1)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "runs" / "ckpts" / \
    "r4_learn" / "50000"
BAR = 1e-4
STEPS = 12
# tests/test_pallas_kernels.py:20-26's reduced capacity at 8 worlds (one
# hider, one seeker, 3 boxes), with 2 ramps: with one, the flat ramp mask
# [N, 1] reads as the reference layout in split_obs (JAX's as well), and
# an 8-step episode so that the run crosses an episode end.
CFG = EnvConfig(num_worlds=8, min_hiders=1, max_hiders=1, min_seekers=1,
                max_seekers=1, max_boxes=3, max_ramps=2, episode_len=8,
                sim_flags=SimFlags.UseFixedWorld | SimFlags.ZeroAgentVelocity,
                rand_seed=5)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def stats_np(st):
    return {"mean": np_tree(st.mean), "var": np_tree(st.var),
            "count": np.asarray(st.count)}


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The JAX loads under the three selectors, and the port's checkpoint
    file written from the default and train-only loads."""
    jpol = jpolicy.make_policy()
    loads = {
        "default": jevaluate.eval_load_ckpt(jpol, str(CKPT)),
        "train_only": jevaluate.eval_load_ckpt(jpol, str(CKPT),
                                               train_only=True),
        "single_2": jevaluate.eval_load_ckpt(jpol, str(CKPT),
                                             single_policy=2),
    }
    tpol = tpolicy.make_policy(device="cpu")
    p_all, stats, elo = loads["default"]
    p_train = loads["train_only"][0]
    n_train = jax.tree.leaves(p_train)[0].shape[0]
    params = bridge.policy_params_from_numpy(np_tree(p_train), tpol)
    past = bridge.policy_params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x)[n_train:], p_all), tpol)
    path = tmp_path_factory.mktemp("ckpt") / "r4_50000.pt"
    bridge.save_policy_checkpoint(
        path, params, bridge.normalizer_state_from_numpy(stats_np(stats)),
        np.asarray(elo), past_params=past)
    return jpol, tpol, loads, path


@pytest.mark.parametrize("selector", ["default", "train_only", "single_2"])
def test_checkpoint_round_trip_is_exact(converted, selector):
    jpol, tpol, loads, path = converted
    kw = {"default": {}, "train_only": {"train_only": True},
          "single_2": {"single_policy": 2}}[selector]
    want_p, want_s, want_elo = loads[selector]
    got_p, got_s, got_elo = eval_load_ckpt(tpol, path, device="cpu", **kw)
    want_flat = bridge.flatten_tree(np_tree(want_p)["params"])
    assert set(got_p) == set(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(got_p[k].numpy(), v)
    np.testing.assert_array_equal(got_elo.numpy(), np.asarray(want_elo))
    for k in want_s.mean:
        np.testing.assert_array_equal(got_s.mean[k].numpy(),
                                      np.asarray(want_s.mean[k]))
        np.testing.assert_array_equal(got_s.var[k].numpy(),
                                      np.asarray(want_s.var[k]))
    assert set(got_s.mean) == set(want_s.mean)
    assert float(got_s.count) == float(want_s.count) == 50000.0


def test_inference_loop_matches_jax(converted):
    """The slice as a whole on the tracked checkpoint's 4 policies."""
    _loop_against_jax(converted, deterministic=True)


def test_stochastic_loop_samples_jax_actions(converted):
    """The stochastic loop: step i samples with ``key, sub = split(key)``
    from PRNGKey(7), as scripts/infer.py does; each action equals the
    argmax of JAX's Gumbel noise (``jax.random.categorical``'s, from
    ``split(sub, 5)``) plus JAX's logits wherever its top two differ by
    more than the logits bar."""
    _loop_against_jax(converted, deterministic=False)


def _loop_against_jax(converted, deterministic):
    jpol, tpol, loads, path = converted
    params, stats, _ = eval_load_ckpt(tpol, path, device="cpu")
    env = PackedEnv(CFG, device="cpu")
    n = CFG.num_worlds * CFG.max_agents
    # The statistics cover full capacity; the reduced env's flat entity
    # features are their first E x F entries.
    width = {k: v.shape[-1] for k, v in env.init()[1].obs.items()}
    cut = TState(mean={k: v[:width[k]] for k, v in stats.mean.items()},
                 var={k: v[:width[k]] for k, v in stats.var.items()},
                 count=stats.count)
    jparams, jstats_full, _ = loads["default"]
    jstats = NormalizerState(
        mean={k: v[:width[k]] for k, v in jstats_full.mean.items()},
        var={k: v[:width[k]] for k, v in jstats_full.var.items()},
        count=jstats_full.count)
    jfwd = jax.jit(lambda pr, o, s, a: japply(
        jpol, pr, s, jpol.obs_preprocess.normalize(jstats, o), a, 4))
    jstate = [jpol.actor_critic.init_recurrent_state(n)]
    seen = {"steps": 0, "dones": 0, "ties": 0}
    buckets = np.cumsum((0, 5, 5, 5, 2, 2))
    key = [jax.random.PRNGKey(7)]

    def check(d):
        obs = {k: v.numpy() for k, v in d["obs"].items()}
        logits_j, _, new_j = jfwd(jparams, obs, jstate[0],
                                  d["assignments"].numpy())
        logits_j = np.asarray(logits_j)
        np.testing.assert_allclose(d["logits"].numpy(), logits_j, rtol=0,
                                   atol=BAR)
        if not deterministic:
            key[0], sub = jax.random.split(key[0])
            bucket_keys = jax.random.split(sub, len(buckets) - 1)
        for lo, hi in zip(buckets[:-1], buckets[1:]):
            i = np.searchsorted(buckets, lo)
            lg = logits_j[:, lo:hi]
            if not deterministic:
                lg = lg + np.asarray(jax.random.gumbel(
                    bucket_keys[i], lg.shape))
            top2 = np.sort(lg, -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > BAR
            act = d["actions"][:, i].numpy()
            np.testing.assert_array_equal(act[clear],
                                          lg.argmax(-1)[clear])
            seen["ties"] += int((~clear).sum())
        dones = d["result"].dones.T.reshape(-1).numpy().astype(bool)
        jstate[0] = jpol.actor_critic.clear_recurrent_state(new_j, dones)
        for a, b in zip(jax.tree.leaves(jstate[0]),
                        [x for enc in d["rnn_next"] for x in enc]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=BAR)
        seen["steps"] += 1
        seen["dones"] += int(d["dones"].sum())

    out = run_inference(env, tpol, params, cut, STEPS,
                        deterministic=deterministic, iter_cb=check)
    assert seen["steps"] == STEPS and seen["dones"] == CFG.num_worlds
    assert out["episodes_finished"] == CFG.num_worlds
    assert seen["ties"] < STEPS * n            # most actions were compared


def test_elo_functions_match_jax():
    rng = np.random.default_rng(3)
    p, w = 4, 64
    elo = (1500 + 80 * rng.standard_normal(p)).astype(np.float32)
    for _ in range(3):
        res = rng.choice([0.0, 0.5, 1.0], size=(w, 2)).astype(np.float32)
        pol = rng.integers(-1, p, size=(w, 2)).astype(np.int32)
        done = rng.uniform(size=w) < 0.6
        want_m = jelo.matches_from_episode_results(res, pol, done)
        got_m = telo.matches_from_episode_results(
            torch.from_numpy(res), torch.from_numpy(pol),
            torch.from_numpy(done))
        for g, x in zip(got_m, want_m):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        want = np.asarray(jelo.update_elo_pairwise(jnp.asarray(elo),
                                                   *want_m))
        got = telo.update_elo_pairwise(torch.from_numpy(elo), *got_m).numpy()
        # float32 sums over the matches in another order: 1e-3 of ~1500.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        assert np.abs(got - elo).max() > 1.0
        elo = got
    e = telo.elo_expected(torch.tensor([1500.0, 1700.0]),
                          torch.tensor([1600.0, 1400.0]))
    np.testing.assert_allclose(
        e.numpy(), np.asarray(jelo.elo_expected(jnp.array([1500.0, 1700.0]),
                                                jnp.array([1600.0, 1400.0]))),
        rtol=1e-6)


def test_infer_cli_runs_on_the_cpu(converted, capsys):
    """``python -m marl_hideandseek_torch.infer`` on the converted file:
    3v3 at full capacity, 2 worlds, 3 steps, the train policies only."""
    from marl_hideandseek_torch import infer

    _, _, loads, path = converted
    assert infer.main(["--ckpt-path", str(path), "--num-worlds", "2",
                       "--num-steps", "3", "--train-only", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "total wins by team slot" in out and "ELOs:" in out
    assert out.count("policy ") == 2


def test_eval_policies_on_the_classic_env():
    """``eval_policies`` on the port's classic env (3v2, 4 worlds, 100-step
    episodes: the seek phase, which scores, starts at step 96): competitive round robin of 4 seeded policies, the ELOs move
    at the episode end and stay finite with mean 1500; hiders play t0,
    seekers t1."""
    from marl_hideandseek_torch.env.env import HideAndSeekEnv
    from marl_hideandseek_torch.train import ActionsConfig, EvalConfig
    from marl_hideandseek_torch.train.evaluate import eval_policies
    from marl_hideandseek_torch.types import AGENT_HIDER

    cfg = EnvConfig(num_worlds=4, min_hiders=3, max_hiders=3, min_seekers=2,
                    max_seekers=2, episode_len=100, rand_seed=5)
    env = HideAndSeekEnv(cfg, device="cpu")
    pol = tpolicy.make_policy(num_policies=4, device="cpu",
                              key=prng.key(3))
    params = dict(pol.actor_critic.named_parameters())
    obs0 = env.init()[1].obs
    stats = pol.obs_preprocess.init_state(
        {k: v.flatten(0, 1) for k, v in
         pol.obs_preprocess.prep(obs0).items()})
    ecfg = EvalConfig(num_worlds=4, num_teams=2, team_size=3,
                      num_eval_steps=100, actions=ActionsConfig())
    steps = []
    out = eval_policies(None, ecfg, env, pol, params, stats,
                        iter_cb=steps.append)
    assert len(steps) == 100 and out["episodes_finished"] == 4
    elo = out["elo"]
    assert bool(torch.isfinite(elo).all())
    assert abs(float(elo.mean()) - 1500.0) < 1e-3
    assert float((elo - 1500.0).abs().max()) > 0.0
    t0, t1 = out["matchups"]
    assert t0.tolist() == [0, 1, 2, 3] and t1.tolist() == [1, 2, 3, 0]
    hiders = steps[0]["state"].agent_type == AGENT_HIDER
    assert bool(hiders.any()) and bool((~hiders).any())

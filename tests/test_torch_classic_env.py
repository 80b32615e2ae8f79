"""PyTorch port: the classic world-major HideAndSeekEnv (env/env.py) held
to the JAX package's HideAndSeekEnv on the same inputs. The port's world
generator draws from another random stream, so the JAX-generated worlds
are injected (``worldgen``), as in tests/test_torch_env.py. Covers init,
the no-reset, full and compact reset branches, global_positions and
seeds at the one-step bars; chained steps at the JAX kernels' bars; the
unfused branch (K2 + the standalone sweep) against the fused one.
tests/test_torch_golden.py replays tests/golden_trace.npz."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.env import HideAndSeekEnv as JEnv
from marl_hideandseek_torch import bridge, headless
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from test_torch_env import (
    JCFG,
    OBS_TOL,
    TCFG,
    W,
    actions,
    assert_state_close,
    make_jax_worldgen,
    to_np,
)

A = TCFG.max_agents
# The JAX kernels' bars against their own oracles
# (tests/test_pallas_kernels.py:59-110): value bar, fraction within it.
KERNEL = dict(pos=(5e-3, 0.995), quat=(5e-3, 0.995), vel=(0.5, 0.995),
              omega=(0.5, 0.995))


@pytest.fixture(scope="module")
def envs():
    """(jitted JAX init, jitted JAX step, port env): one compile each."""
    jenv = JEnv(JCFG)
    tenv = HideAndSeekEnv(TCFG, device="cpu", worldgen=make_jax_worldgen())
    return jax.jit(jenv.init), jax.jit(jenv.step), tenv, jenv


def world_major_actions(seed):
    """[W, A, 5] actions (tests/test_torch_env.actions, world axis first)."""
    return np.ascontiguousarray(np.moveaxis(actions(seed), -1, 0))


def assert_result_close(tres, jres):
    assert tres.obs.keys() == jres.obs.keys()
    for k, v in jres.obs.items():
        assert tuple(tres.obs[k].shape) == v.shape, k
        np.testing.assert_allclose(tres.obs[k].numpy(), np.asarray(v),
                                   atol=OBS_TOL, err_msg=f"obs[{k}]")
    for name in ("rewards", "dones", "episode_results"):
        a = getattr(tres, name).numpy()
        b = np.asarray(getattr(jres, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_init_matches_jax(envs):
    jinit, _, tenv, jenv = envs
    jst, jres = jinit(jax.random.PRNGKey(JCFG.rand_seed))
    tst, tres = tenv.init()
    assert_state_close(tst, jst)
    assert_result_close(tres, jres)
    np.testing.assert_allclose(tenv.global_positions(tst).numpy(),
                               np.asarray(jenv.global_positions(jst)),
                               atol=1e-6)
    np.testing.assert_array_equal(tenv.seeds(tst).numpy(),
                                  np.asarray(jenv.seeds(jst)))


def test_steps_across_episode_end_match_jax(envs):
    """Steps 237 -> 238 -> 239 -> (the full reset of every world) 0 -> 1:
    the no-reset branch, the full branch with the JAX-regenerated worlds
    merged and re-swept, then a step on the fresh worlds; each step from
    the same input on both sides."""
    jinit, jstep, tenv, _ = envs
    jst, _ = jinit(jax.random.PRNGKey(JCFG.rand_seed))
    jst = jst.replace(step=jnp.full_like(jst.step, 237))
    tst = bridge.state_from_numpy(to_np(jst))
    full0 = tenv.reset_counts["full"]
    for i in range(4):
        acts = world_major_actions(i)
        jst, jres = jstep(jst, jnp.asarray(acts), jnp.zeros(W, jnp.int32))
        tst, tres = tenv.step(tst, torch.from_numpy(acts))
        assert_state_close(tst, jst)
        assert_result_close(tres, jres)
        tst = bridge.state_from_numpy(to_np(jst))
    assert tenv.reset_counts["full"] == full0 + 1
    assert int(tst.step[0]) == 1
    assert int(tst.episode_counter[0]) == 1


def test_compact_reset_matches_jax(envs):
    """Two external resets under reset_budget = 2 take the compact branch
    (one to debug level 3); a burst of eight takes the full branch."""
    jinit, jstep, tenv, _ = envs
    jst, _ = jinit(jax.random.PRNGKey(JCFG.rand_seed))
    jst = jst.replace(step=jnp.full_like(jst.step, 50))
    tst = bridge.state_from_numpy(to_np(jst))
    resets = np.zeros(W, np.int32)
    resets[1] = 1
    resets[6] = 3
    acts = world_major_actions(11)
    c0, f0 = tenv.reset_counts["compact"], tenv.reset_counts["full"]
    jst2, jres = jstep(jst, jnp.asarray(acts), jnp.asarray(resets))
    tst2, tres = tenv.step(tst, torch.from_numpy(acts),
                           torch.from_numpy(resets))
    assert tenv.reset_counts["compact"] == c0 + 1
    assert_state_close(tst2, jst2)
    assert_result_close(tres, jres)
    burst = np.ones(W, np.int32)
    jst3, jres3 = jstep(jst2, jnp.asarray(acts), jnp.asarray(burst))
    tst3, tres3 = tenv.step(bridge.state_from_numpy(to_np(jst2)),
                            torch.from_numpy(acts), torch.from_numpy(burst))
    assert tenv.reset_counts["full"] == f0 + 1
    assert_state_close(tst3, jst3)
    assert_result_close(tres3, jres3)


def test_chained_steps_match_jax(envs):
    """Twelve chained steps from the same seek-phase state, no re-sync:
    bodies at the JAX kernels' bars, ids, flags, rewards, dones and
    scores exact."""
    jinit, jstep, tenv, _ = envs
    jst, _ = jinit(jax.random.PRNGKey(JCFG.rand_seed))
    jst = jst.replace(step=jnp.full_like(jst.step, 120))
    tst = bridge.state_from_numpy(to_np(jst))
    for i in range(12):
        acts = world_major_actions(100 + i)
        jst, jres = jstep(jst, jnp.asarray(acts), jnp.zeros(W, jnp.int32))
        tst, tres = tenv.step(tst, torch.from_numpy(acts))
        jb, tb = to_np(jst.bodies), bridge.state_to_numpy(tst)["bodies"]
        for name, (tol, need) in KERNEL.items():
            frac = (np.abs(tb[name] - jb[name]) < tol).mean()
            assert frac >= need, (i, name, frac)
        for name in ("locked", "owner"):
            np.testing.assert_array_equal(tb[name], jb[name])
        np.testing.assert_array_equal(tst.grab.target.numpy(),
                                      np.asarray(jst.grab.target))
        np.testing.assert_array_equal(tst.act_hit_id.numpy(),
                                      np.asarray(jst.act_hit_id))
        np.testing.assert_array_equal(tst.running_scores.numpy(),
                                      np.asarray(jst.running_scores))
        np.testing.assert_array_equal(tres.rewards.numpy(),
                                      np.asarray(jres.rewards))
        np.testing.assert_array_equal(tres.dones.numpy(),
                                      np.asarray(jres.dones))


def test_unfused_branch_matches_fused():
    """fused=False (K2 then the standalone sweep) computes what the fused
    step computes: on CPU both are the same plain functions."""
    a = HideAndSeekEnv(TCFG, device="cpu")
    b = HideAndSeekEnv(TCFG, device="cpu", fused=False)
    sa, _ = a.init()
    sb, _ = b.init()
    for i in range(3):
        acts = torch.from_numpy(world_major_actions(200 + i))
        sa, ra = a.step(sa, acts)
        sb, rb = b.step(sb, acts)
    for x, y in zip(sa.leaves(), sb.leaves()):
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.uint32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.uint32 else y)
    for k in ra.obs:
        assert torch.equal(ra.obs[k], rb.obs[k]), k


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        HideAndSeekEnv(TCFG)
    with pytest.raises(RuntimeError, match="cuda"):
        headless.main(["4", "1"])


@pytest.mark.parametrize("extra", [["--rand-actions"], ["--level", "8"]])
def test_headless_runner_on_cpu(capsys, extra):
    """The headless runner at a tiny size on the plain path: it steps,
    checks for NaN and reports its rate with the device."""
    assert headless.main(["4", "2", "--device", "cpu", *extra]) == 0
    out = capsys.readouterr().out
    assert "steps x worlds / s" in out and "cpu" in out

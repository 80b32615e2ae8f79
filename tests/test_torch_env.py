"""PyTorch port: PackedEnv.init / step (env/packed.py) held to the JAX
PackedEnv's fallback path, including the episode-end full reset and the
compact reset. Most cases inject the JAX-generated worlds through the
bridge (PackedEnv's ``worldgen``) and compare the merge, the re-sweep and
the observations exactly where the arithmetic is shared; one holds the
port's own generator (JAX's threefry keys, ``prng.py``) to JAX's init
and resets."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import env as jenv_mod
from marl_hideandseek_tpu.env import levelgen as jlevelgen
from marl_hideandseek_tpu.env import packed as jp
from marl_hideandseek_torch import bridge, prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import observations as tobs
from marl_hideandseek_torch.env import packed as tp
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from marl_hideandseek_torch.types import pack_state

W = 8
KW = dict(num_worlds=W, min_hiders=2, max_hiders=2, min_seekers=2,
          max_seekers=2, reset_budget=2)
JCFG = JCfg(**KW, sim_flags=JFlags.ZeroAgentVelocity | JFlags.RandomFlipTeams)
TCFG = EnvConfig(**KW, sim_flags=SimFlags.ZeroAgentVelocity |
                 SimFlags.RandomFlipTeams)
A = TCFG.max_agents

# One step on the same input: float32 op-order noise (see
# tests/test_torch_step.py); observations are rotations of these.
TIGHT = dict(pos=1e-4, quat=1e-4, vel=1.2e-2, omega=2.4e-2)
OBS_TOL = 1e-3


def to_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def make_jax_worldgen(jcfg=JCFG):
    """JAX's _draw_episode + generate_world, vmapped with the world axis
    last, as a port worldgen callable."""

    def one(base, wid, counter, lvl):
        ep_key, level_key, n_h, n_s, flip = jenv_mod._draw_episode(
            jcfg, base, wid, counter)
        return jlevelgen.generate_world(jcfg, level_key, ep_key, lvl, n_h,
                                        n_s, flip)

    f = jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0), out_axes=-1))

    def worldgen(base_key, world_ids, episode_counter, level_ids):
        st = f(jnp.asarray(base_key.view(torch.int32).numpy().view(
                   np.uint32)),
               jnp.asarray(world_ids.numpy().astype(np.uint32)),
               jnp.asarray(episode_counter.numpy().astype(np.uint32)),
               jnp.asarray(level_ids.numpy().astype(np.int32)))
        return bridge.state_from_numpy(to_np(st))

    return worldgen


def make_jax_levelgen(jcfg=JCFG):
    """JAX's generate_world from given keys, vmapped with the world axis
    last, as a port levelgen callable (checkpoint loads)."""
    f = jax.jit(jax.vmap(
        lambda lk, ek, lvl, n_h, n_s, flip: jlevelgen.generate_world(
            jcfg, lk, ek, lvl, n_h, n_s, flip),
        in_axes=(1, 1, 0, 0, 0, 0), out_axes=-1))

    def levelgen(level_key, ep_key, level_ids, n_h, n_s, flip):
        u32 = lambda k: jnp.asarray(k.view(torch.int32).numpy()
                                    .view(np.uint32))
        st = f(u32(level_key), u32(ep_key),
               jnp.asarray(level_ids.numpy().astype(np.int32)),
               jnp.asarray(n_h.numpy().astype(np.int32)),
               jnp.asarray(n_s.numpy().astype(np.int32)),
               jnp.asarray(flip.numpy()))
        return bridge.state_from_numpy(to_np(st))

    return levelgen


@pytest.fixture(scope="module")
def envs():
    """(jitted JAX init, jitted JAX step taking explicit resets, port
    env): one compile of each for the whole file."""
    jenv = jp.PackedEnv(JCFG, force_fallback=True)
    tenv = tp.PackedEnv(TCFG, device="cpu", worldgen=make_jax_worldgen())
    return jax.jit(jenv.init), jax.jit(jenv.step), tenv


NO_RESETS = np.zeros(W, np.int32)


def actions(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, 5, (A, 3, W)),
                           rng.integers(0, 2, (A, 2, W))], 1).astype(np.int32)


def assert_state_close(tps, jps, bars=TIGHT):
    jn = to_np(jps)
    tn = bridge.state_to_numpy(tps)
    for key, sub in jn.items():
        if isinstance(sub, dict):
            for k2, a in sub.items():
                b = tn[key][k2]
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(
                        b, a, atol=bars.get(k2, 1e-5), rtol=1e-4,
                        err_msg=f"{key}.{k2}")
                else:
                    np.testing.assert_array_equal(b, a, err_msg=f"{key}.{k2}")
        elif sub.dtype.kind == "f":
            np.testing.assert_allclose(tn[key], sub, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(tn[key], sub, err_msg=key)


def assert_result_close(tres, jres):
    for k, v in jres.obs.items():
        np.testing.assert_allclose(tres.obs[k].numpy(), np.asarray(v),
                                   atol=OBS_TOL, err_msg=f"obs[{k}]")
    jref = jp.reference_obs(JCFG, jres.obs)
    tref = tobs.reference_obs(TCFG, tres.obs)
    for k, v in jref.items():
        assert tuple(tref[k].shape) == tuple(v.shape), k
    np.testing.assert_array_equal(tres.rewards.numpy(),
                                  np.asarray(jres.rewards))
    np.testing.assert_array_equal(tres.dones.numpy(), np.asarray(jres.dones))
    np.testing.assert_array_equal(tres.episode_results.numpy(),
                                  np.asarray(jres.episode_results))


def test_init_matches_jax(envs):
    jinit, _, tenv = envs
    jps, jres = jinit(jax.random.PRNGKey(JCFG.rand_seed))
    tps, tres = tenv.init()
    assert_state_close(tps, jps)
    assert_result_close(tres, jres)


def test_steps_across_episode_end_match_jax(envs):
    """Steps 237 -> 238 -> 239 -> (the full reset of every world) 0 -> 1: the
    no-reset branch, then the full branch with the JAX-regenerated worlds
    merged and re-swept, then a step on the fresh worlds."""
    jinit, jstep, tenv = envs
    jps, _ = jinit(jax.random.PRNGKey(JCFG.rand_seed))
    jps = jps.replace(step=jnp.full_like(jps.step, 237))
    tps = bridge.state_from_numpy(to_np(jps))
    full0 = tenv.reset_counts["full"]
    for i in range(4):
        acts = actions(i)
        jps, jres = jstep(jps, jnp.asarray(acts), jnp.asarray(NO_RESETS))
        tps, tres = tenv.step(tps, torch.from_numpy(acts))
        # The regenerated worlds are the JAX ones; re-sync the bodies so
        # op-order noise from earlier steps does not accumulate.
        assert_state_close(tps, jps)
        assert_result_close(tres, jres)
        np.testing.assert_array_equal(tres.team_reward.numpy(),
                                      np.asarray(jres.team_reward))
        tps = bridge.state_from_numpy(to_np(jps))
    assert tenv.reset_counts["full"] == full0 + 1
    assert int(tps.step[0]) == 1
    assert int(tps.episode_counter[0]) == 1


def test_compact_reset_matches_jax(envs):
    """Two external resets under reset_budget = 2 take the compact branch
    (one to a debug level); a burst of eight takes the full branch."""
    jinit, jstep, tenv = envs
    jps, _ = jinit(jax.random.PRNGKey(9))
    jps = jps.replace(step=jnp.full_like(jps.step, 50))
    tps = bridge.state_from_numpy(to_np(jps))
    resets = np.zeros(W, np.int32)
    resets[1] = 1
    resets[6] = 3
    acts = actions(11)
    c0, f0 = tenv.reset_counts["compact"], tenv.reset_counts["full"]
    jps2, jres = jstep(jps, jnp.asarray(acts), jnp.asarray(resets))
    tps2, tres = tenv.step(tps, torch.from_numpy(acts),
                           torch.from_numpy(resets))
    assert tenv.reset_counts["compact"] == c0 + 1
    assert_state_close(tps2, jps2)
    assert_result_close(tres, jres)
    burst = np.ones(W, np.int32)
    jps3, jres3 = jstep(jps2, jnp.asarray(acts), jnp.asarray(burst))
    tps3, tres3 = tenv.step(bridge.state_from_numpy(to_np(jps2)),
                            torch.from_numpy(acts), torch.from_numpy(burst))
    assert tenv.reset_counts["full"] == f0 + 1
    assert_state_close(tps3, jps3)
    assert_result_close(tres3, jres3)


def test_default_generator_matches_jax_through_resets(envs):
    """The port's own generator, no injection: ``init(key)`` equals JAX's
    jitted ``init(key)``, and from JAX's state the port's steps track
    JAX's through the episode-end full reset, a compact reset (one world
    to a debug level) and a burst of resets, the regenerated worlds
    drawn from PRNGKey(rand_seed) on both sides, at the one-step bars."""
    jinit, jstep, _ = envs
    tenv = tp.PackedEnv(TCFG, device="cpu")
    jps, jres = jinit(jax.random.PRNGKey(9))
    tps, tres = tenv.init(prng.key(9))
    assert_state_close(tps, jps)
    assert_result_close(tres, jres)

    jps = jps.replace(step=jnp.full_like(jps.step, 238))
    compact = np.zeros(W, np.int32)
    compact[[1, 6]] = [1, 3]
    runs = [NO_RESETS, NO_RESETS, compact, np.ones(W, np.int32)]
    for i, resets in enumerate(runs):
        acts = actions(20 + i)
        tps, tres = tenv.step(bridge.state_from_numpy(to_np(jps)),
                              torch.from_numpy(acts),
                              torch.from_numpy(resets))
        jps, jres = jstep(jps, jnp.asarray(acts), jnp.asarray(resets))
        assert_state_close(tps, jps)
        assert_result_close(tres, jres)
    assert tenv.reset_counts == {"full": 2, "compact": 1}


def test_compact_merge_first_occurrence_and_float_contract():
    """The compact merge writes each triggered world once (its first slot
    of the padded batch) and turns non-finite regenerated floats into
    +inf (packed.py:677-695)."""
    cfg = TCFG.replace(reset_budget=4)
    env = tp.PackedEnv(cfg, device="cpu")
    ps, _ = env.init()
    calls = []

    def worldgen(base_key, world_ids, counter, level_ids):
        calls.append(world_ids.clone())
        new = env_default(base_key, world_ids, counter, level_ids)
        bad = new.bodies.vel.clone()
        bad[0, 0, :] = float("nan")
        bad[0, 1, :] = -float("inf")
        return new.replace(bodies=new.bodies.replace(vel=bad))

    env_default = env.worldgen
    env.worldgen = worldgen
    trigger = torch.zeros(W, dtype=torch.bool)
    trigger[[2, 5]] = True
    level_ids = torch.ones(W, dtype=torch.long)
    sweep = tp.standalone_sweep_packed(cfg, ps)
    base = prng.key(cfg.rand_seed)
    new_ps, _ = env._compact_resets(ps, sweep, trigger, level_ids,
                                    torch.arange(W), base)
    np.testing.assert_array_equal(calls[0].numpy(), [2, 5, 2, 2])
    # The ids reach the default worldgen's draws: worlds 2 and 5 are the
    # episodes keyed by their own ids (counter 1).
    fresh = env_default(base, torch.tensor([2, 5]),
                        torch.ones(2, dtype=torch.long),
                        torch.ones(2, dtype=torch.long))
    assert torch.equal(new_ps.level_key.view(torch.int32)[..., [2, 5]],
                       fresh.level_key.view(torch.int32))
    assert torch.equal(new_ps.statics.wall_pos[..., [2, 5]],
                       fresh.statics.wall_pos)
    v = new_ps.bodies.vel
    assert bool(torch.isinf(v[0, 0, [2, 5]]).all())
    assert bool((v[0, 0, [2, 5]] > 0).all())
    assert bool((v[0, 1, [2, 5]] == float("inf")).all())
    untouched = [i for i in range(W) if i not in (2, 5)]
    assert torch.equal(new_ps.bodies.pos[..., untouched],
                       ps.bodies.pos[..., untouched])
    assert bool((new_ps.step[[2, 5]] == 0).all())
    assert bool((new_ps.step[untouched] == ps.step[untouched] + 1).all())
    assert bool((new_ps.episode_counter[[2, 5]].long() == 1).all())


def test_classic_compact_merge_scatters_values_unchanged():
    """The classic env's core runs the one compact reset path
    (``PackedEnv._compact_resets``): it writes each triggered world once
    and, under the classic merge contract, scatters regenerated values
    unchanged, NaN and -inf included, as the JAX classic env does
    (env.py:470-474)."""
    cfg = TCFG.replace(reset_budget=4)
    env = HideAndSeekEnv(cfg, device="cpu")
    assert type(env._core)._compact_resets is tp.PackedEnv._compact_resets
    state, _ = env.init()
    ps = pack_state(state)
    calls = []
    env_default = env.worldgen

    def worldgen(base_key, world_ids, counter, level_ids):
        calls.append(world_ids.clone())
        new = env_default(base_key, world_ids, counter, level_ids)
        bad = new.bodies.vel.clone()
        bad[0, 0, :] = float("nan")
        bad[0, 1, :] = -float("inf")
        return new.replace(bodies=new.bodies.replace(vel=bad))

    env.worldgen = worldgen
    trigger = torch.zeros(W, dtype=torch.bool)
    trigger[[2, 5]] = True
    level_ids = torch.ones(W, dtype=torch.long)
    sweep = tp.standalone_sweep_packed(cfg, ps)
    new, _ = env._core._compact_resets(ps, sweep, trigger, level_ids,
                                       torch.arange(W),
                                       prng.key(cfg.rand_seed))
    np.testing.assert_array_equal(calls[0].numpy(), [2, 5, 2, 2])
    v = new.bodies.vel
    assert bool(torch.isnan(v[0, 0, [2, 5]]).all())
    assert bool((v[0, 1, [2, 5]] == -float("inf")).all())
    untouched = [i for i in range(W) if i not in (2, 5)]
    assert torch.equal(new.bodies.pos[..., untouched],
                       ps.bodies.pos[..., untouched])
    assert bool((new.step[[2, 5]] == 0).all())
    assert bool((new.episode_counter.long()[[2, 5]] == 1).all())


def test_torch_levelgen_env_runs_finite():
    """The port on its own (torch levelgen): init, steps across compact
    and full resets, every float finite (act_hit_t may be +inf)."""
    env = tp.PackedEnv(TCFG, device="cpu")
    ps, res = env.init()
    g = torch.Generator().manual_seed(0)
    for i in range(6):
        acts = torch.cat([torch.randint(0, 5, (A, 3, W), generator=g),
                          torch.randint(0, 2, (A, 2, W), generator=g)], 1)
        resets = torch.zeros(W, dtype=torch.int32)
        if i == 2:
            resets[3] = 1
        if i == 4:
            resets[:] = 1
        ps, res = env.step(ps, acts, resets)
        for t in ps.leaves():
            if t.is_floating_point():
                assert bool((torch.isfinite(t) | (t == float("inf"))).all())
        for k, v in res.obs.items():
            assert bool(torch.isfinite(v.float()).all()), k
    assert env.reset_counts == {"full": 1, "compact": 1}
    assert res.obs["box_data"].shape == (W, A, 9 * 17)


@pytest.mark.parametrize("flag", ["UseFixedWorld", "IgnoreEpisodeLength"])
def test_sim_flags(flag):
    """UseFixedWorld: one layout for every world and episode (JAX's
    all-zero level key). IgnoreEpisodeLength: no reset at step 239."""
    cfg = TCFG.replace(sim_flags=SimFlags[flag])
    env = tp.PackedEnv(cfg, device="cpu")
    ps, _ = env.init()
    ps = ps.replace(step=torch.full_like(ps.step, 239))
    acts = torch.zeros((A, 5, W), dtype=torch.int32)
    ps2, res = env.step(ps, acts)
    if flag == "UseFixedWorld":
        for p in (ps, ps2):
            wp = p.statics.wall_pos
            assert torch.equal(wp, wp[..., :1].expand_as(wp))
        assert torch.equal(ps.statics.wall_pos, ps2.statics.wall_pos)
        assert bool((ps2.level_key == 0).all())
        assert bool((ps2.step == 0).all())
    else:
        assert env.reset_counts == {"full": 0, "compact": 0}
        assert bool((ps2.step == 240).all())
        assert bool((res.dones == 1).all())


def test_cuda_device_without_card_raises(monkeypatch):
    """Asking for CUDA without a card raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.PackedEnv(TCFG)

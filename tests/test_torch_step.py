"""PyTorch port: the megastep's plain version (ops/step.py, the plain
side of the K4 kernel) and the packed step systems held to the JAX
package's fallback branch (env/packed.py:576-595) on the same states and
actions: one step at tight bars, twenty chained steps at the JAX
kernels' bars, at the reduced capacity of tests/test_pallas_kernels.py
and at full capacity."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import HideAndSeekEnv
from marl_hideandseek_tpu.env import packed as jp
from marl_hideandseek_torch import bridge
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import packed as tp
from marl_hideandseek_torch.ops import step as ops_step

REDUCED = dict(num_worlds=128, min_hiders=1, max_hiders=1, min_seekers=1,
               max_seekers=1, max_boxes=3, max_ramps=1)
FULL = dict(num_worlds=8, min_hiders=2, max_hiders=2, min_seekers=2,
            max_seekers=2)
FLAGS = ("ZeroAgentVelocity", "RandomFlipTeams")

# Tight bars for one step on the same input: float32 op-order noise
# between XLA and PyTorch (positions within 1e-4; velocities are position
# differences over h = 1/120 s, angular velocities 2/h times quaternion
# differences).
TIGHT = dict(pos=1e-4, quat=1e-4, vel=1.2e-2, omega=2.4e-2)
# The JAX kernels' bars against their own oracles
# (tests/test_pallas_kernels.py:59-110): value bar, fraction within it.
KERNEL = dict(pos=(5e-3, 0.995), quat=(5e-3, 0.995), vel=(0.5, 0.995),
              omega=(0.5, 0.995))


def to_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def cfgs(kw):
    jflags = JFlags(0)
    tflags = SimFlags(0)
    for f in FLAGS:
        jflags |= JFlags[f]
        tflags |= SimFlags[f]
    return JCfg(**kw, sim_flags=jflags), EnvConfig(**kw, sim_flags=tflags)


def jax_megastep_fn(jcfg):
    """The JAX fallback branch of PackedEnv.step, before resets."""
    jenv = jp.PackedEnv(jcfg, force_fallback=True)

    def fn(ps, actions):
        ext_f, ext_t = jp._movement_packed(jcfg, ps, actions)
        ps = jp._action_system_packed(jcfg, ps, actions, ps.act_hit_t,
                                      ps.act_hit_id)
        ps, sweep = jenv._physics_and_sweep(ps, ext_f, ext_t)
        if jcfg.zero_agent_velocity:
            ps = jp._zero_agent_velocities_packed(jcfg, ps)
        team_r = jnp.where(sweep.rew_seen, -1.0, 1.0)
        ps = ps.replace(hider_team_reward=team_r)
        rewards, dones = jp._rewards_dones_packed(jcfg, ps, team_r)
        ps = jp._episode_results_packed(jcfg, ps, team_r)
        return ps, sweep, rewards, dones, team_r

    return jax.jit(fn)


def actions_for(cfg, seed):
    rng = np.random.default_rng(seed)
    w, a = cfg.num_worlds, cfg.max_agents
    move = rng.integers(0, 5, (a, 3, w))
    gl = rng.integers(0, 2, (a, 2, w))
    return np.concatenate([move, gl], axis=1).astype(np.int32)


def start_state(setup, step):
    ps = setup[4]
    return ps.replace(step=jnp.full_like(ps.step, step))


def compare(jout, tout, bars, frac=False):
    """Bodies within bars (all elements, or the kernel fraction), and the
    discrete outputs, sweep and scores equal."""
    jps, jsw, jrew, jdone, jteam = jout
    tps, tsw, trew, tdone, tteam = tout
    jn = to_np(jps)
    tn = bridge.state_to_numpy(tps)
    for name in ("pos", "quat", "vel", "omega"):
        a, b = tn["bodies"][name], jn["bodies"][name]
        if frac:
            tol, need = bars[name]
            close = (np.abs(a - b) < tol).mean()
            assert close >= need, (name, close, np.abs(a - b).max())
        else:
            np.testing.assert_allclose(a, b, atol=bars[name], rtol=1e-4,
                                       err_msg=name)
    if frac:
        return
    for name in ("locked", "owner"):
        np.testing.assert_array_equal(tn["bodies"][name], jn["bodies"][name])
    np.testing.assert_array_equal(tn["grab"]["target"], jn["grab"]["target"])
    for name in ("r2", "rel_q", "sep"):
        np.testing.assert_allclose(tn["grab"][name], jn["grab"][name],
                                   atol=1e-5)
    np.testing.assert_array_equal(tsw.vis_seen.numpy(),
                                  np.asarray(jsw.vis_seen))
    np.testing.assert_allclose(tsw.lidar.numpy(), np.asarray(jsw.lidar),
                               atol=1e-3)
    np.testing.assert_array_equal(tsw.act_id.numpy(), np.asarray(jsw.act_id))
    np.testing.assert_array_equal(tsw.rew_seen.numpy(),
                                  np.asarray(jsw.rew_seen))
    np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tteam.numpy(), np.asarray(jteam))
    np.testing.assert_array_equal(tn["running_scores"], jn["running_scores"])
    np.testing.assert_array_equal(tn["finished_scores"],
                                  jn["finished_scores"])


def advance_jax(out):
    ps, sw = out[0], out[1]
    return ps.replace(step=ps.step + 1, act_hit_t=sw.act_t,
                      act_hit_id=sw.act_id)


def advance_torch(out):
    ps, sw = out[0], out[1]
    return ps.replace(step=ps.step + 1, act_hit_t=sw.act_t,
                      act_hit_id=sw.act_id)


@pytest.fixture(scope="module", params=["reduced", "full"])
def setup(request):
    kw = REDUCED if request.param == "reduced" else FULL
    jcfg, tcfg = cfgs(kw)
    s, _ = jax.jit(HideAndSeekEnv(jcfg).init)(jax.random.PRNGKey(5))
    return (request.param, jcfg, tcfg, jax_megastep_fn(jcfg),
            jp.pack_state(s))


@pytest.mark.parametrize("step0", [100, 0, 239])
def test_megastep_one_step(setup, step0):
    """One step from the same packed state and actions. step0 = 100 is
    mid-episode (seekers free, rewards live); 0 clears the scores; 239 is
    the episode end (dones and final scores)."""
    _, _, tcfg, jstep, _ = setup
    ps = start_state(setup, step0)
    acts = actions_for(tcfg, step0)
    jout = jstep(ps, jnp.asarray(acts))
    tps = bridge.state_from_numpy(to_np(ps))
    tout = ops_step.megastep_packed(tcfg, tps, torch.from_numpy(acts))
    compare(jout, tout, TIGHT)


def test_megastep_twenty_steps(setup):
    """Twenty chained steps, each side from its own previous state, across
    the end of the prep phase (step 95): bodies at the JAX kernels' bars
    every step, and the whole run's rewards agree on >= 99.9 %."""
    _, _, tcfg, jstep, _ = setup
    ps = start_state(setup, 85)
    tps = bridge.state_from_numpy(to_np(ps))
    agree = []
    for i in range(20):
        acts = actions_for(tcfg, 1000 + i)
        jout = jstep(ps, jnp.asarray(acts))
        tout = ops_step.megastep_packed(tcfg, tps, torch.from_numpy(acts))
        compare(jout, tout, KERNEL, frac=True)
        agree.append((tout[2].numpy() == np.asarray(jout[2])).mean())
        ps, tps = advance_jax(jout), advance_torch(tout)
    assert np.mean(agree) >= 0.999, agree


def test_step_systems_match_jax(setup):
    """The packed step systems one by one (packed.py:108-300)."""
    _, jcfg, tcfg, _, _ = setup
    ps = start_state(setup, 100)
    tps = bridge.state_from_numpy(to_np(ps))
    acts = actions_for(tcfg, 7)
    ja, ta = jnp.asarray(acts), torch.from_numpy(acts)
    for jf, tf in ((jp._movement_packed(jcfg, ps, ja),
                    tp.movement_packed(tcfg, tps, ta)),):
        for a, b in zip(jf, tf):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    # Interaction hits that reach real objects, so grab/lock fire.
    rng = np.random.default_rng(3)
    n_a, w = tcfg.max_agents, tcfg.num_worlds
    hit_id = rng.integers(-1, tcfg.max_boxes + tcfg.max_ramps,
                          (n_a, w)).astype(np.int32)
    hit_t = rng.uniform(0.5, 2.5, (n_a, w)).astype(np.float32)
    hit_t[hit_id < 0] = np.inf
    jps = jp._action_system_packed(jcfg, ps, ja, jnp.asarray(hit_t),
                                   jnp.asarray(hit_id))
    tps2 = tp.action_system_packed(tcfg, tps, ta, torch.from_numpy(hit_t),
                                   torch.from_numpy(hit_id))
    jn, tn = to_np(jps), bridge.state_to_numpy(tps2)
    assert (jn["grab"]["target"] >= 0).any() and jn["bodies"]["locked"].any()
    np.testing.assert_array_equal(tn["bodies"]["locked"],
                                  jn["bodies"]["locked"])
    np.testing.assert_array_equal(tn["bodies"]["owner"], jn["bodies"]["owner"])
    for k in ("target", "r2", "rel_q", "sep"):
        np.testing.assert_allclose(tn["grab"][k], jn["grab"][k], atol=1e-5)
    np.testing.assert_allclose(
        bridge.state_to_numpy(tp.zero_agent_velocities_packed(
            tcfg, tps))["bodies"]["vel"],
        np.asarray(jp._zero_agent_velocities_packed(jcfg, ps).bodies.vel))
    team = np.where(np.arange(w) % 3 == 0, -1.0, 1.0).astype(np.float32)
    for s in (0, 94, 95, 96, 239):
        ps_s = ps.replace(step=jnp.full_like(ps.step, s))
        tps_s = tps.replace(step=torch.full_like(tps.step, s))
        jr = jp._rewards_dones_packed(jcfg, ps_s, jnp.asarray(team))
        tr = tp.rewards_dones_packed(tcfg, tps_s, torch.from_numpy(team))
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        je = to_np(jp._episode_results_packed(jcfg, ps_s, jnp.asarray(team)))
        te = bridge.state_to_numpy(tp.episode_results_packed(
            tcfg, tps_s, torch.from_numpy(team)))
        np.testing.assert_array_equal(te["running_scores"],
                                      je["running_scores"])
        np.testing.assert_array_equal(te["finished_scores"],
                                      je["finished_scores"])

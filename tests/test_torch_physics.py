"""PyTorch port: the XPBD physics step (env/physics.py) held to the JAX
jnp physics (marl_hideandseek_tpu/env/physics.py) on the same state,
forces, locks and grab joints."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import HideAndSeekEnv
from marl_hideandseek_tpu.env import physics as jphys
from marl_hideandseek_torch import bridge
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import physics as tphys

W = 128
# Reduced capacity of tests/test_pallas_kernels.py:20-26.
KW = dict(num_worlds=W, min_hiders=1, max_hiders=1, min_seekers=1,
          max_seekers=1, max_boxes=3, max_ramps=1)
JCFG = JCfg(**KW, sim_flags=JFlags.ZeroAgentVelocity)
TCFG = EnvConfig(**KW, sim_flags=SimFlags.ZeroAgentVelocity)
NB = JCFG.num_dyn_bodies
NA = JCFG.max_agents

# Float32 op-order noise between XLA and PyTorch stays well inside 1e-4 in
# positions and quaternions; velocities are position differences over
# h = 1/120 s and angular velocities 2/h times quaternion differences, so
# their bars are 120x and 240x the position bar.
POS_TOL = 1e-4
VEL_TOL = POS_TOL * 120
ANG_TOL = POS_TOL * 240


def to_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def _perturbed_state():
    """An init state with some boxes locked, some grab joints live and
    random velocities, so every solver path has work."""
    s, _ = jax.jit(HideAndSeekEnv(JCFG).init)(jax.random.PRNGKey(5))
    rng = np.random.default_rng(0)
    b = s.bodies
    locked = np.asarray(b.locked).copy()
    locked[::5, 1] = True
    vel = (rng.standard_normal((W, NB, 3)) * 2.0).astype(np.float32)
    omega = (rng.standard_normal((W, NB, 3)) * 0.5).astype(np.float32)
    # Drop everything a little so contacts engage and bodies overlap.
    pos = np.asarray(b.pos).copy()
    pos[..., 2] -= 0.05
    target = np.full((W, NA), -1, np.int32)
    target[::2, 0] = 0
    target[1::3, 1] = 2
    r2 = (rng.standard_normal((W, NA, 3)) * 0.3).astype(np.float32)
    rel_q = rng.standard_normal((W, NA, 4)).astype(np.float32)
    rel_q /= np.linalg.norm(rel_q, axis=-1, keepdims=True)
    sep = rng.uniform(0, 1, (W, NA)).astype(np.float32)
    return s.replace(
        bodies=b.replace(locked=jnp.asarray(locked), vel=jnp.asarray(vel),
                         omega=jnp.asarray(omega), pos=jnp.asarray(pos)),
        grab=s.grab.replace(target=jnp.asarray(target), r2=jnp.asarray(r2),
                            rel_q=jnp.asarray(rel_q), sep=jnp.asarray(sep)))


@pytest.fixture(scope="module")
def state():
    return _perturbed_state()


def _torch_trees(s):
    ts = bridge.state_from_numpy(to_np(s))
    return ts.bodies, ts.statics, ts.grab


def _forces(seed):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((W, NB, 3)) * 50).astype(np.float32)
    t = (rng.standard_normal((W, NB, 3)) * 10).astype(np.float32)
    return f, t


def test_manifold_matches_jax(state):
    """Per-vertex contact kinds, neighbour slots and friction equal; the
    geometry meta within 1e-6."""
    b, s = state.bodies, state.statics
    dyn = b.active & ~b.locked
    pos_pred = b.pos + JCFG.dt * b.vel * dyn[..., None]
    verts = jax.vmap(lambda h: jphys.body_vertices_local(JCFG, h))(b.half_ext)
    jm = jax.jit(jax.vmap(lambda bb, ss, pp, qq, vv: jphys.build_manifold(
        JCFG, bb, ss, pp, qq, vv)))(b, s, pos_pred, b.quat, verts)
    tb, tsg, _ = _torch_trees(state)
    tdyn = tb.active & ~tb.locked
    tpp = tb.pos + TCFG.dt * tb.vel * tdyn[..., None]
    tv = tphys.body_vertices_local(TCFG, tb.half_ext)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(verts))
    tm = tphys.build_manifold(TCFG, tb, tsg, tpp, tb.quat, tv)
    kind = np.asarray(jm.kind)
    assert (kind > 0).mean() > 0.05
    np.testing.assert_array_equal(tm.kind.numpy(), kind)
    np.testing.assert_array_equal(tm.nb_idx.numpy(), np.asarray(jm.nb_idx))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    live = kind > 0
    for name in ("flat_n", "flat_pt", "wall_half", "nb_half"):
        np.testing.assert_allclose(getattr(tm, name).numpy()[live],
                                   np.asarray(getattr(jm, name))[live],
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tm.mu.numpy()[live],
                               np.asarray(jm.mu)[live], atol=1e-6)


@pytest.mark.parametrize("forces", ["zero", "random"])
def test_physics_step_matches_jax(state, forces):
    """Without forces every element is within the tight bars. With random
    forces on this violent state a near-tie contact choice can flip for a
    body, so there the tight bars hold on >= 99.5 % of elements (the JAX
    kernels' fraction) and every element is within the JAX kernels' bars
    (pos/quat 5e-3, vel/omega 0.5)."""
    if forces == "zero":
        f = t = np.zeros((W, NB, 3), np.float32)
    else:
        f, t = _forces(1)
    jb = jax.jit(jax.vmap(lambda bb, ss, gg, ff, tt: jphys.physics_step(
        JCFG, bb, ss, gg, ff, tt)))(state.bodies, state.statics, state.grab,
                                    jnp.asarray(f), jnp.asarray(t))
    tb, tsg, tg = _torch_trees(state)
    pos, quat, vel, omega = tphys.physics_step(
        TCFG, tb, tsg, tg, torch.from_numpy(f), torch.from_numpy(t))
    for name, got, tol, bar in (("pos", pos, POS_TOL, 5e-3),
                                ("quat", quat, POS_TOL, 5e-3),
                                ("vel", vel, VEL_TOL, 0.5),
                                ("omega", omega, ANG_TOL, 0.5)):
        want = np.asarray(getattr(jb, name))
        got = got.numpy()
        if forces == "zero":
            np.testing.assert_allclose(got, want, atol=tol, rtol=1e-4,
                                       err_msg=name)
        else:
            close = np.abs(got - want) <= tol + 1e-4 * np.abs(want)
            assert close.mean() >= 0.995, (name, close.mean())
            np.testing.assert_allclose(got, want, atol=bar, err_msg=name)


def test_grab_joints_match_jax(state):
    """The fixed-joint corrections alone, on live joints."""
    b, g = state.bodies, state.grab
    dyn = b.active & ~b.locked
    inv_m = jnp.where(dyn, b.inv_mass, 0.0)
    inv_i = jnp.where(dyn[..., None], b.inv_inertia, 0.0)
    jd = jax.vmap(lambda p, q, m, i, gg: jphys.solve_grab_joints(
        JCFG, p, q, m, i, gg))(b.pos, b.quat, inv_m, inv_i, g)
    tb, _, tg = _torch_trees(state)
    tdyn = tb.active & ~tb.locked
    td = tphys.solve_grab_joints(
        TCFG, tb.pos, tb.quat, torch.where(tdyn, tb.inv_mass, 0.0),
        torch.where(tdyn[..., None], tb.inv_inertia, 0.0),
        tg.target, tg.r2, tg.rel_q, tg.sep)
    assert np.abs(np.asarray(jd[0])).max() > 1e-3
    for a, bb in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), atol=1e-5,
                                   rtol=1e-5)


def test_physics_settles_finite(state):
    """Chained plain steps stay finite and nothing falls through the
    floor (the JAX kernel test's invariant)."""
    tb, tsg, tg = _torch_trees(state)
    zeros = torch.zeros((W, NB, 3))
    for _ in range(3):
        pos, quat, vel, omega = tphys.physics_step(TCFG, tb, tsg, tg,
                                                   zeros, zeros)
        tb = tb.replace(pos=pos, quat=quat, vel=vel, omega=omega)
    assert bool(torch.isfinite(tb.pos).all())
    assert bool(torch.isfinite(tb.quat).all())
    assert bool((tb.pos[..., 2][tb.active] > -1.0).all())

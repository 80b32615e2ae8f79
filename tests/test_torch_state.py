"""PyTorch port: config, state types, the numpy bridge and the 3-D math
held to the JAX package on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu import math3d as jm
from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import HideAndSeekEnv
from marl_hideandseek_tpu.env import packed as jpacked
from marl_hideandseek_tpu.ops import pallas_physics as jpp
from marl_hideandseek_tpu import types as jtypes
from marl_hideandseek_torch import bridge
from marl_hideandseek_torch import math3d as tm
from marl_hideandseek_torch import config as tconfig
from marl_hideandseek_torch import types as ttypes

W = 8
KW = dict(num_worlds=W, min_hiders=2, max_hiders=2, min_seekers=2,
          max_seekers=2)


def to_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


@pytest.fixture(scope="module")
def jax_state():
    cfg = JCfg(**KW, sim_flags=JFlags.ZeroAgentVelocity)
    state, _ = jax.jit(HideAndSeekEnv(cfg).init)(jax.random.PRNGKey(5))
    return state


def test_config_mirrors_jax():
    for name in ("MAX_BOXES", "MAX_RAMPS", "MAX_AGENTS", "MAX_WALLS", "DT",
                 "NUM_PHYSICS_SUBSTEPS", "NUM_PREP_STEPS", "EPISODE_LEN",
                 "ARENA_HALF", "NUM_LIDAR_SAMPLES", "LIDAR_MAX_RANGE",
                 "VIS_FOV_DEGREES", "INTERACT_RAY_LEN", "OOB_LIMIT",
                 "OOB_PENALTY"):
        from marl_hideandseek_tpu import config as jconfig
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    for flag in JFlags:
        assert int(tconfig.SimFlags[flag.name]) == int(flag)
    jc = JCfg(**KW, sim_flags=JFlags.RandomFlipTeams, max_boxes=3)
    tc = tconfig.EnvConfig(**KW, sim_flags=tconfig.SimFlags.RandomFlipTeams,
                           max_boxes=3)
    for prop in ("max_agents", "num_dyn_bodies", "use_fixed_world",
                 "ignore_episode_length", "random_flip_teams",
                 "zero_agent_velocity"):
        assert getattr(jc, prop) == getattr(tc, prop), prop
    assert jtypes.body_slot_ranges(jc) == ttypes.body_slot_ranges(tc)
    with pytest.raises(ValueError):
        tconfig.EnvConfig(max_hiders=4, max_seekers=3)
    with pytest.raises(ValueError):
        tconfig.EnvConfig(reset_budget=200)


def test_types_field_order_matches_jax():
    for jt, tt in ((jtypes.RigidBodies, ttypes.RigidBodies),
                   (jtypes.StaticGeom, ttypes.StaticGeom),
                   (jtypes.GrabState, ttypes.GrabState),
                   (jtypes.EnvState, ttypes.EnvState)):
        assert [f.name for f in dataclasses.fields(jt)] == \
            [f.name for f in dataclasses.fields(tt)]
    for name in ("OWNER_NONE", "OWNER_SEEKER", "OWNER_HIDER",
                 "OWNER_UNOWNABLE", "AGENT_SEEKER", "AGENT_HIDER",
                 "INV_MASS_BOX", "INV_MASS_RAMP", "INV_MASS_AGENT",
                 "MU_D_CUBE", "MU_D_ELONGATED", "MU_D_RAMP", "MU_D_AGENT"):
        assert getattr(jtypes, name) == getattr(ttypes, name), name


def test_bridge_roundtrip_and_pack(jax_state):
    """JAX state -> numpy -> torch -> numpy is lossless (u32 keys kept),
    and pack/unpack move the world axis like env/packed.py's."""
    tree = to_np(jax_state)
    ts = bridge.state_from_numpy(tree)
    assert ts.ep_key.dtype == torch.uint32
    assert ts.episode_counter.dtype == torch.uint32
    back = bridge.state_to_numpy(ts)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    jp = to_np(jpacked.pack_state(jax_state))
    tp = bridge.state_to_numpy(ttypes.pack_state(ts))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(a, b)
    leaves = ttypes.unpack_state(ttypes.pack_state(ts)).leaves()
    for a, b in zip(ts.leaves(), leaves):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b)
    acts = np.arange(W * 4 * 5, dtype=np.int32).reshape(W, 4, 5)
    np.testing.assert_array_equal(
        np.asarray(jpacked.pack_actions(jnp.asarray(acts))),
        ttypes.pack_actions(torch.from_numpy(acts)).numpy())


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _unit_q(shape, seed):
    q = _rand(shape + (4,), seed)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn", ["quat_mul", "quat_rotate", "quat_rotate_inv",
                                "quat_integrate", "quat_to_euler",
                                "quat_to_mat", "quat_normalize"])
def test_math3d_matches_jax(fn):
    """Last-axis quaternion math, same float32 inputs: within 2e-6."""
    q = _unit_q((64,), 0)
    q2 = _unit_q((64,), 1)
    v = _rand((64, 3), 2)
    args = {
        "quat_mul": (q, q2), "quat_rotate": (q, v),
        "quat_rotate_inv": (q, v), "quat_integrate": (q, v, 1.0 / 120.0),
        "quat_to_euler": (q,), "quat_to_mat": (q,),
        "quat_normalize": (q * 3.0,),
    }[fn]
    j = np.asarray(getattr(jm, fn)(*[jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args]))
    t = getattr(tm, fn)(*[torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in args]).numpy()
    np.testing.assert_allclose(t, j, atol=2e-6, rtol=2e-6)


def test_aabb_helpers_match_jax():
    pos = _rand((32, 3), 3) * 10
    q = _unit_q((32,), 4)
    half = np.abs(_rand((32, 3), 5)) + 0.5
    jl, jh = jm.obb_world_aabb(jnp.asarray(pos), jnp.asarray(q),
                               jnp.asarray(half))
    tl, th = tm.obb_world_aabb(torch.from_numpy(pos), torch.from_numpy(q),
                               torch.from_numpy(half))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    ov_j = jm.aabb_overlap(jl[:, None], jh[:, None], jl[None], jh[None])
    ov_t = tm.aabb_overlap(tl[:, None], th[:, None], tl[None], th[None])
    np.testing.assert_array_equal(ov_t.numpy(), np.asarray(ov_j))


def test_component_helpers_match_packed_jax():
    """qrot / qmul / qnorm / euler / rel_posvel in component form against
    env/packed.py's (_qrot ... _rel_posvel_packed), op order included:
    equal to 1e-6."""
    qa = tuple(_unit_q((4, 1, 16), 6).transpose(3, 0, 1, 2))
    qe = tuple(_unit_q((1, 9, 16), 7).transpose(3, 0, 1, 2))
    va = [tuple(_rand((3, 4, 1, 16), s)) for s in (8, 9, 10)]
    ve = [tuple(_rand((3, 1, 9, 16), s)) for s in (11, 12, 13)]
    J = lambda t: tuple(jnp.asarray(x) for x in t)
    T = lambda t: tuple(torch.from_numpy(np.ascontiguousarray(x))
                        for x in t)
    for inv in (False, True):
        j = jpp._qrot(J(qa), J(va[0]), inv=inv)
        t = tm.qrot(T(qa), T(va[0]), inv=inv)
        for a, b in zip(j, t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    for a, b in zip(jpp._qnorm(jpp._qmul(J(qa), J(qe))),
                    tm.qnorm(tm.qmul(T(qa), T(qe)))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    for a, b in zip(jpacked._euler_packed(J(qe)), tm.euler(T(qe))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    j = jpacked._rel_posvel_packed(J(va[0]), jpp._qconj(J(qa)), J(va[1]),
                                   J(va[2]), J(ve[0]), J(qe), J(ve[1]),
                                   J(ve[2]))
    t = tm.rel_posvel(T(va[0]), tm.qconj(T(qa)), T(va[1]), T(va[2]),
                      T(ve[0]), T(qe), T(ve[1]), T(ve[2]))
    assert len(j) == len(t) == 12
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)

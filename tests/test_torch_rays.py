"""PyTorch port: the raycast (env/rays.py, and the plain version of the
K1 kernel in ops/rays.py) held to the JAX jnp raycast on the same
inputs."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import HideAndSeekEnv, observations as jobs
from marl_hideandseek_tpu.env import rays as jrays
from marl_hideandseek_tpu.env.packed import pack_state
from marl_hideandseek_tpu.ops import pallas_rays
from marl_hideandseek_torch import bridge
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import observations as tobs
from marl_hideandseek_torch.env import rays as trays
from marl_hideandseek_torch.ops import rays as ops_rays

W = 128
# Reduced capacity of tests/test_pallas_kernels.py:20-26.
KW = dict(num_worlds=W, min_hiders=1, max_hiders=1, min_seekers=1,
          max_seekers=1, max_boxes=3, max_ramps=1)
JCFG = JCfg(**KW, sim_flags=JFlags.ZeroAgentVelocity)
TCFG = EnvConfig(**KW, sim_flags=SimFlags.ZeroAgentVelocity)


def to_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


@pytest.fixture(scope="module")
def states():
    s, _ = jax.jit(HideAndSeekEnv(JCFG).init)(jax.random.PRNGKey(5))
    ps = pack_state(s)
    return s, ps, bridge.state_from_numpy(to_np(ps))


def _rng_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    # Axis-parallel and near-parallel directions exercise the EPS paths.
    d[::7, 0] = 0.0
    d[::11, 1] = 1e-9
    return o, d


def test_primitives_match_jax():
    """ray_aabb / ray_obb / ray_wedge / ray_plane on random rays, with
    origins inside and outside: equal hit/miss, t within 1e-5."""
    o, d = _rng_rays(512, 0)
    q = np.random.default_rng(1).standard_normal((512, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    c = np.random.default_rng(2).uniform(-1, 1, (512, 3)).astype(np.float32)
    h = np.abs(np.random.default_rng(3).uniform(0.3, 2, (512, 3))).astype(
        np.float32)
    n = np.zeros((512, 3), np.float32)
    n[:, 2] = 1.0
    J = jnp.asarray
    T = torch.from_numpy
    pairs = [
        (jrays.ray_aabb(J(o), J(d), J(c - h), J(c + h)),
         trays.ray_aabb(T(o), T(d), T(c - h), T(c + h))),
        (jrays.ray_obb(J(o), J(d), J(c), J(q), J(h)),
         trays.ray_obb(T(o), T(d), T(c), T(q), T(h))),
        (jrays.ray_wedge(J(o), J(d), J(c), J(q)),
         trays.ray_wedge(T(o), T(d), T(c), T(q))),
        (jrays.ray_plane(J(o), J(d), J(c), J(n)),
         trays.ray_plane(T(o), T(d), T(c), T(n))),
    ]
    for j, t in pairs:
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_array_equal(np.isinf(j), np.isinf(t))
        fin = np.isfinite(j)
        assert fin.any() and (~fin).any()
        np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5, atol=1e-5)


def _jax_queries(state, which):
    f = jobs.obs_ray_queries if which == "obs" else jobs.action_ray_queries
    return jax.vmap(functools.partial(f, JCFG))(state)


@pytest.mark.parametrize("which", ["obs", "act"])
def test_ray_queries_match_jax(states, which):
    """The sweep's ray queries (origins, dirs, max_t, excluded id)."""
    s, _, ts = states
    jq = _jax_queries(s, which)
    st = tobs.world_first(ts)
    f = tobs.obs_ray_queries if which == "obs" else tobs.action_ray_queries
    tq = f(TCFG, st)
    for a, b in zip(jq, tq):
        a = np.asarray(a)
        b = torch.movedim(b, -1, 0).numpy() if b.dim() > a.ndim else \
            b.numpy()
        np.testing.assert_allclose(b.astype(np.float32),
                                   a.astype(np.float32), atol=1e-6)


@pytest.mark.parametrize("which", ["obs", "act"])
def test_raycast_plain_matches_jax(states, which):
    """K1's plain version against raycast_batch_packed(use_pallas=False)
    on an init state's sweep queries, packed layout: ids equal on
    >= 99.9 % of rays (the JAX kernels' bar), t within 1e-5 on equal
    hits."""
    _, ps, ts = states
    jq = jax.vmap(functools.partial(
        jobs.obs_ray_queries if which == "obs" else jobs.action_ray_queries,
        JCFG), in_axes=-1, out_axes=-1)(ps)
    jt, jid = pallas_rays.raycast_batch_packed(JCFG, ps, *jq,
                                               use_pallas=False)
    tq = [torch.from_numpy(np.array(x))
          for x in jq]
    tq[3] = tq[3].to(torch.int32)
    tt, tid = ops_rays.raycast_batch_packed(TCFG, ts, *tq)
    jid, jt = np.asarray(jid), np.asarray(jt)
    match = (tid.numpy() == jid)
    assert match.mean() >= 0.999, match.mean()
    hit = match & (jid >= 0)
    assert hit.any()
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.isinf(tt.numpy()), np.isinf(jt))


def test_raycast_excludes_and_ranges(states):
    """The excluded id is never hit, and nothing beyond max_t is hit."""
    _, _, ts = states
    st = tobs.world_first(ts)
    o, d, m, e = tobs.obs_ray_queries(TCFG, st)
    pk = lambda x: torch.movedim(x, 0, -1).contiguous()
    o, d, m, e = map(pk, (o, d, m, e))
    t, hid = ops_rays.raycast_batch_packed(TCFG, ts, o, d, m, e)
    assert not bool((hid == e).any())
    hit = hid >= 0
    assert bool((t[hit] <= m[hit]).all())
    assert bool(torch.isinf(t[~hit]).all())
    # Shrinking max_t below every hit turns them all into misses.
    t2, hid2 = ops_rays.raycast_batch_packed(TCFG, ts, o, d, m * 0 + 1e-6,
                                             e)
    assert bool((hid2 == -1).all()) and bool(torch.isinf(t2).all())


def test_wrapper_refuses_cuda_tensors_without_kernel_inputs(states):
    """The kernel path checks its inputs before any launch: a CUDA-less
    host never reaches it, and CPU tensors always take the plain path."""
    _, _, ts = states
    assert ops_rays.RAYCAST.launches == 0
    st = tobs.world_first(ts)
    q = [torch.movedim(x, 0, -1).contiguous()
         for x in tobs.action_ray_queries(TCFG, st)]
    ops_rays.raycast_batch_packed(TCFG, ts, *q)
    assert ops_rays.RAYCAST.launches == 0

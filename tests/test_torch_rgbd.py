"""PyTorch port: the plain RGBD renderer (viz/rgbd.py, the plain side of
the K5 kernel) held to the JAX package's viz/rgbd.render_rgbd on the same
scenes - tests/test_rgbd.py's scene with every primitive class and a
generated level-1 world - at 16x16 and 32x32, at the JAX kernel's bar
(tests/test_rgbd.py:116-160): depth within 1e-3, colours equal on
>= 99.5 % of pixels, sky pixels exactly equal. The packed outputs' layout
helpers (unpack_rgba, to_reference_layout) are held to the JAX ones
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu import math3d as jmath3d
from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.env import HideAndSeekEnv as JEnv
from marl_hideandseek_tpu.env import levelgen as jlg
from marl_hideandseek_tpu.ops import pallas_rgbd as jpr
from marl_hideandseek_tpu.types import AGENT_HIDER, AGENT_SEEKER
from marl_hideandseek_tpu.viz import rgbd as jrgbd
from marl_hideandseek_torch import bridge
from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.types import pack_state
from marl_hideandseek_torch.viz import rgbd as trgbd

KW = dict(num_worlds=1, min_hiders=1, max_hiders=3, min_seekers=1,
          max_seekers=3)
JCFG = JCfg(**KW)
TCFG = EnvConfig(**KW)


def to_np(x):
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return np.asarray(x)


def primitive_scene():
    """tests/test_rgbd.py:116-160: two boxes (one locked, one yawed), a
    ramp, a hider and a yawed seeker, on the floor plane; 3 worlds."""
    qi = jmath3d.quat_identity()
    yaw = jnp.asarray([0.924, 0.0, 0.0, 0.383])
    s = jlg.empty_world(JCFG)
    s = jlg._add_box_body(s, JCFG, 0, [0.0, 6.0, 1.0], qi, jlg.CUBE_HALF)
    s = jlg._add_agent(s, JCFG, 0, [0.0, 0.0, 1.0], qi, AGENT_HIDER)
    s = jlg._add_box_body(s, JCFG, 1, [3.0, 5.0, 1.0], yaw, jlg.CUBE_HALF)
    s = jlg._add_ramp_body(s, JCFG, 0, [-3.0, 6.0, 1.0], qi)
    s = jlg._add_agent(s, JCFG, 1, [-1.0, -2.0, 1.0], yaw, AGENT_SEEKER)
    s = s.replace(bodies=s.bodies.replace(
        locked=s.bodies.locked.at[0].set(True)))
    return jax.tree.map(lambda x: jnp.stack([x] * 3), s)


def level_one_worlds():
    """Two generated level-1 worlds (walls, 3-9 boxes, 2 ramps, 4
    agents) at full capacity."""
    kw = dict(num_worlds=2, min_hiders=2, max_hiders=2, min_seekers=2,
              max_seekers=2)
    state, _ = jax.jit(JEnv(JCfg(**kw)).init)(jax.random.PRNGKey(3))
    return JCfg(**kw), EnvConfig(**kw), state


def assert_rgbd_close(rgb_t, d_t, rgb_j, d_j):
    rgb_t, d_t = rgb_t.numpy(), d_t.numpy()
    rgb_j, d_j = np.asarray(rgb_j), np.asarray(d_j)
    assert rgb_t.shape == rgb_j.shape and rgb_t.dtype == rgb_j.dtype
    assert d_t.shape == d_j.shape and d_t.dtype == d_j.dtype
    np.testing.assert_allclose(d_t, d_j, atol=1e-3, rtol=1e-4)
    same = (rgb_t == rgb_j).all(axis=-1)
    assert same.mean() >= 0.995, f"only {same.mean():.4f} of pixels match"
    sky = d_j[..., 0] == 0.0
    assert (same | ~sky).all()
    assert (rgb_t[..., 3] == 255).all()


@pytest.mark.parametrize("hw", [16, 32])
def test_plain_renderer_matches_jax_on_every_primitive(hw):
    js = primitive_scene()
    ts = bridge.state_from_numpy(to_np(js))
    rgb_j, d_j = jrgbd.render_rgbd(JCFG, js, hw, hw)
    rgb_t, d_t = trgbd.render_rgbd(TCFG, ts, hw, hw)
    assert_rgbd_close(rgb_t, d_t, rgb_j, d_j)
    # The scene shows every class: sky, floor, boxes, the ramp, agents.
    assert (d_t == 0).any() and (d_t > 0).float().mean() > 0.3


@pytest.mark.parametrize("hw", [16, 32])
def test_plain_renderer_matches_jax_on_level_one(hw):
    jcfg, tcfg, js = level_one_worlds()
    ts = bridge.state_from_numpy(to_np(js))
    rgb_j, d_j = jrgbd.render_rgbd(jcfg, js, hw, hw)
    rgb_t, d_t = trgbd.render_rgbd(tcfg, ts, hw, hw, world_chunk=1)
    assert_rgbd_close(rgb_t, d_t, rgb_j, d_j)


def test_packed_fast_cpu_path_and_layout_helpers_match_jax():
    """render_rgbd_packed_fast on CPU tensors packs the plain renderer's
    output as the kernel lays it out; unpack_rgba and to_reference_layout
    agree with the JAX helpers exactly, and round-trip the render."""
    js = primitive_scene()
    ts = bridge.state_from_numpy(to_np(js))
    packed, depth = ops_rgbd.render_rgbd_packed_fast(TCFG, pack_state(ts),
                                                     16, 16)
    assert packed.dtype == torch.uint32 and packed.shape == (6, 256, 3)
    assert depth.shape == (6, 256, 3)
    rgb_t, d_t = ops_rgbd.to_reference_layout(TCFG, packed, depth, 16, 16)
    rgb_p, d_p = trgbd.render_rgbd(TCFG, ts, 16, 16)
    assert torch.equal(rgb_t, rgb_p) and torch.equal(d_t, d_p)

    pj = jnp.asarray(packed.numpy())
    rgb_j, d_j = jpr.to_reference_layout(JCFG, pj, jnp.asarray(depth.numpy()),
                                         16, 16)
    np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(ops_rgbd.unpack_rgba(packed).numpy(),
                                  np.asarray(jpr.unpack_rgba(pj)))


def test_bridge_rgbd_round_trip():
    js = primitive_scene()
    rgb_j, d_j = jrgbd.render_rgbd(JCFG, js, 16, 16)
    rgb, depth = bridge.rgbd_from_numpy(np.asarray(rgb_j), np.asarray(d_j))
    assert rgb.dtype == torch.uint8 and depth.dtype == torch.float32
    back = bridge.rgbd_to_numpy(rgb, depth)
    np.testing.assert_array_equal(back[0], np.asarray(rgb_j))
    np.testing.assert_array_equal(back[1], np.asarray(d_j))
    with pytest.raises(ValueError, match="rgb"):
        bridge.rgbd_from_numpy(np.asarray(d_j), np.asarray(d_j))

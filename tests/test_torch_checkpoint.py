"""PyTorch port: sim-state checkpoints (env/checkpoint.py,
HideAndSeekEnv.save_checkpoints / load_checkpoints), mirroring
tests/test_checkpoint.py - the save/load round trip into a fresh env
state, replay determinism after a load, pack/unpack - on the port's own
worlds (levels regenerated from their keys), plus the JAX package's
checkpoints: the same byte records, and a JAX checkpoint loaded into the
port against the JAX load, its level regenerated by the port's own
generator (JAX's threefry keys) or by the JAX generator through the
bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import HideAndSeekEnv as JEnv
from marl_hideandseek_tpu.env import checkpoint as jckpt
from marl_hideandseek_torch import bridge, prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.checkpoint import (
    pack_checkpoints,
    unpack_checkpoints,
)
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from test_torch_env import assert_state_close, make_jax_levelgen, to_np

W = 2
KW = dict(num_worlds=W, min_hiders=2, max_hiders=2, min_seekers=2,
          max_seekers=2)
CFG = EnvConfig(**KW, sim_flags=SimFlags.ZeroAgentVelocity)
JCFG = JCfg(**KW, sim_flags=JFlags.ZeroAgentVelocity)


def random_actions(gen):
    return torch.cat([torch.randint(0, 5, (W, CFG.max_agents, 3),
                                    generator=gen),
                      torch.randint(0, 2, (W, CFG.max_agents, 2),
                                    generator=gen)], dim=-1)


def u32_safe(x):
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def assert_trees_equal(a, b):
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(u32_safe(x), u32_safe(y))


@pytest.fixture(scope="module")
def env():
    return HideAndSeekEnv(CFG, device="cpu")


@pytest.fixture(scope="module")
def mid_episode_state(env):
    state, _ = env.init()
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        state, _ = env.step(state, random_actions(gen))
    return state


def test_save_load_roundtrip(env, mid_episode_state):
    """Loading into a fresh state of another seed reproduces every world
    exactly, the level regenerated from its key."""
    state = mid_episode_state
    ckpt = env.save_checkpoints(state)
    fresh, _ = HideAndSeekEnv(CFG.replace(rand_seed=99), device="cpu").init()
    assert not torch.equal(fresh.statics.wall_pos, state.statics.wall_pos)
    loaded, res = env.load_checkpoints(fresh, ckpt,
                                       torch.ones(W, dtype=torch.int32))
    for name in ("bodies", "statics", "grab"):
        assert_trees_equal(getattr(loaded, name), getattr(state, name))
    for name in ("step", "running_scores", "finished_scores", "ep_key",
                 "level_key", "num_hiders", "num_seekers", "agent_type",
                 "num_active_boxes", "num_active_ramps", "seekers_first",
                 "act_hit_t", "act_hit_id"):
        assert torch.equal(u32_safe(getattr(loaded, name)),
                           u32_safe(getattr(state, name))), name
    # The episode counter keeps running (the reference does not restore it).
    assert torch.equal(u32_safe(loaded.episode_counter),
                       u32_safe(fresh.episode_counter))
    assert res.obs["self_data"].shape == (W, CFG.max_agents, 13)


def test_load_only_masked_worlds(env, mid_episode_state):
    ckpt = env.save_checkpoints(mid_episode_state)
    fresh, _ = HideAndSeekEnv(CFG.replace(rand_seed=99), device="cpu").init()
    loaded, _ = env.load_checkpoints(fresh, ckpt,
                                     torch.tensor([0, 1], dtype=torch.int32))
    assert torch.equal(loaded.statics.wall_pos[0], fresh.statics.wall_pos[0])
    assert torch.equal(loaded.bodies.pos[0], fresh.bodies.pos[0])
    assert torch.equal(loaded.statics.wall_pos[1],
                       mid_episode_state.statics.wall_pos[1])
    assert torch.equal(loaded.bodies.pos[1], mid_episode_state.bodies.pos[1])


def test_replay_determinism(env, mid_episode_state):
    """Stepping from a loaded checkpoint matches stepping the original."""
    state = mid_episode_state
    ckpt = env.save_checkpoints(state)
    fresh, _ = HideAndSeekEnv(CFG.replace(rand_seed=123),
                              device="cpu").init()
    loaded, _ = env.load_checkpoints(fresh, ckpt,
                                     torch.ones(W, dtype=torch.int32))
    gen = torch.Generator().manual_seed(42)
    s_a, s_b = state, loaded
    for _ in range(3):
        acts = random_actions(gen)
        s_a, r_a = env.step(s_a, acts)
        s_b, r_b = env.step(s_b, acts)
    torch.testing.assert_close(s_a.bodies.pos, s_b.bodies.pos, atol=1e-5,
                               rtol=0)
    for k in r_a.obs:
        torch.testing.assert_close(r_a.obs[k], r_b.obs[k], atol=1e-4,
                                   rtol=0, msg=k)


def test_pack_unpack(env, mid_episode_state):
    ckpt = env.save_checkpoints(mid_episode_state)
    packed = pack_checkpoints(ckpt)
    assert packed.dtype == torch.uint8 and packed.shape[0] == W
    assert_trees_equal(unpack_checkpoints(CFG, packed), ckpt)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX env 5 steps into an episode, its checkpoint, and a fresh JAX
    state of another key to load into."""
    jenv = JEnv(JCFG)
    state, _ = jax.jit(jenv.init)(jax.random.PRNGKey(5))
    step = jax.jit(jenv.step)
    key = jax.random.PRNGKey(1)
    for _ in range(5):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        acts = jnp.concatenate([
            jax.random.randint(k1, (W, JCFG.max_agents, 3), 0, 5),
            jax.random.randint(k2, (W, JCFG.max_agents, 2), 0, 2)], -1)
        state, _ = step(state, acts)
    fresh, _ = jax.jit(jenv.init)(jax.random.PRNGKey(99))
    return jenv, state, jax.jit(jenv.save_checkpoints)(state), fresh


def test_jax_checkpoint_bytes_and_bridge(jax_run):
    """A JAX checkpoint crosses the bridge exactly, and the port packs it
    into the JAX package's byte record and back."""
    _, _, jck, _ = jax_run
    ck = bridge.checkpoint_from_numpy(to_np(jck))
    np.testing.assert_array_equal(pack_checkpoints(ck).numpy(),
                                  np.asarray(jckpt.pack_checkpoints(jck)))
    back = bridge.checkpoint_to_numpy(
        unpack_checkpoints(CFG, pack_checkpoints(ck)))
    for k, v in to_np(jck).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _load_into_port(jax_run, levelgen):
    """The port loads a JAX checkpoint into a JAX-made fresh state as the
    JAX env does: the state, and the re-swept observations, at the
    one-step bars."""
    jenv, _, jck, jfresh = jax_run
    should = jnp.asarray([1, 1], jnp.int32)
    jloaded, jres = jax.jit(jenv.load_checkpoints)(jfresh, jck, should)
    env = HideAndSeekEnv(CFG, device="cpu", levelgen=levelgen)
    tloaded, tres = env.load_checkpoints(
        bridge.state_from_numpy(to_np(jfresh)),
        bridge.checkpoint_from_numpy(to_np(jck)),
        torch.ones(W, dtype=torch.int32))
    assert_state_close(tloaded, jloaded)
    for k, v in jres.obs.items():
        np.testing.assert_allclose(tres.obs[k].numpy(), np.asarray(v),
                                   atol=1e-3, err_msg=k)


def test_jax_checkpoint_loaded_into_port(jax_run):
    """The level regenerated by the JAX generator through the bridge."""
    _load_into_port(jax_run, make_jax_levelgen(JCFG))


def test_jax_checkpoint_loads_with_the_default_levelgen(jax_run):
    """No injected generator: the port's own level generator draws JAX's
    level from the checkpoint's keys."""
    _load_into_port(jax_run, None)


def test_port_init_equals_jax_init(jax_run):
    """The classic env's ``init(key)`` with its default generator equals
    JAX's from the same key (the fixture's fresh state, PRNGKey(99))."""
    _, _, _, jfresh = jax_run
    tfresh, _ = HideAndSeekEnv(CFG, device="cpu").init(prng.key(99))
    assert_state_close(tfresh, jfresh)

"""PyTorch port: tests/golden_trace.npz (tests/test_golden.py: 250 steps
of the classic env at W=2 - the prep phase, seek-phase rewards, grabs and
locks, the step-239 reset) replayed through the port's HideAndSeekEnv
with the JAX worlds (``worldgen``) and the JAX action stream.

Two replays from one run:

* step by step: every port step starts from the JAX env's state before
  that step, so each of the 250 steps is held to the trace at the file's
  own tolerance (atol 5e-4, rtol 1e-3);
* chained: the port on its own. One step of the port agrees with JAX to
  a few 1e-6 in position, but the trajectory is chaotic: in world 1 the
  agent in body slot 12 crosses a near-tie contact between steps 20 and
  23 (its position error grows from 1e-4 to 0.25), and the rest of that
  world follows (grab target from step 69, a lock from step 74, rewards
  from step 96, scores from step 150). So the chained replay is held to
  the trace at its tolerance over the first 20 steps, and over all 250 in
  the step counters, the episode counter and the regenerated level.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import HideAndSeekEnv as JEnv
from marl_hideandseek_torch import bridge
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from test_torch_env import make_jax_worldgen, to_np

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_trace.npz")
W = 2
N_STEPS = 250
CHAINED_STEPS = 20          # before the near-tie flip (module docstring)
KW = dict(num_worlds=W, min_hiders=2, max_hiders=2, min_seekers=2,
          max_seekers=2, rand_seed=5)
JCFG = JCfg(**KW, sim_flags=JFlags.ZeroAgentVelocity)
TCFG = EnvConfig(**KW, sim_flags=SimFlags.ZeroAgentVelocity)
TRAJ = ("pos", "rewards", "grab_target", "locked", "scores", "finished",
        "step")

pytestmark = pytest.mark.skipif(not os.path.exists(GOLDEN_PATH),
                                reason="golden trace not generated yet")


def golden_actions():
    """tests/test_golden.py's action stream [T, W, A, 5]."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(17))
    n_a = TCFG.max_agents
    moves = jax.random.randint(k1, (N_STEPS, W, n_a, 3), 0, 5)
    gl = jax.random.randint(k2, (N_STEPS, W, n_a, 2), 0, 2)
    return np.array(jnp.concatenate([moves, gl], axis=-1))


def record(tr, state, res):
    tr["pos"].append(state.bodies.pos.clone())
    tr["rewards"].append(res.rewards[..., 0])
    tr["grab_target"].append(state.grab.target)
    tr["locked"].append(state.bodies.locked)
    tr["scores"].append(state.running_scores)
    tr["finished"].append(state.finished_scores)
    tr["step"].append(state.step)


def trace(tr, state):
    """The golden file's keys (tests/test_golden.py::generate_trace)."""
    return {
        "init_wall_pos": state.statics.wall_pos.numpy(),
        "init_wall_active": state.statics.wall_active.numpy(),
        "traj_pos": torch.stack(tr["pos"][::10]).numpy(),
        **{f"traj_{k}": torch.stack(tr[k]).numpy() for k in TRAJ
           if k != "pos"},
        "num_boxes": state.num_active_boxes.numpy(),
        "agent_types": state.agent_type.numpy(),
        "episode_counter": state.episode_counter.numpy(),
    }


@pytest.fixture(scope="module")
def replays():
    """(step-by-step trace, chained trace) of one run."""
    jenv = JEnv(JCFG)
    jstep = jax.jit(jenv.step)
    env = HideAndSeekEnv(TCFG, device="cpu",
                         worldgen=make_jax_worldgen(JCFG))
    acts = golden_actions()
    jst, _ = jax.jit(jenv.init)(jax.random.PRNGKey(5))
    chained, _ = env.init()
    by_step = {k: [] for k in TRAJ}
    chain = {k: [] for k in TRAJ}
    for i in range(N_STEPS):
        a = torch.from_numpy(acts[i])
        one, one_res = env.step(bridge.state_from_numpy(to_np(jst)), a)
        record(by_step, one, one_res)
        chained, res = env.step(chained, a)
        record(chain, chained, res)
        jst, _ = jstep(jst, jnp.asarray(acts[i]))
    return trace(by_step, one), trace(chain, chained)


def test_golden_trace_step_by_step(replays):
    got, _ = replays
    want = np.load(GOLDEN_PATH)
    assert set(want.files) == set(got)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=5e-4, rtol=1e-3,
                                   err_msg=f"golden {k}")


def test_golden_trace_chained(replays):
    _, got = replays
    want = np.load(GOLDEN_PATH)
    assert set(want.files) == set(got)
    for k in want.files:
        a, b = got[k], want[k]
        if k == "traj_pos":
            a, b = a[:CHAINED_STEPS // 10], b[:CHAINED_STEPS // 10]
        elif k.startswith("traj_") and k != "traj_step":
            a, b = a[:CHAINED_STEPS], b[:CHAINED_STEPS]
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3,
                                   err_msg=f"golden {k}")

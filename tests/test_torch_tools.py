"""PyTorch port: the tools around the record/replay path against the JAX
package, on the CPU.

* ``viz/render2d.py``: the port's ``render_world`` and JAX's, on one state
  (JAX's gets it as numpy in a namespace tree), draw the same patches
  (type, vertices within 1e-6, colours, alphas), lines and limits; the
  rasterizer that writes ``replay``'s and ``viewer``'s PNG frames without
  matplotlib paints those shapes at their colours.
* ``viewer``: a piped command script at 1 world; each command's action is
  JAX's key map (read from scripts/viewer.py with ``ast``); ``m`` / ``n``
  restore the saved state bit for bit; a digit resets to that debug level
  as ``env.step`` with ``resets`` does; the follow camera writes frames.
* ``eval_tooluse``: ``tooluse_stats`` against scripts/eval_tooluse.py:82-106's
  expressions in ``jnp`` on the same numpy leaves, over a 4-world rollout
  of 110 steps across the prep phase's end (96) with resets inside the
  seek phase; ``eval_load_ckpt`` reads a training checkpoint; the CLI runs.
* ``ckpt_manifest``: the port's ``<n>.pt`` files listed in update order
  with their sizes and sha256.
* NaN guards: off, no check and no anomaly mode; on, a planted NaN raises
  naming its leaf, and the +inf of a missed ray does not.
* ``entry``: the port's ``fn`` against ``__graft_entry__.entry()``'s at
  1e-5; ``dryrun_multichip(1)``.
* ``cpu_benchmark``: JAX's action draws; the run prints the host CPU's
  rate.

No JAX env is compiled.
"""

import ast
import hashlib
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import NUM_PREP_STEPS
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.viz import render2d as jrender

from marl_hideandseek_torch import (
    ckpt_manifest,
    cpu_benchmark,
    entry,
    eval_tooluse,
    prng,
    viewer,
)
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.policy import make_policy
from marl_hideandseek_torch.train import (
    ActionsConfig,
    PPOConfig,
    TrainConfig,
    init_training,
)
from marl_hideandseek_torch.train import manager as manager_mod
from marl_hideandseek_torch.train.evaluate import eval_load_ckpt
from marl_hideandseek_torch.types import body_slot_ranges
from marl_hideandseek_torch.utils import runtime
from marl_hideandseek_torch.viz import render2d

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KW = dict(min_hiders=2, max_hiders=2, min_seekers=2, max_seekers=2)


# -- render2d ------------------------------------------------------------------------

def _namespace(tree):
    """A state as JAX's renderer reads it: attributes of numpy arrays."""
    import dataclasses

    return types.SimpleNamespace(**{
        f.name: (_namespace(getattr(tree, f.name))
                 if dataclasses.is_dataclass(getattr(tree, f.name))
                 else getattr(tree, f.name).numpy())
        for f in dataclasses.fields(tree)})


def _drawn(ax):
    import matplotlib.patches as mp

    out = []
    for p in ax.patches:
        verts = p.get_patch_transform().transform(p.get_path().vertices)
        out.append((type(p).__name__, verts, tuple(p.get_facecolor()),
                    p.get_alpha()))
    lines = [(l.get_xydata(), l.get_color(), l.get_linewidth())
             for l in ax.lines]
    assert all(isinstance(p, (mp.Rectangle, mp.Polygon, mp.Circle))
               for p in ax.patches)
    return out, lines, ax.get_xlim(), ax.get_ylim(), ax.get_title()


def test_render_world_matches_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = EnvConfig(num_worlds=2, **KW, sim_flags=SimFlags.ZeroAgentVelocity)
    jcfg = JCfg(num_worlds=2, **KW, sim_flags=JFlags.ZeroAgentVelocity)
    env = HideAndSeekEnv(cfg, device="cpu")
    state, _ = env.init(prng.key(4))
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        acts = torch.cat([torch.randint(0, 5, (2, cfg.max_agents, 3),
                                        generator=gen),
                          torch.zeros(2, cfg.max_agents, 2,
                                      dtype=torch.long)], -1)
        state, _ = env.step(state, acts)
    (box_lo, _), (ramp_lo, _), (agent_lo, _) = body_slot_ranges(cfg)
    # Every branch: a locked box and ramp, an inactive box and agent.
    b = state.bodies
    locked, active = b.locked.clone(), b.active.clone()
    locked[1, box_lo] = locked[1, ramp_lo] = True
    active[1, box_lo + 1] = False
    agent_active = state.agent_active.clone()
    agent_active[1, 3] = False
    state = state.replace(bodies=b.replace(locked=locked, active=active),
                          agent_active=agent_active)
    for world in (0, 1):
        got = render2d.render_world(cfg, state, world, title="t")
        want = jrender.render_world(jcfg, _namespace(state), world,
                                    title="t")
        (gp, gl, *glim), (wp, wl, *wlim) = _drawn(got), _drawn(want)
        assert len(gp) == len(wp) and len(gl) == len(wl) > 0
        for (gt, gv, gc, ga), (wt, wv, wc, wa) in zip(gp, wp):
            assert (gt, gc, ga) == (wt, wc, wa)
            np.testing.assert_allclose(gv, wv, atol=1e-6)
        for (gx, gc, gw), (wx, wc, ww) in zip(gl, wl):
            np.testing.assert_allclose(gx, wx, atol=1e-6)
            assert (gc, gw) == (wc, ww)
        assert glim == wlim
        plt.close(got.figure)
        plt.close(want.figure)


def test_rasterized_frame_and_png(tmp_path):
    """``rasterize_world`` paints ``world_shapes`` (held to JAX's patches
    above) in the axes' square: on a world cut to one wall, one box (one
    locked), one ramp and the agents, set apart, each shape's pixels take
    its colour (the box and the ramp blended at alpha 0.8 over white),
    and each agent's heading line is black. ``write_png`` writes the image
    as a PNG that matplotlib reads back exactly."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = EnvConfig(num_worlds=1, **KW, sim_flags=SimFlags.ZeroAgentVelocity)
    state, _ = HideAndSeekEnv(cfg, device="cpu").init(prng.key(6))
    (box_lo, _), (ramp_lo, _), (agent_lo, agent_hi) = body_slot_ranges(cfg)
    st, b = state.statics, state.bodies
    wall_active = torch.zeros_like(st.wall_active)
    wall_active[0, 0] = True
    active = torch.zeros_like(b.active)
    active[0, [box_lo, box_lo + 1, ramp_lo]] = True
    active[0, agent_lo:agent_hi] = True
    pos, quat = b.pos.clone(), b.quat.clone()
    spots = [(-8.0, 8.0), (8.0, 8.0), (0.0, -8.0), (-8.0, -1.0), (-2.0, -1.0),
             (4.0, -1.0), (10.0, -1.0)]
    for k, slot in enumerate([box_lo, box_lo + 1, ramp_lo,
                              *range(agent_lo, agent_hi)]):
        pos[0, slot, :2] = torch.tensor(spots[k])
    quat[0, :] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    locked = torch.zeros_like(b.locked)
    locked[0, box_lo + 1] = True
    wall_pos = st.wall_pos.clone()
    wall_pos[0, 0] = torch.tensor([0.0, 15.0, 0.0])
    state = state.replace(
        statics=st.replace(wall_active=wall_active, wall_pos=wall_pos),
        bodies=b.replace(active=active, pos=pos, quat=quat, locked=locked))
    img = render2d.rasterize_world(cfg, state, 0)
    size = render2d.FRAME_PX
    assert img.shape == (size, size, 3) and img.dtype == np.uint8
    px = 2 * render2d.LIMIT / size

    def at(x, y):
        return tuple(int(v) for v in img[int((render2d.LIMIT - y) / px),
                                         int((x + render2d.LIMIT) / px)])

    def rgb(color, alpha=1.0):
        c = np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)])
        return tuple(int(v) for v in np.round(alpha * c + (1 - alpha) * 255))

    shapes = render2d.world_shapes(cfg, state, 0)
    assert [sh["kind"] for sh in shapes] == (
        ["rect", "polygon", "polygon", "polygon"] + ["circle", "line"] * 4)
    assert at(0.0, 15.0) == rgb("#444444")
    assert at(-8.0, 8.0) == rgb("#e67e22", 0.8)
    assert at(8.0, 8.0) == rgb("#c0392b", 0.8)
    assert at(0.0, -8.0) == rgb("#9b59b6", 0.8)
    for sh, line in zip(shapes[4::2], shapes[5::2]):
        (x, y), color = sh["center"], sh["color"]
        assert at(x, y - 0.5) == rgb(color)          # behind the heading
        assert at(x, y + 0.8) == (0, 0, 0)           # on the heading line
        assert at(x, y + 1.9) == (255, 255, 255)     # past the line's end
        assert at(x + 1.2, y) == (255, 255, 255)     # past the body's edge
    assert at(0.0, 0.0) == (255, 255, 255)
    path = tmp_path / "f.png"
    render2d.write_png(str(path), img)
    back = plt.imread(str(path))
    np.testing.assert_array_equal(np.round(back[..., :3] * 255), img)


# -- viewer ---------------------------------------------------------------------------

def _jax_key_map():
    """(neutral move bucket, {key: (component, bucket)}) of
    scripts/viewer.py's command chain."""
    tree = ast.parse((ROOT / "scripts" / "viewer.py").read_text())
    neutral, keys = None, {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "full" and getattr(node.func.value, "id", "") == "np"):
            neutral = ast.literal_eval(node.args[1])
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and getattr(node.test.left, "id", "") == "cmd"
                and isinstance(node.test.ops[0], ast.Eq)):
            key = ast.literal_eval(node.test.comparators[0])
            for st in node.body:
                if (isinstance(st, ast.Assign) and
                        isinstance(st.targets[0], ast.Subscript) and
                        st.targets[0].value.id == "act"):
                    idx = st.targets[0].slice.elts
                    keys[key] = (ast.literal_eval(idx[2]),
                                 ast.literal_eval(st.value))
    return neutral, keys


def test_viewer_key_map_is_jax():
    neutral, keys = _jax_key_map()
    assert neutral == viewer.NEUTRAL_MOVE and keys == viewer.KEYS
    assert set(keys) == set("wsadqegl")
    for cmd in [*keys, "", "z"]:
        act = viewer.key_action(cmd, 4, 2)
        want = np.full((1, 4, 5), neutral, np.int32)
        want[..., 3:] = 0
        if cmd in keys:
            want[0, 2, keys[cmd][0]] = keys[cmd][1]
        np.testing.assert_array_equal(act, want)


def _same_state(a, b, skip_team_reward=False):
    if skip_team_reward:
        a, b = (s.replace(hider_team_reward=torch.zeros(1)) for s in (a, b))
    for x, y in zip(a.leaves(), b.leaves()):
        x = x.view(torch.int32) if x.dtype == torch.uint32 else x
        y = y.view(torch.int32) if y.dtype == torch.uint32 else y
        if not torch.equal(x, y):
            return False
    return True


def test_viewer_script(tmp_path, monkeypatch):
    v = viewer.Viewer(str(tmp_path / "frames"), follow=True, device="cpu")
    seen = []
    step = v.env.step

    def spy(state, actions, resets=None):
        seen.append((actions.clone(), None if resets is None
                     else resets.clone()))
        return step(state, actions, resets)

    monkeypatch.setattr(v.env, "step", spy)
    _, keys = _jax_key_map()
    saved = None
    for cmd in "w w g l m d d n f q 3 r x".split():
        before = v.state
        n_frames = len(v.written)
        if cmd == "3":
            want, _ = step(before, torch.from_numpy(
                viewer.key_action("3", v.cfg.max_agents, 0)),
                torch.full((1,), 3, dtype=torch.int32))
        assert v.command(cmd) == (cmd != "x")
        if cmd in keys:
            act, resets = seen[-1]
            np.testing.assert_array_equal(
                act.numpy(), viewer.key_action(cmd, v.cfg.max_agents, 0))
            assert int(act[0, 0, keys[cmd][0]]) == keys[cmd][1]
            assert resets is None
        if cmd == "m":
            saved = before
            assert v.state is before and len(v.written) == n_frames
        if cmd == "n":
            # Every leaf but the last step's team reward, which no
            # checkpoint holds: a load starts it at a fresh level's 1, as
            # JAX's load does.
            assert not _same_state(before, saved, True)
            assert _same_state(v.state, saved, True)
            assert float(v.state.hider_team_reward[0]) == 1.0
        if cmd == "3":
            assert int(seen[-1][1][0]) == 3
            assert _same_state(v.state, want)
        if cmd == "r":
            assert int(seen[-1][1][0]) == 1
    assert len(v.written) == 12
    assert all(pathlib.Path(p).stat().st_size > 0 for p in v.written)
    assert not v.follow


# -- eval_tooluse ---------------------------------------------------------------------

def _jax_stats(jcfg, st, team_reward, pre_step, spawn_ramp_xy):
    """scripts/eval_tooluse.py:82-106, on jnp arrays."""
    from marl_hideandseek_tpu.types import body_slot_ranges as jranges

    (box_lo, box_hi), (ramp_lo, ramp_hi), _ = jranges(jcfg)
    in_seek = pre_step >= NUM_PREP_STEPS - 1
    locked_w = jnp.any(st["locked"][box_lo:box_hi], axis=0)
    ramp_locked_w = jnp.any(st["locked"][ramp_lo:ramp_hi], axis=0)
    ramp_act = st["active"][ramp_lo:ramp_hi]
    ramp_xy = st["pos"][ramp_lo:ramp_hi, :2]
    ramp_moved_w = jnp.any(
        (jnp.linalg.norm(ramp_xy - spawn_ramp_xy, axis=1) > 0.5) &
        ramp_act, axis=0)
    grab_w = jnp.any(st["target"] >= 0, axis=0)
    hidden_w = team_reward > 0.0
    fresh = st["step"] == 0
    stats = (jnp.sum(in_seek), jnp.sum(locked_w & in_seek),
             jnp.sum(grab_w & in_seek), jnp.sum(hidden_w & in_seek),
             jnp.sum(ramp_locked_w & in_seek),
             jnp.sum(ramp_moved_w & in_seek & ~fresh))
    spawn = jnp.where(fresh[None, None, :], ramp_xy, spawn_ramp_xy)
    return np.asarray(jnp.stack(stats)), np.asarray(spawn)


def test_tooluse_stats_match_jax():
    w = 4
    flags = (SimFlags.RandomFlipTeams | SimFlags.UseFixedWorld |
             SimFlags.ZeroAgentVelocity)
    cfg = EnvConfig(num_worlds=w, **KW, sim_flags=flags, rand_seed=5)
    jcfg = JCfg(num_worlds=w, **KW, sim_flags=JFlags(int(flags)))
    env = PackedEnv(cfg, device="cpu")
    ps, _ = env.init(prng.key(7))
    _, (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)
    spawn = ps.bodies.pos[ramp_lo:ramp_hi, :2]
    jspawn = spawn.numpy()
    gen = torch.Generator().manual_seed(1)
    total = np.zeros(6, np.int64)
    for i in range(110):
        acts = torch.cat([
            torch.randint(0, 5, (cfg.max_agents, 3, w), generator=gen),
            (torch.rand(cfg.max_agents, 2, w, generator=gen) < 0.7).long()],
            1).to(torch.int32)
        resets = None
        if i in (100, 104):
            resets = torch.tensor([0, 1, 0, 1] if i == 100 else [1, 0, 0, 0],
                                  dtype=torch.int32)
        pre = ps.step
        ps, res = env.step(ps, acts, resets)
        # The rollout's leaves, then a copy with a grab and a locked ramp
        # planted in one world, so that every count takes part.
        for planted in (False, True):
            locked, target = ps.bodies.locked, ps.grab.target
            pos = ps.bodies.pos
            if planted:
                locked, target = locked.clone(), target.clone()
                pos = pos.clone()
                locked[0, i % w] = locked[ramp_lo, (i + 1) % w] = True
                target[0, (i + 2) % w] = 2
                pos[ramp_lo, 0, (i + 3) % w] += 0.75
            got, new_spawn = eval_tooluse.tooluse_stats(
                cfg, ps.replace(bodies=ps.bodies.replace(locked=locked,
                                                         pos=pos),
                                grab=ps.grab.replace(target=target)),
                res.team_reward, pre, spawn)
            leaves = {"locked": locked, "active": ps.bodies.active,
                      "pos": pos, "target": target, "step": ps.step}
            want, new_jspawn = _jax_stats(
                jcfg, {k: jnp.asarray(v.numpy()) for k, v in leaves.items()},
                jnp.asarray(res.team_reward.numpy()),
                jnp.asarray(pre.numpy()), jnp.asarray(jspawn))
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"step {i}")
            np.testing.assert_array_equal(new_spawn.numpy(), new_jspawn)
            total += want
            if not planted:
                carry = new_spawn, new_jspawn
        spawn, jspawn = carry
    # Every count took part.
    assert (total > 0).all(), total


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    """A training state at tiny shapes and its checkpoint file."""
    cfg, env, policy = _tiny_training()
    mgr = init_training("cpu", cfg, env, policy)
    tmp = tmp_path_factory.mktemp("train")
    return mgr, mgr.save_ckpt(str(tmp)), tmp


def _tiny_training(pbt=True):
    from marl_hideandseek_torch.train import PBTConfig

    env = PackedEnv(EnvConfig(
        num_worlds=2, min_hiders=1, max_hiders=1, min_seekers=1,
        max_seekers=1, num_pbt_policies=2 if pbt else 0,
        sim_flags=SimFlags.ZeroAgentVelocity | SimFlags.UseFixedWorld),
        device="cpu")
    cfg = TrainConfig(
        num_worlds=2, num_agents_per_world=2, num_updates=1,
        actions=ActionsConfig(actions_num_buckets=(5, 5, 5, 2, 2)),
        steps_per_update=4, num_bptt_chunks=2, lr=1e-3,
        algo=PPOConfig(num_mini_batches=1, num_epochs=1), seed=5,
        pbt=PBTConfig(num_teams=2, team_size=1, num_train_policies=2,
                      num_past_policies=1, self_play_portion=0.0,
                      cross_play_portion=0.0, past_play_portion=1.0)
        if pbt else None)
    return cfg, env, make_policy(device="cpu")


def test_eval_load_ckpt_reads_a_training_checkpoint(training):
    mgr, path, tmp = training
    policy = make_policy(dtype=torch.bfloat16, device="cpu")
    params, stats, elo = eval_load_ckpt(policy, path, train_only=True,
                                        device="cpu")
    assert set(params) == set(mgr.state.params)
    for k, v in mgr.state.params.items():
        assert torch.equal(params[k], v)
    assert torch.equal(elo, mgr.state.elo[:2])
    for k, v in mgr.state.obs_stats.mean.items():
        assert torch.equal(stats.mean[k], v)
    params, _, elo = eval_load_ckpt(policy, path, device="cpu")
    assert next(iter(params.values())).shape[0] == 3 and elo.shape == (3,)
    assert eval_tooluse.main([str(tmp), "0", "--num-worlds", "2",
                              "--num-steps", "3", "--num-hiders", "1",
                              "--num-seekers", "1", "--device", "cpu"]) == 0


# -- ckpt_manifest ---------------------------------------------------------------------

def test_ckpt_manifest_lists_the_port_checkpoints(tmp_path):
    run = tmp_path / "runA"
    run.mkdir()
    for step, size in ((10, 300), (2, 100)):
        (run / f"{step}.pt").write_bytes(bytes(range(256)) * (size // 100))
    (run / "notes.pt").write_bytes(b"x")
    (run / "7").mkdir()
    assert ckpt_manifest.main(["runA", "--ckpt-root", str(tmp_path),
                               "--regen-cmd", "python -m x"]) == 0
    text = (run / "CKPT_MANIFEST.md").read_text()
    assert text.index("## update 2") < text.index("## update 10")
    assert "notes" not in text and "update 7" not in text
    assert "```\npython -m x\n```" in text
    for step in (2, 10):
        data = (run / f"{step}.pt").read_bytes()
        assert (f"- `{step}.pt` {len(data)} B sha256 "
                f"`{hashlib.sha256(data).hexdigest()}`") in text


# -- NaN guards -------------------------------------------------------------------------

@pytest.fixture()
def guards(monkeypatch):
    """Guards unset (off), restored after the test."""
    monkeypatch.delenv("MHS_NAN_GUARDS", raising=False)
    monkeypatch.setattr(runtime, "_NAN_GUARDS", None)


def _spy_update(monkeypatch):
    """Records, per ppo_update call, whether anomaly mode was on, and per
    check_finite call its place."""
    seen = {"anomaly": [], "checks": []}
    ppo, check = manager_mod.ppo_update, manager_mod.check_finite

    def ppo_spy(*a, **kw):
        seen["anomaly"].append(torch.is_anomaly_enabled())
        return ppo(*a, **kw)

    def check_spy(leaves, where, plus_inf=()):
        seen["checks"].append(where)
        return check(leaves, where, plus_inf)

    monkeypatch.setattr(manager_mod, "ppo_update", ppo_spy)
    monkeypatch.setattr(manager_mod, "check_finite", check_spy)
    return seen


def test_nan_guards_off_add_nothing(training, guards, monkeypatch):
    mgr, _, _ = training
    seen = _spy_update(monkeypatch)
    assert not runtime.nan_guards_on()
    mgr.update_iter()
    assert seen == {"anomaly": [False], "checks": []}


def test_nan_guards_on(training, guards, monkeypatch):
    mgr, _, _ = training
    seen = _spy_update(monkeypatch)
    monkeypatch.setenv("MHS_NAN_GUARDS", "1")
    assert runtime.nan_guards_on()
    # The state holds the +inf of missed rays, by design.
    assert bool(torch.isinf(mgr.state.rollout.env_state.act_hit_t).any())
    out = mgr.update_iter()
    assert seen["anomaly"] == [True]
    assert seen["checks"] == ["before update 0", "after update 1"]
    out.eval_elo(8)
    assert seen["checks"][-1] == "after eval_elo at update 1"

    leaf = "backbone.critic_encoder.rnn.layer_0_hh.kernel"
    assert leaf in mgr.state.params
    bad = dict(mgr.state.params)
    bad[leaf] = bad[leaf].clone()
    bad[leaf].view(-1)[7] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=f"params.{leaf} before update 0"):
        mgr.replace(state=mgr.state.replace(params=bad)).update_iter()
    runtime.enable_nan_guards(False)
    monkeypatch.setenv("MHS_NAN_GUARDS", "1")
    assert not runtime.nan_guards_on()


def test_check_finite_allows_only_plus_inf_where_named():
    inf, nan = float("inf"), float("nan")
    runtime.check_finite({"a": torch.tensor([1.0, inf]),
                          "n": torch.tensor([3], dtype=torch.int32)},
                         "x", plus_inf=("a",))
    cases = (({"a": torch.tensor([1.0, inf])}, ()),
             ({"b": torch.ones(2), "a": torch.tensor([-inf])}, ("a",)),
             ({"a": torch.tensor([nan]), "c": torch.tensor([nan])}, ("a",)))
    for leaves, plus in cases:
        with pytest.raises(FloatingPointError, match="in a at w"):
            runtime.check_finite(leaves, "at w", plus)


# -- entry --------------------------------------------------------------------------------

def test_entry_matches_graft_entry():
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = entry.entry("cpu")
    got = fn(*args)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)
    flat = [x for enc in got[2] for x in enc]
    jflat = jax.tree.leaves(want[2])
    assert len(flat) == len(jflat) == 4
    for a, b in zip(flat, jflat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def test_dryrun_multichip_one_rank():
    out = entry.dryrun_multichip(1, "cpu")
    assert out["update_idx"] == 1 and out["step"] == 1
    assert all(bool(torch.isfinite(v).all()) for v in out["params"].values())


# -- cpu_benchmark --------------------------------------------------------------------------

def test_cpu_benchmark_draws_and_rate(capsys):
    key = prng.key(10)
    jkey = jax.random.PRNGKey(10)
    for i in (0, 23):
        k1, k2 = jax.random.split(jax.random.fold_in(jkey, i))
        want = jnp.concatenate([jax.random.randint(k1, (3, 4, 3), 0, 5),
                                jax.random.randint(k2, (3, 4, 2), 0, 2)], -1)
        np.testing.assert_array_equal(
            cpu_benchmark.bench_actions(key, i, 3, 4).numpy(),
            np.asarray(want))
    assert cpu_benchmark.main(["2", "20", "1", "1"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("FPS: ") and "on the host CPU" in line
    assert "steps=20" in line


# -- no JAX in the port ---------------------------------------------------------------------

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "marl_hideandseek_tpu")


def test_port_imports_without_jax():
    """Every module of the port and chip_smoke.py import in a fresh process
    where JAX, flax, orbax and the JAX package cannot be imported, and the
    record log's library is the port's own build, not native/'s."""
    import subprocess
    import sys

    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import marl_hideandseek_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
from marl_hideandseek_torch.utils import ckptlog
lib = ckptlog._lib()
assert "/native/" not in lib._name and "_build" in lib._name, lib._name
bad = [n for n in sys.modules if n.split(".")[0] in {BLOCKED!r}
       and sys.modules[n] is not None]
assert not bad, bad
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 50

"""PyTorch port: the record/replay path against the JAX package.

* The checkpoint record log (``utils/ckptlog.py`` on ``csrc/ckptlog.cpp``):
  a log written by the port reads in JAX's ``CkptLogReader`` and one
  written by JAX's ``CkptLogWriter`` reads in the port, with JAX's native
  codec and with its pure-Python one (``_LIB`` / ``_LIB_TRIED`` set by
  ``monkeypatch``); the port's native and plain codecs write the same
  bytes; CRC32C's known answer; a flipped payload byte raises; a header
  left at 0 frames is scanned.
* ``python -m marl_hideandseek_torch.infer`` with infer.sh's arguments and
  ``--record-log`` at 4 worlds, 2 seeded policies, on the CPU: every frame
  is the checkpoint record of that step's state; JAX's
  ``unpack_checkpoints`` reads the frames to the port's leaves bit for
  bit; the last frame loaded through ``load_checkpoints`` restores the
  bodies bit for bit and regenerates the same statics; ``replay`` writes
  its frames and refuses the log at 3v3; ``replay3d``'s scene from the
  log equals the scene of the recorded states, and its page is JAX's
  ``_PAGE`` (read with ``ast``: importing scripts/replay3d.py would turn
  on a compilation cache).
* ``headless --record``: the saved actions are JAX's ``jax.random``
  draws, and replaying them from ``init`` gives the run's final state.

No JAX env is compiled.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_hideandseek_tpu.config import EnvConfig as JCfg
from marl_hideandseek_tpu.config import SimFlags as JFlags
from marl_hideandseek_tpu.env import checkpoint as jckpt
from marl_hideandseek_tpu.utils import ckptlog as jlog

from marl_hideandseek_torch import bridge, headless, infer, prng, replay
from marl_hideandseek_torch import replay3d
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.checkpoint import (
    pack_checkpoints,
    record_frame,
    save_checkpoints,
    unpack_checkpoints,
)
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.policy import make_policy
from marl_hideandseek_torch.types import unpack_state
from marl_hideandseek_torch.utils import ckptlog

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
W = 4
STEPS = 30
POLICIES = 2
# infer.sh's arguments as written, but 4 worlds and 30 steps.
INFER_SH = ["--num-worlds", str(W), "--num-steps", str(STEPS),
            "--num-hiders", "2", "--num-seekers", "2"]
INFER_CFG = EnvConfig(num_worlds=W, min_hiders=2, max_hiders=2,
                      min_seekers=2, max_seekers=2,
                      sim_flags=SimFlags.UseFixedWorld |
                      SimFlags.ZeroAgentVelocity, rand_seed=5)


def _frames(seed, n=5, w=3, nb=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (w, nb), dtype=np.uint8) for _ in range(n)]


def _jax_plain(monkeypatch):
    monkeypatch.setattr(jlog, "_LIB", None)
    monkeypatch.setattr(jlog, "_LIB_TRIED", True)


# -- the record log ---------------------------------------------------------------

@pytest.mark.parametrize("jax_codec", ["native", "plain"])
def test_port_log_reads_in_jax(tmp_path, monkeypatch, jax_codec):
    frames = _frames(1)
    path = str(tmp_path / "port.bin")
    with ckptlog.CkptLogWriter(path, 3, 11) as w:
        for i, f in enumerate(frames):
            w.append(torch.from_numpy(f) if i % 2 else f)
    if jax_codec == "plain":
        _jax_plain(monkeypatch)
    with jlog.CkptLogReader(path) as r:
        assert r._native == (jax_codec == "native")
        assert (r.num_frames, r.num_worlds, r.frame_bytes) == (5, 3, 11)
        for i in (3, 0, 4, 1, 2):
            np.testing.assert_array_equal(r.read(i), frames[i])


@pytest.mark.parametrize("jax_codec", ["native", "plain"])
def test_jax_log_reads_in_port(tmp_path, monkeypatch, jax_codec):
    frames = _frames(2, n=4, w=2, nb=1044)
    path = str(tmp_path / "jax.bin")
    if jax_codec == "plain":
        _jax_plain(monkeypatch)
    with jlog.CkptLogWriter(path, 2, 1044) as w:
        assert w._native == (jax_codec == "native")
        for f in frames:
            w.append(f)
    with ckptlog.CkptLogReader(path) as r:
        assert (r.num_frames, r.num_worlds, r.frame_bytes) == (4, 2, 1044)
        for i in (2, 0, 3, 1):
            np.testing.assert_array_equal(r.read(i), frames[i])
    w_, nb, got = ckptlog.read_log_plain(path)
    assert (w_, nb) == (2, 1044)
    np.testing.assert_array_equal(got, np.stack(frames))


def test_native_and_plain_codecs_write_the_same_bytes(tmp_path):
    frames = _frames(3)
    native, plain = tmp_path / "native.bin", tmp_path / "plain.bin"
    with ckptlog.CkptLogWriter(str(native), 3, 11) as w:
        for f in frames:
            w.append(f)
    ckptlog.write_log_plain(str(plain), 3, 11, frames)
    assert native.read_bytes() == plain.read_bytes()
    _, _, got = ckptlog.read_log_plain(str(native))
    np.testing.assert_array_equal(got, np.stack(frames))


@pytest.mark.parametrize("codec", ["native", "plain"])
def test_crc32c_known_answer(codec):
    fn = ckptlog.crc32c if codec == "native" else ckptlog.crc32c_plain
    assert fn(b"123456789") == 0xE3069283
    data = bytes(range(256)) * 3
    assert fn(data) == ckptlog.crc32c_plain(data) == jlog._crc32c(data)


def test_flipped_payload_byte_raises(tmp_path):
    path = tmp_path / "log.bin"
    ckptlog.write_log_plain(str(path), 3, 11, _frames(4))
    raw = bytearray(path.read_bytes())
    frame = ckptlog.FRAME.size + 3 * 11
    raw[ckptlog.HEADER.size + 2 * frame + ckptlog.FRAME.size + 5] ^= 0x10
    path.write_bytes(bytes(raw))
    with ckptlog.CkptLogReader(str(path)) as r:
        r.read(1)
        r.read(3)
        with pytest.raises(OSError, match="CRC mismatch at frame 2"):
            r.read(2)
    with pytest.raises(OSError, match="CRC mismatch at frame 2"):
        ckptlog.read_log_plain(str(path))


def test_header_without_count_is_scanned(tmp_path, monkeypatch):
    frames = _frames(5, n=3)
    path = str(tmp_path / "open.bin")
    ckptlog.write_log_plain(path, 3, 11, frames, num_frames_in_header=False)
    assert ckptlog.HEADER.unpack_from(open(path, "rb").read(), 0)[5] == 0
    with ckptlog.CkptLogReader(path) as r:
        assert r.num_frames == 3
        np.testing.assert_array_equal(r.read(2), frames[2])
    _jax_plain(monkeypatch)
    with jlog.CkptLogReader(path) as r:
        assert r.num_frames == 3


def test_writer_refuses_a_frame_of_another_shape(tmp_path):
    with ckptlog.CkptLogWriter(str(tmp_path / "x.bin"), 3, 11) as w:
        with pytest.raises(ValueError, match=r"\[3, 11\] uint8"):
            w.append(np.zeros((3, 12), np.uint8))


# -- infer --record-log, replay, replay3d ----------------------------------------

@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """infer's main with infer.sh's arguments and --record-log, and the
    same run's states through run_inference."""
    tmp = tmp_path_factory.mktemp("record")
    policy = make_policy(num_policies=POLICIES, device="cpu",
                         key=prng.key(3))
    params = {k: v.detach() for k, v in
              policy.actor_critic.named_parameters()}
    env = PackedEnv(INFER_CFG, device="cpu")
    norm = policy.obs_preprocess
    obs = {k: v.flatten(0, 1) for k, v in
           norm.prep(env.init()[1].obs).items()}
    stats = norm.init_state(obs)
    ckpt = tmp / "policies.pt"
    bridge.save_policy_checkpoint(ckpt, params, stats, [1500.0, 1520.0])
    log = tmp / "record.bin"
    assert infer.main(["--ckpt-path", str(ckpt), *INFER_SH, "--record-log",
                       str(log), "--device", "cpu"]) == 0
    states = []
    infer.run_inference(env, policy, params, stats, STEPS,
                        state_cb=lambda i, ps: states.append(ps))
    return tmp, log, states


def test_record_log_holds_every_step(recorded):
    _, log, states = recorded
    with ckptlog.CkptLogReader(str(log)) as r:
        assert (r.num_frames, r.num_worlds, r.frame_bytes) == (STEPS, W,
                                                               1044)
        for i in range(STEPS):
            want = pack_checkpoints(save_checkpoints(
                INFER_CFG, unpack_state(states[i])))
            np.testing.assert_array_equal(r.read(i), want.numpy(),
                                          err_msg=f"frame {i}")
            assert torch.equal(record_frame(INFER_CFG, states[i]), want)
    assert int(states[-1].step[0]) == STEPS


def test_jax_unpacks_the_port_frames(recorded):
    _, log, states = recorded
    jcfg = JCfg(num_worlds=W, min_hiders=2, max_hiders=2, min_seekers=2,
                max_seekers=2,
                sim_flags=JFlags.UseFixedWorld | JFlags.ZeroAgentVelocity)
    with ckptlog.CkptLogReader(str(log)) as r:
        for i in (0, STEPS // 2, STEPS - 1):
            frame = r.read(i)
            jck = jckpt.unpack_checkpoints(jcfg, jnp.asarray(frame))
            want = bridge.checkpoint_to_numpy(
                save_checkpoints(INFER_CFG, unpack_state(states[i])))
            got = unpack_checkpoints(INFER_CFG, torch.from_numpy(
                frame.copy()))
            port = bridge.checkpoint_to_numpy(got)
            for name, v in want.items():
                jv = np.asarray(getattr(jck, name))
                assert jv.dtype == v.dtype, name
                np.testing.assert_array_equal(jv, v, err_msg=name)
                np.testing.assert_array_equal(port[name], v, err_msg=name)


def test_last_frame_loads_the_run_state(recorded):
    _, log, states = recorded
    with ckptlog.CkptLogReader(str(log)) as r:
        env = replay.replay_env(r, 2, 2, "cpu")
        (i, last), = list(replay.replay_states(r, env, 1))[-1:]
    assert i == STEPS - 1
    want = unpack_state(states[-1])
    for a, b in zip(last.bodies.leaves(), want.bodies.leaves()):
        assert torch.equal(a, b)
    for a, b in zip(last.statics.leaves(), want.statics.leaves()):
        assert torch.equal(a, b)
    for name in ("step", "running_scores", "finished_scores",
                 "agent_type", "agent_active"):
        assert torch.equal(getattr(last, name), getattr(want, name)), name
    for a, b in zip(last.grab.leaves(), want.grab.leaves()):
        assert torch.equal(a, b)


def test_replay_writes_frames_and_refuses_other_teams(recorded):
    tmp, log, _ = recorded
    out = tmp / "frames"
    assert replay.main([str(log), "--out", str(out), "--every", "10",
                        "--num-hiders", "2", "--num-seekers", "2",
                        "--device", "cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "frame_000000.png", "frame_000010.png", "frame_000020.png"]
    with pytest.raises(ValueError, match="1044 bytes, expected 1230"):
        replay.main([str(log), "--out", str(tmp / "bad"), "--device", "cpu"])


def test_replay3d_scene_and_page(recorded):
    tmp, log, states = recorded
    every = 7
    with ckptlog.CkptLogReader(str(log)) as r:
        env = replay.replay_env(r, 2, 2, "cpu")
        scene = replay3d.build_scene(r, env, 1, every)
    cfg = env.cfg
    want = [replay3d.scene_frame(cfg, unpack_state(states[i]), 1, i)
            for i in range(0, STEPS, every)]
    assert scene["frames"] == want
    assert scene["walls"] == replay3d.scene_walls(unpack_state(states[0]), 1)
    assert scene["walls"] and all(f["bodies"] for f in scene["frames"])
    src = (ROOT / "scripts" / "replay3d.py").read_text()
    page = next(n.value for n in ast.parse(src).body
                if isinstance(n, ast.Assign) and n.targets[0].id == "_PAGE")
    assert ast.literal_eval(page) == replay3d.PAGE
    html = tmp / "replay.html"
    assert replay3d.main([str(log), "--out", str(html), "--every", "10",
                          "--num-hiders", "2", "--num-seekers", "2",
                          "--device", "cpu"]) == 0
    text = html.read_text()
    assert "__SCENE__" not in text and '"frames": [{"i": 0, "s": 1' in text


# -- headless --record --------------------------------------------------------------

def test_headless_record_is_jax_draws_and_replays(tmp_path):
    path = tmp_path / "actions.npy"
    assert headless.main(["4", "5", "--rand-actions", "--record", str(path),
                          "--device", "cpu"]) == 0
    got = np.load(path)
    cfg = headless.headless_config(4)
    assert got.shape == (5, 4, cfg.max_agents, 5) and got.dtype == np.int32
    key = jax.random.PRNGKey(5)
    for i in range(5):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        want = jnp.concatenate([
            jax.random.randint(k1, (4, cfg.max_agents, 3), 0, 11),
            jax.random.randint(k2, (4, cfg.max_agents, 2), 0, 2)], axis=-1)
        np.testing.assert_array_equal(got[i], np.asarray(want))
    env = HideAndSeekEnv(cfg, device="cpu")
    final, _, _, actions = headless.soak(env, 5, True, record=True)
    np.testing.assert_array_equal(actions, got)
    state, _ = env.init(prng.key(5))
    for a in got:
        state, _ = env.step(state, torch.from_numpy(a))
    for a, b in zip(state.leaves(), final.leaves()):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b)

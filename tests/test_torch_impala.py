"""PyTorch port: the ``impala_cnn`` policy (IMPALA's deep residual network
on each agent's rendered 64x64 RGBD; ``policy.ImpalaCnnNet``) and the
env's frames on the CPU, at a few worlds.

The program against the plain reference (``plainref/impala_cnn.py``:
``F.conv2d``, the SAME pool padded by hand, the LSTM in its equations,
float32, nothing of the port) on seeded random weights with every
constant leaf moved, 2 policies, on real frames of 2v2 worlds rendered
by the env after a few random steps. Tolerances: the forward within 1e-5
of the reference's largest magnitude (float32 summed in other orders:
the program's batched products against the reference's per-policy,
per-step ones; TF32 would move it ~1e-3); the replay against the
reference stepped one step at a time within 1e-5 (the same, over six
steps of the LSTM); the PPO loss and its gradients within 1e-4 (the
backward sums longer chains of those roundings; per leaf over its
largest gradient, or a thousandth of the largest leaf's where that is
larger). The frames and the pool are compared exactly.
"""

import ast
import json
import pathlib

import pytest
import torch
from torch.func import functional_call

from marl_hideandseek_torch import bridge, infer, prng
from marl_hideandseek_torch import policy as tpolicy
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.models import Policy
from marl_hideandseek_torch.models.layers import (
    Conv2d,
    DenseLayerCritic,
    init_params,
    max_pool_same,
)
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.train import __main__ as train_cli
from marl_hideandseek_torch.train import cfg as tcfg
from marl_hideandseek_torch.train import init_training
from marl_hideandseek_torch.train.ppo import _policy_loss
from marl_hideandseek_torch.train.rollout import MethodCall, collect_rollout
from marl_hideandseek_torch.viz import rgbd as plain_rgbd
from plainref import impala_cnn as ref

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORWARD = 1e-5
LOSS = 1e-4
P = 2
W = 2
ENV = EnvConfig(num_worlds=W, sim_flags=SimFlags.RandomFlipTeams |
                SimFlags.UseFixedWorld | SimFlags.ZeroAgentVelocity,
                rand_seed=11, render_frames=True)
BUCKETS = tpolicy.DEFAULT_ACTION_BUCKETS


def rel(got, want) -> float:
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def random_actions(g, w=W):
    return torch.cat([torch.randint(0, 5, (4, 3, w), generator=g),
                      torch.randint(0, 2, (4, 2, w), generator=g)],
                     1).to(torch.int32)


@pytest.fixture(scope="module")
def pol():
    """Two policies, every zero or one leaf moved by seeded noise."""
    pol = tpolicy.make_policy(backbone="impala_cnn", num_policies=P,
                              device="cpu", key=prng.key(4))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for v in pol.actor_critic.parameters():
            if bool((v == 0).all()) or bool((v == 1).all()):
                v.add_(0.05 * torch.randn(v.shape, generator=g))
    return pol


@pytest.fixture(scope="module")
def env_steps():
    """(state, observations) after 0 to 6 steps of random actions."""
    env = PackedEnv(ENV, device="cpu")
    ps, res = env.init()
    g = torch.Generator().manual_seed(1)
    out = [(ps, {k: v.clone() for k, v in res.obs.items()})]
    for _ in range(6):
        ps, res = env.step(ps, random_actions(g))
        out.append((ps, {k: v.clone() for k, v in res.obs.items()}))
    return out


def flat_obs(pol, obs, g):
    """Prepped observations [W * 4, ..] with random core inputs."""
    out = {k: v.flatten(0, 1) for k, v in pol.obs_preprocess.prep(obs).items()}
    n = out["self_data"].shape[0]
    acts = torch.stack([torch.randint(0, b, (n,), generator=g)
                        for b in BUCKETS], -1)
    out["prev_action"] = torch.cat([torch.nn.functional.one_hot(acts[:, i], b)
                                    for i, b in enumerate(BUCKETS)],
                                   -1).float()
    out["prev_reward"] = torch.rand(n, 1, generator=g) * 2.0 - 1.0
    return out


@pytest.fixture(scope="module")
def seq(pol, env_steps):
    """Normalized observations ``[T = 6, N = 8, ..]`` of steps 1-6 and
    random recurrent states."""
    norm = pol.obs_preprocess
    g = torch.Generator().manual_seed(2)
    obs = [flat_obs(pol, o, g) for _, o in env_steps[1:]]
    stats = norm.update_state(norm.init_state(obs[-1]), obs[-1])
    nobs = {k: torch.stack([norm.normalize(stats, o)[k] for o in obs])
            for k in obs[0]}
    n = nobs["self_data"].shape[1]
    rnn = ((0.5 * torch.randn(1, n, 256, generator=g),
            0.5 * torch.randn(1, n, 256, generator=g)),)
    return nobs, rnn


def params_of(pol):
    return {k: v.detach() for k, v in pol.actor_critic.named_parameters()}


def test_parameter_tree_is_the_references():
    """Names and shapes as the reference takes them; each leaf drawn with
    the initialiser the reference lists (orthogonal columns of its fan-in
    matrix, at the listed scale)."""
    pol = tpolicy.make_policy(backbone="impala_cnn", device="cpu")
    got = {k: tuple(v.shape[1:]) for k, v in
           pol.actor_critic.named_parameters()}
    assert got == {k: s for k, (s, _, _) in ref.PARAMS.items()}
    for k, v in pol.actor_critic.named_parameters():
        shape, in_dims, init = ref.PARAMS[k]
        if init in ("zeros", "ones"):
            assert bool((v == (init == "ones")).all()), k
            continue
        if init[0] == "conv_orthogonal":
            q = v[0].reshape(shape[0], -1).T
        else:
            q = v[0].reshape(-1, shape[-1])
        small = q if q.shape[0] >= q.shape[1] else q.T
        gram = small.T @ small / init[1] ** 2
        torch.testing.assert_close(gram, torch.eye(gram.shape[0]),
                                   atol=1e-5, rtol=0)


def test_forward_matches_plain_reference(pol, seq):
    nobs, rnn = seq
    step = {k: v[0] for k, v in nobs.items()}
    params = params_of(pol)
    with torch.no_grad():
        got = pol.actor_critic(rnn, step)
        want = functional_call(ref.ActorCritic(P), params, (rnn, step),
                               strict=True)
        got_act = pol.actor_critic.act(rnn, step)
        want_act = functional_call(
            MethodCall(ref.ActorCritic(P), "act"),
            {f"ac.{k}": v for k, v in params.items()}, (rnn, step),
            strict=True)
    assert rel(got[0].logits, want[0].logits) <= FORWARD
    assert rel(got[1]["value"], want[1]["value"]) <= FORWARD
    for a, b in zip([x for e in got[2] for x in e] +
                    [x for e in got_act[1] for x in e],
                    [x for e in want[2] for x in e] +
                    [x for e in want_act[1] for x in e]):
        assert a.shape == b.shape and rel(a, b) <= FORWARD
    assert rel(want_act[0].logits, want[0].logits) == 0.0


def test_replay_with_episode_ends_matches_reference_step_by_step(pol, seq):
    """``sequence`` over 6 steps, some agents' episodes ending after step
    1 and others after step 3 (mid-chunk), against the reference's
    forward stepped one step at a time with the state cleared after each
    end."""
    nobs, rnn = seq
    n = nobs["self_data"].shape[1]
    ends = torch.zeros(6, n)
    ends[1, :3] = 1.0
    ends[3, 2:5] = 1.0
    params = params_of(pol)
    with torch.no_grad():
        d, v = pol.actor_critic.sequence(rnn, ends, nobs, train=False)
        r = ref.ActorCritic(P)
        for p in range(P):
            one = {k: x[p:p + 1] for k, x in params.items()}
            state = rnn
            for t in range(6):
                dt, vt, new = functional_call(
                    r, one, (state, {k: x[t] for k, x in nobs.items()}))
                new = tuple(tuple(x[0] for x in e) for e in new)
                state = r.clear_recurrent_state(new, ends[t])
                assert rel(d.logits[p, t], dt.logits[0]) <= FORWARD
                assert rel(v["value"][p, t], vt["value"][0]) <= FORWARD


def minibatch(nobs, rnn, c=2, t=3, seed=5):
    """A PPO minibatch ``[C, T, M, ..]`` of the 6 steps' observations
    (split into 2 chunks of 3), with an episode end inside a chunk."""
    g = torch.Generator().manual_seed(seed)
    m = nobs["self_data"].shape[1]
    obs = {k: v.reshape(c, t, *v.shape[1:]) for k, v in nobs.items()}
    dones = torch.zeros(c, t, m)
    dones[0, 1, :3] = 1.0
    return {
        "obs": obs,
        "actions": torch.stack([torch.randint(0, b, (c, t, m), generator=g)
                                for b in BUCKETS], -1).to(torch.int32),
        "log_probs": -2.0 + 0.1 * torch.randn(c, t, m, generator=g),
        "values": torch.randn(c, t, m, generator=g),
        "dones": dones,
        "assignments": torch.randint(0, P, (c, t, m), generator=g),
        "advantages": torch.randn(c, t, m, generator=g),
        "returns": torch.randn(c, t, m, generator=g),
        "rnn_start": tuple(tuple(x.expand(c, 1, m, 256).clone() for x in e)
                           for e in rnn),
    }


def test_loss_and_gradients_match_plain_reference(pol, seq):
    """The port's PPO loss (plain value head on normalized returns) of
    both policies over one minibatch, through the program's policy and
    through the reference: each loss term, and every leaf's gradient."""
    nobs, rnn = seq
    mb = minibatch(nobs, rnn)
    norm = pol.obs_preprocess
    stats = norm.init_state({k: v[0, 0] for k, v in mb["obs"].items()})
    value_stats = {"mu": torch.tensor([0.1, -0.2, 0.0, 0.0]),
                   "sigma": torch.tensor([1.5, 0.7, 1.0, 1.0])}
    cfg = tcfg.TrainConfig(num_worlds=W, num_agents_per_world=4,
                           num_updates=1,
                           actions=tcfg.ActionsConfig(BUCKETS),
                           dreamer_v3_critic=False)
    ref_pol = Policy(actor_critic=ref.ActorCritic(P), obs_preprocess=norm)
    out = []
    for policy in (pol, ref_pol):
        leaves = {k: v.clone().requires_grad_() for k, v in
                  params_of(pol).items()}
        a_l, v_l, ent, *_ = _policy_loss(cfg, policy, leaves, stats,
                                         value_stats, mb, torch.arange(P))
        total = (a_l + v_l - 0.01 * ent).sum()
        grads = torch.autograd.grad(total, list(leaves.values()))
        out.append((torch.stack([a_l, v_l, ent]), dict(zip(leaves, grads))))
    (got, g_got), (want, g_want) = out
    assert rel(got.detach(), want.detach()) <= LOSS
    top = max(float(g.abs().max()) for g in g_want.values())
    for k, g in g_want.items():
        scale = max(float(g.abs().max()), 1e-3 * top)
        assert float((g_got[k] - g).abs().max()) / scale <= LOSS, k


def test_pool_is_tensorflows_same_not_symmetric():
    """A hand-built 4x4 input whose largest value sits at row and column
    2: TF SAME windows (rows and columns 2i .. 2i + 2, -inf past the end)
    all hold it; PyTorch's symmetric ``padding=1`` shifts every window up
    and left by one, so only the last holds it."""
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0],
                      [5.0, 6.0, 7.0, 8.0],
                      [9.0, 10.0, 99.0, 12.0],
                      [13.0, 14.0, 15.0, 16.0]])[None, None]
    want = torch.full((1, 1, 2, 2), 99.0)
    assert torch.equal(max_pool_same(x), want)
    assert torch.equal(ref.pool_same(x), want)
    sym = torch.nn.functional.max_pool2d(x, 3, 2, padding=1)
    assert torch.equal(sym, torch.tensor([[6.0, 8.0], [14.0, 99.0]])[None,
                                                                     None])
    y = torch.randn(3, 16, 64, 64, generator=torch.Generator().manual_seed(3))
    for _ in range(3):
        assert torch.equal(max_pool_same(y), ref.pool_same(y))
        y = y[..., ::2, ::2].contiguous()


def test_conv_is_same_padded_per_policy():
    """``Conv2d(x, p)`` is ``F.conv2d`` with policy p's kernel and bias and
    one zero row and column on every side."""
    conv = Conv2d(2, 4, 16)
    init_params(conv, prng.split(prng.key(1), 2))
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.rand(3, 4, 8, 8)
    for p in range(2):
        want = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x, (1, 1, 1, 1)), conv.kernel[p],
            conv.bias[p])
        torch.testing.assert_close(conv(x, p), want, rtol=0, atol=1e-6)


def test_conv_computes_float32_without_tf32(monkeypatch):
    """A float32 ``Conv2d`` runs its forward and its backward with cuDNN's
    TF32 off, though the process allows it (PyTorch's default), and leaves
    the setting as it found it; its gradients are ``F.conv2d``'s."""
    seen = []
    conv2d, backward = (torch.nn.functional.conv2d,
                        torch.ops.aten.convolution_backward)

    def spy(fn, tag):
        def call(*a, **k):
            seen.append((tag, torch.backends.cudnn.allow_tf32))
            return fn(*a, **k)
        return call
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(conv2d, "fwd"))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        spy(backward, "bwd"))
    conv = Conv2d(2, 4, 16)
    init_params(conv, prng.split(prng.key(1), 2))
    x = torch.rand(3, 4, 8, 8, requires_grad=True)
    conv(x, 1).square().sum().backward()
    assert seen == [("fwd", False), ("bwd", False)]
    assert torch.backends.cudnn.allow_tf32
    got = (x.grad, conv.kernel.grad[1], conv.bias.grad[1])
    assert not bool(conv.kernel.grad[0].any())
    x2 = x.detach().clone().requires_grad_()
    k2 = conv.kernel[1].detach().clone().requires_grad_()
    b2 = conv.bias[1].detach().clone().requires_grad_()
    conv2d(x2, k2, b2, padding=1).square().sum().backward()
    for a, b in zip(got, (x2.grad, k2.grad, b2.grad)):
        assert torch.equal(a, b)


def test_env_frames_are_the_plain_renderers(env_steps):
    """The env's image leaf (``PackedEnv`` with ``render_frames``, the CPU
    path of K5's frames mode) on each state against the plain renderer's
    images in the reference layout (``to_reference_layout`` of the packed
    mode's CPU output, and the renderer's own): RGB / 255 and depth / 200
    exactly; the buffer is the env's one frame buffer, reused."""
    for ps, obs in env_steps[::3]:
        rgba, depth = ops_rgbd.render_rgbd_packed_fast(ENV, ps)
        rgb_r, d_r = ops_rgbd.to_reference_layout(ENV, rgba, depth)
        rgb_p, d_p = plain_rgbd.render_rgbd_packed(ENV, ps, 64, 64)
        assert torch.equal(rgb_r, rgb_p) and torch.equal(d_r, d_p)
        frames = obs["rgbd"]
        assert frames.shape == (W, 4, 4, 64, 64)
        assert torch.equal(frames, ops_rgbd.to_frames(rgb_r, d_r, 200.0))
        assert torch.equal(torch.round(frames[:, :, :3] * 255.0).to(
            torch.uint8), rgb_p[..., :3].permute(0, 1, 4, 2, 3))
        torch.testing.assert_close(frames[:, :, 3] * 200.0, d_p[..., 0],
                                   rtol=1e-6, atol=0)
    env = PackedEnv(ENV, device="cpu")
    ps, r0 = env.init()
    _, r1 = env.step(ps, torch.zeros((4, 5, W), dtype=torch.int32))
    assert r1.obs["rgbd"] is r0.obs["rgbd"]


def test_rollout_records_frames_and_core_inputs(pol):
    """A rollout across an episode end (episodes of 5 steps): the
    buffer's frames are the frames each step's forward read (the env's
    buffer copied each step, not viewed), ``prev_action`` the one-hot of
    the step before's actions and ``prev_reward`` its clipped reward,
    both zero on the step after an end; the carried state's frame is its
    own."""
    args = train_cli.parse_args([
        "--ckpt-dir", "unused", "--tb-dir", "unused", "--run-name", "r",
        "--num-worlds", str(W), "--num-updates", "1",
        "--steps-per-update", "8", "--num-bptt-chunks", "2",
        "--pbt-ensemble-size", "2", "--pbt-past-policies", "2",
        "--num-hiders", "2", "--num-seekers", "2",
        "--backbone", "impala_cnn", "--device", "cpu"])
    env, cfg, policy = train_cli.build(args)
    env = PackedEnv(env.cfg.replace(episode_len=5), device="cpu")
    mgr = init_training("cpu", cfg, env, policy)
    st = mgr.state
    assert st.rollout.obs["rgbd"] is not env._frames
    seen = []
    orig = env.step

    def step(ps, actions, *a, **k):
        seen.append(st.rollout.obs["rgbd"].clone() if not seen else None)
        return orig(ps, actions, *a, **k)
    env.step = step
    ro, buf, metrics = collect_rollout(cfg, env, policy, mgr.all_params(),
                                       st.obs_stats, st.rollout,
                                       st.value_stats)
    obs = {k: v.flatten(0, 1) for k, v in buf.obs.items()}
    acts = buf.actions.flatten(0, 1)
    dones = buf.dones.flatten(0, 1)
    rewards = buf.rewards.flatten(0, 1)
    assert torch.equal(obs["rgbd"][0], seen[0])
    assert bool(dones[4].all()) and not bool(dones[:4].any())
    for t in range(1, 8):
        keep = (~dones[t - 1]).float()[:, None]
        onehot = torch.cat([torch.nn.functional.one_hot(acts[t - 1, :, i], b)
                            for i, b in enumerate(BUCKETS)], -1).float()
        assert torch.equal(obs["prev_action"][t], onehot * keep)
        assert torch.equal(obs["prev_reward"][t],
                           rewards[t - 1].clamp(-1, 1)[:, None] * keep)
    assert not bool(obs["prev_action"][5].any())
    assert not torch.equal(obs["rgbd"][1], obs["rgbd"][2])
    assert torch.equal(ro.obs["rgbd"], env._frames.flatten(0, 1))
    assert ro.obs["rgbd"].data_ptr() != env._frames.data_ptr()
    # eval_elo's pass (record_frames=False): the same rollout, its metrics
    # unchanged, with no frame buffer and no frames in its buffer.
    env.step = orig
    _, buf2, metrics2 = collect_rollout(
        cfg, env, policy, mgr.all_params(), st.obs_stats, st.rollout,
        st.value_stats, record_frames=False)
    assert "rgbd" not in buf2.obs and torch.equal(buf2.actions, buf.actions)
    assert metrics2.keys() == metrics.keys()
    for k, v in metrics.items():
        assert torch.equal(metrics2[k], v), k


def test_train_and_infer_clis_run_impala_cnn(tmp_path, capsys,
                                             monkeypatch):
    """``--backbone impala_cnn`` through the train CLI's ``build`` (frames
    rendered, the flagship's buckets and movement, the plain critic) for
    one tiny ``update_iter`` at 2 worlds, and its checkpoint through
    ``infer.main``."""
    args = train_cli.parse_args([
        "--ckpt-dir", str(tmp_path), "--tb-dir", str(tmp_path),
        "--run-name", "r", "--num-worlds", str(W), "--num-updates", "1",
        "--steps-per-update", "4", "--num-bptt-chunks", "2",
        "--pbt-ensemble-size", "2", "--pbt-past-policies", "2",
        "--num-hiders", "2", "--num-seekers", "2",
        "--backbone", "impala_cnn", "--device", "cpu"])
    env, cfg, policy = train_cli.build(args)
    assert env.cfg.render_frames and env.cfg.zero_agent_velocity
    assert cfg.actions.actions_num_buckets == BUCKETS
    assert not cfg.dreamer_v3_critic and policy.core_inputs
    assert isinstance(policy.actor_critic.critic, DenseLayerCritic)
    net = policy.actor_critic.backbone.encoder.net
    mgr = init_training("cpu", cfg, env, policy)
    before = {k: v.clone() for k, v in mgr.state.params.items()}
    rendered, frames0 = [], net.torso_frames
    render = ops_rgbd.render_rgbd_frames

    def counted(cfg_env, ps, *a, **k):
        rendered.append(ps.step.shape[-1] * cfg_env.max_agents)
        return render(cfg_env, ps, *a, **k)
    monkeypatch.setattr(ops_rgbd, "render_rgbd_frames", counted)
    mgr = mgr.update_iter()
    st = mgr.state
    assert all(bool(torch.isfinite(v).all()) for v in st.params.values())
    assert any(not torch.equal(before[k], v) for k, v in st.params.items())
    assert rendered == [W * 4] * 4
    assert net.torso_frames > frames0
    path = tmp_path / "impala.pt"
    bridge.save_policy_checkpoint(path, st.params, st.obs_stats,
                                  st.elo[:2].tolist())
    assert infer.main(["--ckpt-path", str(path), "--num-worlds", "2",
                       "--num-hiders", "2", "--num-seekers", "2",
                       "--num-steps", "3", "--backbone", "impala_cnn",
                       "--device", "cpu"]) == 0
    assert "total wins by team slot" in capsys.readouterr().out


def test_other_backbones_render_nothing():
    for backbone in ("pooled", "openai_hns"):
        assert not tpolicy.backbone_recipe(backbone).frames
        assert not tpolicy.make_policy(backbone=backbone,
                                       device="cpu").core_inputs


def test_reference_is_torch_alone_and_the_benchmark_holds_a_copy():
    src = ROOT / "plainref" / "impala_cnn.py"
    assert src.read_bytes() == (ROOT / "portbench" / "reference" /
                                "impala_cnn.py").read_bytes()
    mods = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert mods == {"__future__", "torch"}


def test_benchmark_counts_match_the_programs_products(monkeypatch):
    """``portbench/counts/impala_cnn.py`` from the configuration's widths
    against the multiply-adds of the program's own convolutions and dense
    products for one frame of one policy."""
    import math

    from marl_hideandseek_torch.models import layers
    from portbench.counts import impala_cnn as counts

    conf = json.loads((ROOT / "portbench" / "configs" /
                       "impala_cnn_2v2.json").read_text())["policy"]
    macs = {"conv": 0, "dense": 0}
    conv, dense = layers.Conv2d.forward, layers.Dense.forward

    def conv_counted(self, x, p):
        y = conv(self, x, p)
        macs["conv"] += y.numel() * self.kernel[0].numel() // y.shape[1]
        return y

    def dense_counted(self, x, add=None):
        y = dense(self, x, add)
        rows = y.numel() // y.shape[0] // math.prod(self.out_shape)
        macs["dense"] += rows * math.prod(self.in_shape) * math.prod(
            self.out_shape)
        return y
    monkeypatch.setattr(layers.Conv2d, "forward", conv_counted)
    monkeypatch.setattr(layers.Dense, "forward", dense_counted)
    pol = tpolicy.make_policy(backbone="impala_cnn", device="cpu")
    env = PackedEnv(ENV.replace(num_worlds=1), device="cpu")
    obs = {k: v[:, :1].flatten(0, 1) for k, v in
           pol.obs_preprocess.prep(env.init()[1].obs).items()}
    obs["prev_action"] = torch.zeros(1, sum(BUCKETS))
    obs["prev_reward"] = torch.zeros(1, 1)
    ac = pol.actor_critic
    with torch.no_grad():
        ac(ac.init_recurrent_state(1), obs)
    dense_macs = 2048 * 256
    assert macs["conv"] + dense_macs == counts.torso_macs(conf)
    assert macs["dense"] - dense_macs == counts.core_macs(conf)
    assert counts.torso_macs(conf) == 31_195_136

"""PyTorch port: the ``openai_hns`` policy (Baker et al. 2019's masked
residual entity self-attention, circular lidar convolution and
omniscient critic; ``policy.OpenAIHnsNet``) on the CPU, at a few worlds.

The program against the plain reference (``plainref/openai_hns.py``: plain
loops in float32, nothing of the port) on seeded random weights with
every constant leaf moved, 2 policies, on the packed env's 3v3
observations with random visibility, rows that see only themselves, and
levels whose box slots are partly empty. Tolerances: the forward within
1e-5 of the reference's largest magnitude (float32 summed in other
orders: the batched products against the reference's loops; TF32 would
move it ~1e-3); the PPO loss and its gradients within 1e-4 (the backward
sums longer chains of those roundings; per leaf over its largest
gradient, or a thousandth of the largest leaf's where that is larger).
"""

import ast
import dataclasses
import math
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
    CircularConv1d,
    DenseLayerCritic,
    SelfAttention,
    init_params,
)
from marl_hideandseek_torch.train import __main__ as train_cli
from marl_hideandseek_torch.train import cfg as tcfg
from marl_hideandseek_torch.train import init_training
from marl_hideandseek_torch.train.ppo import _policy_loss
from marl_hideandseek_torch.train.rollout import MethodCall
from plainref import openai_hns as ref

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORWARD = 1e-5
LOSS = 1e-4
P = 2
W = 4
ENV = EnvConfig(num_worlds=W, min_hiders=3, max_hiders=3, min_seekers=3,
                max_seekers=3, sim_flags=SimFlags.RandomFlipTeams,
                rand_seed=11)
VIS = ("vis_agents_mask", "vis_boxes_mask", "vis_ramps_mask")


def rel(got, want) -> float:
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def random_actions(g, w=W):
    return torch.cat([torch.randint(0, 11, (6, 3, w), generator=g),
                      torch.randint(0, 2, (6, 2, w), generator=g)],
                     1).to(torch.int32)


@pytest.fixture(scope="module")
def pol():
    """Two policies, every zero or one leaf moved by seeded noise."""
    pol = tpolicy.make_policy(backbone="openai_hns", num_policies=P,
                              device="cpu", key=prng.key(4))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for v in pol.actor_critic.parameters():
            if bool((v == 0).all()) or bool((v == 1).all()):
                v.add_(0.05 * torch.randn(v.shape, generator=g))
    return pol


@pytest.fixture(scope="module")
def env_obs():
    """(states, prepped observations [W * 6, F]) after 0 and 6 steps of
    random force actions, and normalizer statistics from them."""
    env = PackedEnv(ENV, device="cpu")
    ps, res = env.init()
    g = torch.Generator().manual_seed(1)
    out = [(ps, res.obs)]
    for _ in range(6):
        ps, res = env.step(ps, random_actions(g))
    out.append((ps, res.obs))
    return out


def flat_obs(pol, obs):
    return {k: v.flatten(0, 1) for k, v in pol.obs_preprocess.prep(obs).items()}


@pytest.fixture(scope="module")
def inputs(pol, env_obs):
    """Normalized observations of 24 agents, the first four seeing only
    themselves, and random recurrent states."""
    norm = pol.obs_preprocess
    obs = flat_obs(pol, env_obs[1][1])
    stats = norm.update_state(norm.init_state(obs), obs)
    for k in VIS:
        obs[k][:4] = 0.0
    nobs = norm.normalize(stats, obs)
    g = torch.Generator().manual_seed(2)
    n = nobs["self_data"].shape[0]
    rnn = tuple(tuple(0.5 * torch.randn(1, n, 256, generator=g)
                      for _ in range(2)) for _ in range(2))
    return nobs, rnn


def params_of(pol):
    return {k: v.detach() for k, v in pol.actor_critic.named_parameters()}


def reference(n=P):
    return ref.ActorCritic(n, "cpu")


def test_parameter_tree_is_the_references():
    """Names and shapes as the reference takes them; each leaf drawn from
    flax's key for its path with the initialiser the reference lists."""
    pol = tpolicy.make_policy(backbone="openai_hns", device="cpu")
    got = {k: tuple(v.shape[1:]) for k, v in
           pol.actor_critic.named_parameters()}
    assert got == {k: s for k, (s, _, _) in ref.PARAMS.items()}
    for k, v in pol.actor_critic.named_parameters():
        init = ref.PARAMS[k][2]
        if init in ("zeros", "ones"):
            assert bool((v == (init == "ones")).all()), k
        else:
            q = v[0].reshape(math.prod(v.shape[1:1 + ref.PARAMS[k][1]]), -1)
            small = q if q.shape[0] >= q.shape[1] else q.T
            gram = small.T @ small / init[1] ** 2
            torch.testing.assert_close(gram, torch.eye(gram.shape[0]),
                                       atol=1e-5, rtol=0)


def test_forward_matches_plain_reference(pol, inputs):
    nobs, rnn = inputs
    params = params_of(pol)
    with torch.no_grad():
        got = pol.actor_critic(rnn, nobs)
        want = functional_call(reference(), params, (rnn, nobs), strict=True)
        got_act = pol.actor_critic.act(rnn, nobs)
        want_act = functional_call(
            MethodCall(reference(), "act"),
            {f"ac.{k}": v for k, v in params.items()}, (rnn, nobs),
            strict=True)
    assert rel(got[0].logits, want[0].logits) <= FORWARD
    assert rel(got[1]["value"], want[1]["value"]) <= FORWARD
    for a, b in zip([x for e in got[2] for x in e] +
                    [x for e in got_act[1] for x in e],
                    [x for e in want[2] for x in e] +
                    [x for e in want_act[1] for x in e]):
        assert a.shape == b.shape and rel(a, b) <= FORWARD
    assert torch.equal(got_act[0].logits, got[0].logits)
    assert rel(want_act[0].logits, want[0].logits) == 0.0


def minibatch(nobs, rnn, c=2, t=3, seed=5):
    """A PPO minibatch ``[C, T, M, ..]`` of the first 8 agents'
    observations, moved a little each step, with an episode end."""
    g = torch.Generator().manual_seed(seed)
    m = 8
    obs = {}
    for k, v in nobs.items():
        x = v[:m].expand(c, t, m, v.shape[-1]).clone()
        if k not in VIS and k not in ("prep_counter", "self_type"):
            x = x + 0.1 * torch.randn(x.shape, generator=g) * (x != 0)
        obs[k] = x
    dones = torch.zeros(c, t, m)
    dones[0, 1, :3] = 1.0
    buckets = tpolicy.FORCE_ACTION_BUCKETS
    return {
        "obs": obs,
        "actions": torch.stack([torch.randint(0, b, (c, t, m), generator=g)
                                for b in buckets], -1).to(torch.int32),
        "log_probs": -2.0 + 0.1 * torch.randn(c, t, m, generator=g),
        "values": torch.randn(c, t, m, generator=g),
        "dones": dones,
        "assignments": torch.randint(0, P, (c, t, m), generator=g),
        "advantages": torch.randn(c, t, m, generator=g),
        "returns": torch.randn(c, t, m, generator=g),
        "rnn_start": tuple(tuple(x[:, :m].expand(c, 1, m, 256).clone()
                                 for x in e) for e in rnn),
    }


def train_cfg():
    return tcfg.TrainConfig(
        num_worlds=W, num_agents_per_world=6, num_updates=1,
        actions=tcfg.ActionsConfig(tpolicy.FORCE_ACTION_BUCKETS),
        dreamer_v3_critic=False)


def test_loss_and_gradients_match_plain_reference(pol, inputs):
    """The port's PPO loss (plain value head on normalized returns) of
    both policies over one minibatch, through the program's policy and
    through the reference: each loss term, and every leaf's gradient."""
    nobs, rnn = inputs
    mb = minibatch(nobs, rnn)
    ident = dataclasses.replace(pol.obs_preprocess, entity_rows={})
    stats = ident.init_state({k: v[0, 0] for k, v in mb["obs"].items()})
    value_stats = {"mu": torch.tensor([0.1, -0.2, 0.0, 0.0]),
                   "sigma": torch.tensor([1.5, 0.7, 1.0, 1.0])}
    ref_pol = Policy(actor_critic=reference(),
                     obs_preprocess=ref.EntityRowNormalizer(ident))
    out = []
    for policy in (pol, ref_pol):
        leaves = {k: v.clone().requires_grad_() for k, v in
                  params_of(pol).items()}
        a_l, v_l, ent, *_ = _policy_loss(
            train_cfg(), policy, leaves, stats, value_stats, mb,
            torch.arange(P))
        total = (a_l + v_l - 0.01 * ent).sum()
        grads = torch.autograd.grad(total, list(leaves.values()))
        out.append((torch.stack([a_l, v_l, ent]), dict(zip(leaves, grads))))
    (got, g_got), (want, g_want) = out
    assert rel(got.detach(), want.detach()) <= LOSS
    # Per leaf over the larger of its largest gradient and a thousandth of
    # the largest of any leaf: the key biases' true gradient is 0 (the
    # softmax ignores them), so theirs hold rounding alone on both sides.
    top = max(float(g.abs().max()) for g in g_want.values())
    for k, g in g_want.items():
        scale = max(float(g.abs().max()), 1e-3 * top)
        assert float((g_got[k] - g).abs().max()) / scale <= LOSS, k


def test_sequence_equals_step_by_step(pol, inputs):
    """``sequence`` over 3 steps with an episode end equals 3 forwards
    with the state cleared after the end (the net runs over 3 x N rows at
    once against N a step: within float32 rounding)."""
    nobs, rnn = inputs
    mb = minibatch(nobs, rnn, c=1)
    obs = {k: v[0] for k, v in mb["obs"].items()}
    start = tuple(tuple(x[0] for x in e) for e in mb["rnn_start"])
    ac = pol.actor_critic
    params = params_of(pol)
    with torch.no_grad():
        seq_d, seq_v = ac.sequence(start, mb["dones"][0], obs, train=False)
        for p in range(P):
            one = {k: v[p:p + 1] for k, v in params.items()}
            state = start
            for t in range(3):
                d, v, new = functional_call(
                    ac, one, (state, {k: x[t] for k, x in obs.items()}))
                new = tuple(tuple(x[0] for x in e) for e in new)
                state = ac.clear_recurrent_state(new, mb["dones"][0, t])
                assert rel(d.logits[0], seq_d.logits[p, t]) <= 1e-6
                assert rel(v["value"][0], seq_v["value"][p, t]) <= 1e-6


def test_actor_ignores_invisible_entities_critic_does_not(pol, inputs):
    nobs, rnn = inputs
    moved = dict(nobs)
    n = nobs["box_data"].shape[0]
    hidden = (nobs["vis_boxes_mask"] == 0) & (
        nobs["box_data"].reshape(n, 9, 17) != 0).any(-1)
    assert bool(hidden.any())
    boxes = nobs["box_data"].reshape(n, 9, 17).clone()
    boxes[hidden] += 0.5
    moved["box_data"] = boxes.reshape(n, -1)
    with torch.no_grad():
        d0, v0, _ = pol.actor_critic(rnn, nobs)
        d1, v1, _ = pol.actor_critic(rnn, moved)
    assert torch.equal(d0.logits, d1.logits)
    changed = hidden.any(-1)
    assert bool((v0["value"][:, changed] != v1["value"][:, changed]).all())


def attention_masks(pol, obs):
    """The key masks the actor's and the critic's attention blocks get."""
    masks = {}
    hooks = []
    for view in ("actor", "critic"):
        blk = getattr(pol.actor_critic.backbone, f"{view}_encoder").net.attn
        hooks.append(blk.register_forward_pre_hook(
            lambda m, args, view=view: masks.__setitem__(view, args[1])))
    n = obs["self_data"].shape[0]
    rnn = pol.actor_critic.init_recurrent_state(n)
    try:
        with torch.no_grad():
            pol.actor_critic(rnn, obs)
    finally:
        for h in hooks:
            h.remove()
    return masks["actor"][0], masks["critic"][0]


def test_critic_attends_to_the_entities_that_exist(pol, env_obs):
    """On env states: the critic's keys are the self token, the 5 other
    agents and the box and ramp slots below the level's counts, through
    normalization with moved statistics; the actor's the self token and
    what the agent sees."""
    norm = pol.obs_preprocess
    seen_empty = False
    for ps, raw in env_obs:
        obs = flat_obs(pol, raw)
        stats = norm.update_state(norm.init_state(obs), obs)
        for k in stats.mean:
            stats.mean[k] += 0.3
        nobs = norm.normalize(stats, obs)
        actor, critic = attention_masks(pol, nobs)
        boxes = torch.arange(9)[None] < ps.num_active_boxes[:, None]
        ramps = torch.arange(2)[None] < ps.num_active_ramps[:, None]
        want = torch.cat([torch.ones(W, 6, 6, dtype=torch.bool),
                          boxes[:, None].expand(W, 6, 9),
                          ramps[:, None].expand(W, 6, 2)], -1).flatten(0, 1)
        assert torch.equal(critic, want)
        vis = torch.cat([nobs[k] for k in VIS], -1) != 0
        assert torch.equal(actor[:, 1:], vis) and bool(actor[:, 0].all())
        assert not bool((vis & ~want[:, 1:]).any())
        seen_empty |= bool((~boxes).any())
    assert seen_empty


def test_masked_attention_and_circular_conv():
    """An all-true key mask is no mask, bit for bit; a masked key moves
    nothing; the convolution wraps around like ``F.conv1d`` on a
    circularly padded input."""
    attn = SelfAttention(1, 8, 2, 8, 8)
    init_params(attn, prng.split(prng.key(0), 1))
    x = torch.randn(1, 3, 5, 8, generator=torch.Generator().manual_seed(0))
    ones = torch.ones(1, 3, 5, dtype=torch.bool)
    assert torch.equal(attn(x), attn(x, ones))
    mask = ones.clone()
    mask[..., 3] = False
    y = x.clone()
    y[..., 3, :] += 1.0
    a, b = attn(x, mask), attn(y, mask)
    keep = torch.arange(5) != 3
    torch.testing.assert_close(a[..., keep, :], b[..., keep, :], rtol=0,
                               atol=1e-6)
    conv = CircularConv1d(1, 1, 9, 3)
    init_params(conv, prng.split(prng.key(1), 1))
    with torch.no_grad():
        conv.bias.normal_()
    lidar = torch.rand(4, 30)
    got = conv(lidar[None, :, :, None])[0]                    # [4, 30, 9]
    padded = torch.cat([lidar[:, -1:], lidar, lidar[:, :1]], -1)[:, None]
    want = torch.nn.functional.conv1d(
        padded, conv.kernel[0, :, 0].T[:, None, :], conv.bias[0])
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=1e-6)


def test_train_and_infer_clis_run_openai_hns(tmp_path, capsys):
    """``--backbone openai_hns`` through the train CLI's ``build`` (force
    movement, its heads, the plain critic) for one tiny ``update_iter``,
    and its checkpoint through ``infer.main``."""
    args = train_cli.parse_args([
        "--ckpt-dir", str(tmp_path), "--tb-dir", str(tmp_path),
        "--run-name", "r", "--num-worlds", "2", "--num-updates", "1",
        "--steps-per-update", "4", "--num-bptt-chunks", "2",
        "--pbt-ensemble-size", "2", "--pbt-past-policies", "2",
        "--backbone", "openai_hns", "--device", "cpu"])
    env, cfg, policy = train_cli.build(args)
    assert not env.cfg.zero_agent_velocity
    assert cfg.actions.actions_num_buckets == (11, 11, 11, 2, 2)
    assert not cfg.dreamer_v3_critic
    assert isinstance(policy.actor_critic.critic, DenseLayerCritic)
    mgr = init_training("cpu", cfg, env, policy)
    before = {k: v.clone() for k, v in mgr.state.params.items()}
    mgr = mgr.update_iter()
    st = mgr.state
    assert all(bool(torch.isfinite(v).all()) for v in st.params.values())
    assert any(not torch.equal(before[k], v) for k, v in st.params.items())
    assert not torch.equal(st.value_stats["sigma"][:2], torch.ones(2))
    path = tmp_path / "hns.pt"
    bridge.save_policy_checkpoint(path, st.params, st.obs_stats,
                                  st.elo[:2].tolist())
    assert infer.main(["--ckpt-path", str(path), "--num-worlds", "2",
                       "--num-steps", "3", "--backbone", "openai_hns",
                       "--device", "cpu"]) == 0
    assert "total wins by team slot" in capsys.readouterr().out


def test_reference_is_torch_alone_and_the_benchmark_holds_a_copy():
    src = ROOT / "plainref" / "openai_hns.py"
    assert src.read_bytes() == (ROOT / "portbench" / "reference" /
                                "openai_hns.py").read_bytes()
    mods = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert mods == {"__future__", "math", "torch"}


def test_benchmark_counts_match_the_programs_products(monkeypatch):
    """``portbench/counts/openai_hns.py`` from the configuration's widths
    against the multiply-adds of the program's own dense products (and
    the attention's two score products) for one agent, one policy."""
    import json

    from marl_hideandseek_torch.models import layers
    from portbench.counts import openai_hns as counts

    conf = json.loads((ROOT / "portbench" / "configs" /
                       "openai_hns_3v3.json").read_text())["policy"]
    macs = {"n": 0}
    dense = layers.Dense.forward

    def counted(self, x, add=None):
        y = dense(self, x, add)
        rows = y.numel() // y.shape[0] // math.prod(self.out_shape)
        macs["n"] += rows * math.prod(self.in_shape) * math.prod(
            self.out_shape)
        return y
    monkeypatch.setattr(layers.Dense, "forward", counted)
    pol = tpolicy.make_policy(backbone="openai_hns", device="cpu")
    env = PackedEnv(ENV.replace(num_worlds=1), device="cpu")
    obs = {k: v[:, :1].flatten(0, 1) for k, v in
           pol.obs_preprocess.prep(env.init()[1].obs).items()}
    ac = pol.actor_critic
    with torch.no_grad():
        ac(ac.init_recurrent_state(1), obs)
    t, c = counts.tokens(conf), conf["embed_dim"]
    scores = 2 * t * t * c                      # q.k and p.v, every head
    assert macs["n"] + 2 * scores == (counts.actor_macs(conf) +
                                      counts.critic_macs(conf))
    assert counts.attn_macs(conf) == 1_188_096
    assert counts.encoder_macs(conf) == 1_814_570

"""The needed-FLOP counter against the multiply-adds of the dense
products that one policy's forward runs, counted by hooks; the frozen
kernel counts on a small state. CPU only."""

import math

import torch

from portbench import core
from portbench.counts import kernel_ops, policy_flops

CONF = core.load_json(core.PKG / "configs" / "flagship_2v2.json")


def hooked_macs(policy, fn) -> int:
    from marl_hideandseek_torch.models.layers import Dense

    total = [0]

    def hook(mod, args, out):
        n_in = math.prod(mod.in_shape)
        rows = args[0].numel() // (args[0].shape[0] * n_in)
        total[0] += (mod.kernel.shape[0] * rows * n_in *
                     math.prod(mod.out_shape))

    hs = [m.register_forward_hook(hook) for m in policy.modules()
          if isinstance(m, Dense)]
    try:
        fn()
    finally:
        for h in hs:
            h.remove()
    return total[0]


def test_forward_flops_match_hooked_count():
    from marl_hideandseek_torch.config import EnvConfig
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.policy import make_policy

    env = PackedEnv(EnvConfig(num_worlds=2), device="cpu")
    policy = make_policy(device="cpu")
    norm, ac = policy.obs_preprocess, policy.actor_critic
    obs = {k: v.flatten(0, 1) for k, v in norm.prep(env.init()[1].obs).items()}
    n = next(iter(obs.values())).shape[0]
    rnn = ac.init_recurrent_state(n)
    with torch.no_grad():
        macs = hooked_macs(ac, lambda: ac(rnn, obs))
    assert 2 * macs == policy_flops.forward_flops(CONF["policy"], n)
    with torch.no_grad():
        actor = hooked_macs(ac, lambda: ac.act(rnn, obs))
    assert 2 * actor == policy_flops.forward_flops(CONF["policy"], 0, n)


def test_kernel_counts_on_a_small_state():
    from portbench.reference.frozen.config import EnvConfig
    from portbench.reference.frozen.env.packed import PackedEnv
    from portbench.reference.frozen.ops import step

    cfg = EnvConfig(num_worlds=2)
    env = PackedEnv(cfg, device="cpu")
    ps, _ = env.init()
    acts = torch.zeros((cfg.max_agents, 5, 2), dtype=torch.int32)
    tally = {}
    step.megastep_plain(cfg, ps, acts, tally)
    ops = kernel_ops.megastep_ops(cfg, ps, tally)
    assert ops > kernel_ops.sweep_ops(cfg, ps) > 0
    n_bytes = kernel_ops.megastep_bytes(cfg, ps, 8)
    assert n_bytes > sum(t.numel() * t.element_size() for t in ps.leaves())
    depth = torch.tensor([[[0.0, 1.0]]])
    assert kernel_ops.rgbd_least_ops(depth) == (
        2 * kernel_ops.OPS_PIXEL_RAY + kernel_ops.OPS_PIXEL_SHADE +
        kernel_ops.OPS_RAY_PLANE)

"""The frozen reference (``portbench/reference/frozen``) against the
port's plain versions at a tiny size on the CPU: equal to the bit while
the port's plain code is what was frozen; a later change to the port
shows here as drift (a reason to look, not to edit the frozen copy).
CPU only."""

import dataclasses

import torch

from portbench.drivers import common

CONF_ENV = {"num_hiders": 2, "num_seekers": 2, "max_boxes": 9,
            "max_ramps": 2, "max_walls": 36, "episode_len": 8}
FLAGS = ["ZeroAgentVelocity", "RandomFlipTeams"]
SEED = 2 ** 31 + 99


def leaves(tree):
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def same(a, b) -> bool:
    a, b = leaves(a), leaves(b)
    view = lambda x: x.view(torch.int32) if x.dtype == torch.uint32 else x
    return len(a) == len(b) and all(
        torch.equal(view(x), view(y)) for x, y in zip(a, b))


def run_env(pkg):
    mod = common.mod(pkg, "env.packed")
    cfg = common.env_config(pkg, CONF_ENV, FLAGS, 3, SEED)
    env = mod.PackedEnv(cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    ps, res = env.init()
    out = [ps, res.obs]
    for i in range(10):   # across the episode end at step 7
        acts = torch.randint(0, 5, (cfg.max_agents, 5, 3), generator=g)
        acts[:, 3:] %= 2
        ps, res = env.step(ps, acts.to(torch.int32))
        out += [ps, res.obs, res.rewards, res.dones]
    return out


def test_env_steps_and_resets_equal():
    assert same(run_env(common.PROGRAM), run_env(common.FROZEN))


def test_rgbd_plain_renderer_equal():
    from marl_hideandseek_torch.viz import rgbd as port
    from portbench.reference.frozen.viz import rgbd as frozen

    ps = run_env(common.PROGRAM)[-4]
    fps = run_env(common.FROZEN)[-4]
    cfg = common.env_config(common.PROGRAM, CONF_ENV, FLAGS, 3, SEED)
    fcfg = common.env_config(common.FROZEN, CONF_ENV, FLAGS, 3, SEED)
    assert same(port.render_rgbd_packed(cfg, ps, 16, 16),
                frozen.render_rgbd_packed(fcfg, fps, 16, 16))


def test_threefry_equal():
    from marl_hideandseek_torch import prng as port
    from portbench.reference.frozen import prng as frozen

    k = port.key(SEED)
    assert same(port.split(k, 7), frozen.split(frozen.key(SEED), 7))
    assert same(port.gumbel(port.split(k, 3), (50,)),
                frozen.gumbel(frozen.split(frozen.key(SEED), 3), (50,)))


def test_forward_and_ppo_update_equal():
    """One rollout of the port at 2 worlds, then the 4-policy forward and
    the PPO update on it, by the port and by the frozen copy."""
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.train import init_training
    from marl_hideandseek_torch.train import ppo as port_ppo
    from marl_hideandseek_torch.train.rollout import (
        apply_ensemble as port_apply, collect_rollout)
    from portbench import core
    from portbench.reference.frozen.train import ppo as frozen_ppo
    from portbench.reference.frozen.train import rollout as frozen_rollout

    conf = core.load_json(core.PKG / "configs" / "flagship_2v2.json")
    conf["env"]["episode_len"] = 8
    conf["train"]["steps_per_update"] = 8
    conf["train"]["bptt_chunks"] = 2
    cfg = common.env_config(common.PROGRAM, conf["env"],
                            conf["env"]["train_flags"], 2, SEED)
    env = PackedEnv(cfg.replace(num_pbt_policies=2), device="cpu")
    tcfg = common.train_config(common.PROGRAM, conf, 2, SEED)
    fcfg = common.train_config(common.FROZEN, conf, 2, SEED)
    policy = common.make_policy(common.PROGRAM, conf, 1, "cpu")
    fpolicy = common.make_policy(common.FROZEN, conf, 1, "cpu")
    mgr = init_training("cpu", tcfg, env, policy)
    st = mgr.state
    _, buf, _ = collect_rollout(tcfg, env, policy, mgr.all_params(),
                                st.obs_stats, st.rollout, st.value_stats)
    rnn = tuple(tuple(x[0] for x in e) for e in buf.rnn_start_states)
    obs = {k: v[0, 0] for k, v in buf.obs.items()}
    a = buf.assignments[0, 0]
    with torch.no_grad():
        got = port_apply(policy, mgr.all_params(), rnn, obs, a, 4, 2)
        want = frozen_rollout.apply_ensemble(fpolicy, mgr.all_params(), rnn,
                                             obs, a, 4, 2)
    assert same(got, want)
    stats = policy.obs_preprocess.update_state(st.obs_stats, {
        k: v.reshape((-1,) + v.shape[3:]) for k, v in buf.obs.items()})
    fbuf = frozen_rollout.RolloutBuffer(**{
        f.name: getattr(buf, f.name) for f in dataclasses.fields(buf)})
    p1 = port_ppo.ppo_update(tcfg, policy, st.params, st.opt_states, stats,
                             st.value_stats, st.hyper_params, buf, st.key)
    fopt = frozen_ppo.AdamState(mu=st.opt_states.mu, nu=st.opt_states.nu,
                                count=st.opt_states.count)
    p2 = frozen_ppo.ppo_update(fcfg, fpolicy, st.params, fopt, stats,
                               st.value_stats, st.hyper_params, fbuf, st.key)
    assert same(p1[0], p2[0]) and same(p1[1].mu, p2[1].mu)
    assert same(p1[3], p2[3])

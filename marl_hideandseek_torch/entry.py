"""Driver entry points of the port (counterpart of ``__graft_entry__.py``):
a one-card check of the flagship policy's forward and a dry run of the
sharded training update over several ranks.

    from marl_hideandseek_torch.entry import entry, dryrun_multichip
    fn, args = entry()          # fn(*args) on the card
    dryrun_multichip(2)         # 2 ranks, one card each (NCCL)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.models.layers import init_params
from marl_hideandseek_torch.policy import make_policy, resolve_device

ENTRY_AGENTS = 8


def entry(device="cuda"):
    """(fn, (params, rnn_states, obs)): the flagship policy's forward
    (pooled-entity backbone, LSTM, discrete actor, Dreamer critic) in
    float32 on ``device`` for a batch of 8 agents, its parameters drawn as
    flax's ``init`` draws them from ``PRNGKey(1)`` and the observations as
    ``__graft_entry__.py:18-31`` draws them from ``split(PRNGKey(0), 12)``
    (``prng.py``: the same numbers). ``fn`` returns (logits ``[N, L]``,
    value ``[N, 1]``, new recurrent state)."""
    dev = resolve_device(device, "entry")
    policy = make_policy(dtype=torch.float32, device=dev)
    ac = policy.actor_critic
    with torch.no_grad():
        init_params(ac, prng.key(1)[None])
    n = ENTRY_AGENTS
    ks = prng.split(prng.key(0, dev), 12)

    def randint(k, shape, hi):
        return prng.randint(k, shape, 0, hi).to(torch.int32)

    ones = lambda *s: torch.ones(s, device=dev)
    obs = {
        "prep_counter": randint(ks[0], (n, 1), 97),
        "self_data": prng.normal(ks[1], (n, 13)),
        "self_type": randint(ks[2], (n, 1), 2),
        "self_mask": ones(n, 1),
        "self_lidar": prng.uniform(ks[3], (n, 30)),
        "agent_data": prng.normal(ks[4], (n, 5, 14)),
        "box_data": prng.normal(ks[5], (n, 9, 17)),
        "ramp_data": prng.normal(ks[6], (n, 2, 14)),
        "vis_agents_mask": ones(n, 5, 1),
        "vis_boxes_mask": ones(n, 9, 1),
        "vis_ramps_mask": ones(n, 2, 1),
    }
    obs = policy.obs_preprocess.prep(obs)
    rnn0 = ac.init_recurrent_state(n, dev)
    params = {k: v.detach() for k, v in ac.named_parameters()}

    @torch.no_grad()
    def fn(params, rnn_states, obs):
        dists, critic_out, new_rnn = functional_call(
            ac, params, (rnn_states, obs), strict=True)
        return (dists.logits[0], critic_out["value"][0],
                tree_map(lambda x: x[0], new_rnn))

    return fn, (params, rnn0, obs)


def _dryrun(mesh, device) -> dict:
    """One sharded training update and one sharded packed step over
    ``mesh`` at ``__graft_entry__.py:45-80``'s shapes."""
    from marl_hideandseek_torch.config import EnvConfig, SimFlags
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.parallel.mesh import (
        make_sharded_packed_step,
        sharded_packed_init,
    )
    from marl_hideandseek_torch.train import (
        ActionsConfig,
        PPOConfig,
        TrainConfig,
        init_training,
    )

    num_worlds = 2 * mesh.size
    env = PackedEnv(EnvConfig(
        num_worlds=num_worlds,
        min_hiders=1, max_hiders=1, min_seekers=1, max_seekers=1,
        sim_flags=SimFlags.ZeroAgentVelocity | SimFlags.UseFixedWorld,
    ), device=device)
    cfg = TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=2,
        num_updates=1,
        actions=ActionsConfig(actions_num_buckets=(5, 5, 5, 2, 2)),
        steps_per_update=4,
        num_bptt_chunks=2,
        lr=1e-3,
        algo=PPOConfig(num_mini_batches=1, num_epochs=1),
        seed=5,
    )
    policy = make_policy(dtype=torch.float32, device=env.device)
    mgr = init_training(env.device, cfg, env, policy, mesh=mesh)
    mgr = mgr.update_iter()
    if mgr.update_idx != 1:
        raise RuntimeError(f"dry run: update count {mgr.update_idx}")

    ps, _ = sharded_packed_init(env, mesh, prng.key(7, env.device))
    step = make_sharded_packed_step(env, mesh)
    actions = torch.full((env.cfg.max_agents, 5, ps.step.shape[0]), 2,
                         dtype=torch.int32, device=env.device)
    ps2, _ = step(ps, actions)
    if int(ps2.step[0]) != 1:
        raise RuntimeError(f"dry run: packed step counter {int(ps2.step[0])}")
    return {"update_idx": mgr.update_idx,
            "params": tree_map(lambda x: x.cpu(), mgr.state.params),
            "step": int(ps2.step[0])}


def _dryrun_rank(rank: int, nprocs: int, address: str, device: Optional[str],
                 backend: Optional[str]) -> None:
    import torch.distributed as dist

    from marl_hideandseek_torch.parallel.mesh import make_mesh
    from marl_hideandseek_torch.utils.runtime import init_distributed

    dev = init_distributed(address, nprocs, rank, backend=backend,
                           device=device)
    try:
        _dryrun(make_mesh(nprocs), dev)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     backend: Optional[str] = None) -> Optional[dict]:
    """One sharded training update (rollout, PPO update, PBT bookkeeping)
    and one sharded packed step over an ``n_devices``-rank mesh
    (``parallel/mesh.py``) at tiny shapes: 2 worlds a rank, 1v1,
    ``ZeroAgentVelocity | UseFixedWorld``, 4 steps in 2 BPTT chunks, lr
    1e-3, seed 5. One rank runs in this process on ``device`` (default
    the card) and returns its update count, parameters and step counter;
    more are spawned, rank ``r`` on ``device`` or ``cuda:r``, over
    ``backend`` (default NCCL on cards, gloo on the CPU), and any rank's
    failure raises."""
    if n_devices == 1:
        from marl_hideandseek_torch.parallel.mesh import LOCAL

        return _dryrun(LOCAL, resolve_device(device or "cuda",
                                             "dryrun_multichip"))
    from marl_hideandseek_torch.testing import spawn_ranks

    spawn_ranks(_dryrun_rank, n_devices, (device, backend))
    return None

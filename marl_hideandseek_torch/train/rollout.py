"""Rollout collection for training, and policy ensembles on the agent batch.

Port of ``marl_hideandseek_tpu/train/rollout.py``. ``collect_rollout``
steps the packed env (K4 every step, K1 on reset steps) for
``steps_per_update`` transitions with the policy ensemble choosing the
actions, and stores them as ``num_bptt_chunks`` sequences with the LSTM
state at each chunk's start, for BPTT. ``apply_ensemble`` routes each
agent through its assigned policy only, in one batched product over a
per-policy layout; ``compute_gae`` turns a buffer into advantages and
returns. Every draw comes from the rollout's key, split in the JAX
version's order (``prng.py``): the same key gives JAX's step keys,
actions and matchups.

Where the env renders frames (``EnvConfig.render_frames``), the rollout
copies each step's frame from the env's buffer into one of its own,
allocated per rollout, which the stored sequences then view; a policy
with ``core_inputs`` also gets the previous action and reward as
observations (``core_inputs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import FRAME_KEY, NUM_PREP_STEPS
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.models import DiscreteActionDistributions, Policy
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.parallel.mesh import (
    LOCAL,
    Mesh,
    make_sharded_packed_step,
)
from marl_hideandseek_torch.train.cfg import TrainConfig
from marl_hideandseek_torch.types import (
    AGENT_HIDER,
    EnvState,
    body_slot_ranges,
)
from marl_hideandseek_torch.utils import tracing


@dataclasses.dataclass
class RolloutState:
    """Actor state carried between updates (rollout.py:29-45): the packed
    env state, the prepped (not normalized) current observations flattened
    to the ``[N = W * A]`` agent batch (a frame of its own, not the env's
    buffer; the previous action and reward for a policy with
    ``core_inputs``), the recurrent state, each agent's policy and the key
    of the rollout's draws."""

    env_state: EnvState
    obs: Dict[str, torch.Tensor]
    rnn_states: Any
    assignments: torch.Tensor   # [N] i32
    key: torch.Tensor           # [2] u32

    def replace(self, **kwargs) -> "RolloutState":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class RolloutBuffer:
    """``[C, T/C, N, ...]`` stored sequences, C = BPTT chunks
    (rollout.py:48-58)."""

    obs: Dict[str, torch.Tensor]
    actions: torch.Tensor           # [C, T, N, n_action_dims] i64
    log_probs: torch.Tensor         # [C, T, N]
    values: torch.Tensor            # [C, T, N]
    rewards: torch.Tensor           # [C, T, N]
    dones: torch.Tensor             # [C, T, N] bool
    assignments: torch.Tensor       # [C, T, N] i32
    rnn_start_states: Any           # [C, L, N, H] leaves: chunk-start state
    bootstrap_value: torch.Tensor   # [N] value of the post-rollout obs


class MethodCall(nn.Module):
    """A method of an actor-critic (``act``, ``sequence``) as a module's
    forward, so that ``functional_call`` can run it with other
    parameters (their names prefixed ``ac.``)."""

    def __init__(self, actor_critic: nn.Module, method: str):
        super().__init__()
        self.ac = actor_critic
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.ac, self.method)(*args, **kwargs)


# A policy's routed rows round up to a multiple of this, so that the
# products' shapes, and with them the allocator's blocks and cuBLAS's
# choices, repeat from step to step.
ROUTE_ALIGN = 64


class RouteTally:
    """Host-side tally of the routed ensemble forwards, from the counts
    each one reads anyway: calls, agent rows needed (the sum of the
    counts) and rows run (policies x ``cap``)."""

    def __init__(self):
        self.calls = self.needed = self.run = 0

    def read(self) -> Tuple[int, int, int]:
        """(calls, rows needed, rows run) so far."""
        return self.calls, self.needed, self.run


ROUTE = RouteTally()


class RoutePlan(NamedTuple):
    """A per-policy layout of the agents: ``rows [P * cap]`` the agent of
    each routed row (policy-major, ``cap`` rows a policy) and ``back
    [N]`` each agent's routed row."""

    rows: torch.Tensor
    back: torch.Tensor
    cap: int


def route_plan(assignments: torch.Tensor, num_policies: int) -> RoutePlan:
    """Route each agent ``assignments [N]`` to its policy's rows. The
    agents are sorted by policy (stably, so a policy's rows keep agent
    order); each policy gets ``cap`` rows, the largest count rounded up
    to ``ROUTE_ALIGN`` (at most N). Rows past a policy's count repeat its
    last agent, or agent 0 for a policy with none, so every row computes
    finite numbers that no agent reads. The counts are the one host read
    (``host_read.route``)."""
    dev = assignments.device
    n, p = assignments.shape[0], num_policies
    pol, order = torch.sort(assignments.to(torch.long), stable=True)
    starts = torch.searchsorted(pol, torch.arange(p + 1, device=dev))
    counts = starts.diff()
    with tracing.span("host_read.route"):
        top = max(counts.tolist())
    cap = min(n, -(-max(top, 1) // ROUTE_ALIGN) * ROUTE_ALIGN)
    starts = starts[:p, None]
    j = torch.arange(cap, device=dev)
    pos = (starts + torch.minimum(j, (counts[:, None] - 1).clamp(min=0))
           ).clamp(max=n - 1)
    rows = torch.where(counts[:, None] > 0, order[pos], 0).reshape(-1)
    at = pol * cap + torch.arange(n, device=dev) - starts[pol, 0]
    back = torch.empty_like(order).scatter_(0, order, at)
    ROUTE.calls += 1
    ROUTE.needed += n
    ROUTE.run += p * cap
    return RoutePlan(rows, back, cap)


def apply_ensemble(policy: Policy, all_params: Mapping[str, torch.Tensor],
                   rnn_states, obs, assignments: torch.Tensor,
                   num_policies: int, num_train: Optional[int] = None):
    """Run each agent through its assigned policy only
    (rollout.py:61-126).

    all_params: the flat parameter dict, leading policy axis P. The
    agents are routed (``route_plan``): their normalized observations
    and recurrent state are gathered into ``[P, cap, ...]``, each policy
    holding its own agents, and every layer runs once as one batched
    product over the P policies (the stacked modules of
    ``models/layers.py``, ``per_policy``), which computes per agent what
    JAX's ``vmap`` over the policy axis and its pick compute; one gather
    then brings each agent's row back. Returns (logits ``[N, L]``,
    values ``[N]``, new recurrent state ``[.., N, C]``) per agent. With
    one policy nothing is routed: it runs on the whole batch.

    With ``num_train`` set, policies at index >= num_train are frozen past
    policies, which act only: their agents get values 0 and keep the
    critic's recurrent state (``ActorCritic.actor_only_states``). They
    run in the same pass as the train policies, critic included, and the
    critic's outputs for their agents are dropped: the rollout's forward
    is paced by the host, and one pass over the layers costs it less than
    a full pass and an actor-only one.

    Outputs of a policy an agent does not use are never computed. JAX
    computes them and contracts with a one-hot: the same for finite
    values, but there a non-finite output of another policy turns the
    agent's sum into NaN.
    """
    ac = policy.actor_critic

    if num_policies == 1:
        dists, critic_out, new_rnn = functional_call(
            ac, {k: v[:1] for k, v in all_params.items()},
            (rnn_states, obs), strict=True)
        return (dists.logits[0], critic_out["value"][..., 0][0],
                tree_map(lambda x: x[0], new_rnn))

    p = num_policies
    with tracing.span("ensemble.route"):
        plan = route_plan(assignments, p)
        o = {k: v.index_select(0, plan.rows).unflatten(0, (p, plan.cap))
             for k, v in obs.items()}
        s = tree_map(lambda x: x.index_select(1, plan.rows).unflatten(
            1, (p, plan.cap)).movedim(1, 0), rnn_states)   # [P, L, cap, C]
    dists, critic_out, new = functional_call(
        ac, dict(all_params), (s, o), {"per_policy": True}, strict=True)
    with tracing.span("ensemble.route"):
        back = plan.back
        logits = dists.logits.flatten(0, 1).index_select(0, back)
        values = critic_out["value"][..., 0].flatten().index_select(0, back)
        new_rnn = tree_map(lambda x: x.movedim(0, 1).flatten(1, 2)
                           .index_select(1, back), new)
        if num_train is not None and 0 < num_train < p:
            past = assignments >= num_train
            values = values.masked_fill(past, 0.0)
            new_rnn = tree_map(
                lambda a, b: a if a is b else torch.where(past[:, None], b, a),
                new_rnn, ac.actor_only_states(new_rnn, rnn_states))
        return logits, values, new_rnn


def core_inputs(actions: torch.Tensor, rewards: torch.Tensor,
                dones: torch.Tensor, buckets) -> Dict[str, torch.Tensor]:
    """IMPALA's core input for the next step, per agent: ``prev_action``,
    one one-hot a bucket of ``actions [N, len(buckets)]`` (``[N,
    sum(buckets)]``), and ``prev_reward``, ``rewards [N]`` clipped to [-1,
    1] (``[N, 1]``); both zero where ``dones [N]``: the next step opens an
    episode."""
    keep = (~dones).to(torch.float32)[:, None]
    onehot = torch.cat([torch.nn.functional.one_hot(actions[:, i].long(), b)
                        for i, b in enumerate(buckets)], -1)
    return {"prev_action": onehot.to(torch.float32) * keep,
            "prev_reward": rewards.clamp(-1.0, 1.0)[:, None] * keep}


def initial_core_inputs(n: int, buckets, device) -> Dict[str, torch.Tensor]:
    """``core_inputs`` before an episode's first step: zeros."""
    return {"prev_action": torch.zeros((n, sum(buckets)), device=device),
            "prev_reward": torch.zeros((n, 1), device=device)}


def denormalize_values(cfg: TrainConfig, value_stats, values: torch.Tensor,
                       assignments: torch.Tensor) -> torch.Tensor:
    """Critic outputs (normalized-return space) -> returns, per agent
    through its policy's EMA statistics (rollout.py:128-141). Identity for
    the Dreamer critic, which normalizes inside (symlog, two-hot)."""
    if cfg.dreamer_v3_critic or value_stats is None:
        return values
    idx = assignments.to(torch.long)
    return values * value_stats["sigma"][idx] + value_stats["mu"][idx]


def _resample_assignments(key: torch.Tensor, dones_w: torch.Tensor,
                          assignments: torch.Tensor, cfg: TrainConfig,
                          num_worlds: int, agents_per_world: int,
                          agent_type: torch.Tensor,
                          mesh: Mesh = LOCAL) -> torch.Tensor:
    """New team -> policy matchups for the worlds whose episode ended
    (rollout.py:144-191); the other worlds keep theirs.

    The train side plays a policy drawn from the train policies; the
    other side, per the PBT portions, the same policy (self-play), another
    train policy (cross-play) or a past policy. Which role (hiders or
    seekers) the train side takes is a fair coin per world. Teams are
    keyed by ``agent_type`` ``[W, A]`` (the post-step state: on reset
    steps, the new episode's teams). Without PBT every agent plays
    policy 0 and nothing is drawn. Draws as JAX does from ``k1..k5 =
    split(key, 5)``: the train side's policy ``randint(k1)``, the portion
    draw ``uniform(k2)``, the past and cross policies ``randint(k3)``,
    ``randint(k4)``, the role ``bernoulli(k5, 0.5)``. Over ``mesh`` the
    ``num_worlds`` worlds are this rank's, and draw their slice of the
    draws of all the worlds."""
    pbt = cfg.pbt
    if pbt is None or pbt.total_policies == 1:
        return assignments
    n_train = pbt.num_train_policies
    n_total = pbt.total_policies
    w = num_worlds
    first = mesh.rank * w

    # Every key's randint bits and uniforms in one launch each (k2's
    # randint bits and k1, k3, k4's uniforms are drawn too, unused).
    ks = prng.split(key, 5)
    hi, lo = (x[:, first:first + w]
              for x in prng.randint_bits(ks, (w * mesh.size,)))
    u = prng.uniform(ks, (w * mesh.size,))[:, first:first + w]
    t0 = prng.randint_from_bits(hi[0], lo[0], 0, n_train)
    past = prng.randint_from_bits(hi[2], lo[2], n_train,
                                  max(n_total, n_train + 1))
    cross = prng.randint_from_bits(hi[3], lo[3], 0, n_train)
    r = u[1]
    other = past if pbt.num_past_policies > 0 else cross
    t1 = torch.where(r < pbt.self_play_portion, t0,
                     torch.where(r < pbt.self_play_portion +
                                 pbt.cross_play_portion, cross, other))
    hiders_train = u[4] < 0.5
    h_pol = torch.where(hiders_train, t0, t1)
    s_pol = torch.where(hiders_train, t1, t0)
    world_assign = torch.where(agent_type == AGENT_HIDER, h_pol[:, None],
                               s_pol[:, None])                   # [W, A]
    done_flat = dones_w.repeat_interleave(agents_per_world)
    return torch.where(done_flat, world_assign.reshape(-1),
                       assignments).to(torch.int32)


def rollout_keys(key: torch.Tensor, steps: int):
    """The rollout's next key and each step's (action key, matchup key)
    ``[steps, 2, 2]``: ``key, sub = split(key)``, then step t's pair is
    ``split(split(sub, steps)[t])`` (rollout.py:228,331-338); three
    launches for the whole rollout."""
    key, sub = prng.split(key).unbind(0)
    return key, prng.split(prng.split(sub, steps))


def collect_rollout(cfg: TrainConfig, env: PackedEnv, policy: Policy,
                    all_params: Mapping[str, torch.Tensor], obs_stats,
                    rollout: RolloutState, value_stats=None,
                    mesh: Mesh = LOCAL, record_frames: bool = True):
    """Run ``steps_per_update`` env steps; return (rollout', buffer,
    metrics) (rollout.py:194-376).

    obs_stats: the observation normalizer's statistics, frozen during the
    rollout (the caller updates them from the buffer). value_stats: the
    plain critic's EMA return statistics; stored values and the bootstrap
    are denormalized so that GAE runs on returns.

    Per step: normalize, the ensemble forward (past policies actor-only),
    an action draw, ``env.step``, the LSTM state cleared for agents whose
    episode ended, and new matchups for the worlds that ended, keyed by
    the post-step teams. The frame of each step is copied into the
    rollout's frame buffer (``[T + 1, N, ..]``, the last the returned
    state's, copied again so that the buffer can go with the update); a
    policy with ``core_inputs`` gets each step's actions and rewards as
    the next step's observations. Without ``record_frames`` (a pass that
    keeps only the metrics, ``eval_elo``) the frames are neither copied
    nor in the buffer: ``eval_elo``'s 240 steps would hold 241 frames of
    64 KiB an agent, 16.2 GB at 256 2v2 worlds, where an update's
    buffer holds 41. ELO attribution (``team_pol``) and the seek-phase
    gate use the pre-step state: the episode the transition belongs to.
    Runs without autograd.

    Over ``mesh`` the rollout holds this rank's worlds (``env`` is
    configured for all of them): they step with their global ids, draw
    their slice of the global draws, and the metrics are the whole
    batch's.
    """
    with tracing.span("rollout"):
        return _collect(cfg, env, policy, all_params, obs_stats, rollout,
                        value_stats, mesh, record_frames)


def _collect(cfg, env, policy, all_params, obs_stats, rollout, value_stats,
             mesh, record_frames):
    cfg_env = env.cfg
    w, a = rollout.env_state.step.shape[0], cfg_env.max_agents
    n = w * a
    env_step = make_sharded_packed_step(env, mesh)
    t_chunk = cfg.steps_per_update // cfg.num_bptt_chunks
    n_total = cfg.total_policies
    norm = policy.obs_preprocess
    ac = policy.actor_critic
    buckets = tuple(cfg.actions.actions_num_buckets)
    key, step_keys = rollout_keys(rollout.key, cfg.steps_per_update)
    (box_lo, box_hi), (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg_env)

    def flat(o):
        return {k: v.reshape((n,) + v.shape[2:]) for k, v in
                norm.prep(o).items()}

    keys = ("obs", "actions", "log_probs", "values", "rewards", "dones",
            "assignments", "episode_results", "dones_w", "team_pol",
            "seek", "hidden", "locked", "grab", "ramp_locked", "ramp_move")
    store = {k: [] for k in keys}
    rnn_start = []
    env_state, obs = rollout.env_state, rollout.obs
    frames = None
    if FRAME_KEY in obs and record_frames:
        first = obs[FRAME_KEY]
        frames = first.new_empty((cfg.steps_per_update + 1,) + first.shape)
        obs = {**obs, FRAME_KEY: frames[0].copy_(first)}
    rnn, assignments = rollout.rnn_states, rollout.assignments
    with torch.no_grad():
        for ci in range(cfg.num_bptt_chunks):
            rnn_start.append(rnn)
            for ti in range(t_chunk):
                with tracing.span("rollout.forward"):
                    k_act, k_assign = step_keys[ci * t_chunk + ti].unbind(0)
                    logits, values, new_rnn = apply_ensemble(
                        policy, all_params, rnn,
                        norm.normalize(obs_stats, obs), assignments, n_total,
                        num_train=cfg.num_train_policies)
                    values = denormalize_values(cfg, value_stats, values,
                                                assignments)
                    dists = DiscreteActionDistributions(buckets, logits)
                    actions = dists.sample(k_act,
                                           (mesh.rank * n, mesh.size * n))
                    log_probs = dists.log_prob(actions)

                pre_step = env_state.step
                pre_is_h = (env_state.agent_type == AGENT_HIDER).T   # [W, A]
                pre_act = env_state.agent_active.to(torch.bool).T
                pre_sf = env_state.seekers_first.to(torch.bool)
                env_state, result = env_step(
                    env_state, actions.reshape(w, a, -1).permute(1, 2, 0))
                with tracing.span("rollout.record"):
                    next_obs = flat(result.obs)
                    dones = result.dones.T.reshape(-1).to(torch.bool)
                    t = ci * t_chunk + ti + 1
                    if frames is not None:
                        next_obs[FRAME_KEY] = frames[t].copy_(
                            next_obs[FRAME_KEY])
                    if policy.core_inputs:
                        next_obs.update(core_inputs(
                            actions, result.rewards.T.reshape(-1), dones,
                            buckets))
                    new_rnn = ac.clear_recurrent_state(new_rnn, dones)
                    dones_w = result.dones[0].to(torch.bool)
                    new_assign = _resample_assignments(
                        k_assign, dones_w, assignments, cfg, w, a,
                        env_state.agent_type.T, mesh)

                    # The pre-step episode's (first-spawned,
                    # second-spawned) team policies, for ELO
                    # (rollout.py:256-268).
                    assign_wa = assignments.reshape(w, a)
                    h_pol = torch.where(pre_is_h & pre_act, assign_wa,
                                        -1).amax(1)
                    s_pol = torch.where(~pre_is_h & pre_act, assign_wa,
                                        -1).amax(1)
                    team_pol = torch.stack(
                        [torch.where(pre_sf, s_pol, h_pol),
                         torch.where(pre_sf, h_pol, s_pol)], -1)

                    # Seek-phase world-steps (the pre-step counter, so the
                    # last seek step of an episode counts), with the hiders
                    # hidden; world-steps with a locked box, a grab, a
                    # locked ramp, a moving ramp (post-step state;
                    # rollout.py:270-302).
                    bodies = env_state.bodies
                    ramp_speed = torch.linalg.vector_norm(
                        bodies.vel[ramp_lo:ramp_hi, :2], dim=1)
                    in_seek = (pre_step >= NUM_PREP_STEPS - 1).to(
                        torch.float32)
                    ramps = slice(ramp_lo, ramp_hi)
                    step_vals = {
                        "obs": obs, "actions": actions,
                        "log_probs": log_probs, "values": values,
                        "rewards": result.rewards.T.reshape(-1),
                        "dones": dones, "assignments": assignments,
                        "episode_results": result.episode_results.T,
                        "dones_w": dones_w, "team_pol": team_pol,
                        "seek": in_seek.sum(),
                        "hidden": ((result.team_reward > 0.0).to(
                            torch.float32) * in_seek).sum(),
                        "locked": bodies.locked[box_lo:box_hi].any(0).sum(),
                        "grab": (env_state.grab.target >= 0).any(0).sum(),
                        "ramp_locked": bodies.locked[ramps].any(0).sum(),
                        "ramp_move": ((ramp_speed > 0.25) &
                                      bodies.active[ramps]).any(0).sum(),
                    }
                    for k in keys:
                        store[k].append(step_vals[k])
                obs, rnn, assignments = next_obs, new_rnn, new_assign

        with tracing.span("rollout.forward"):
            _, boot_values, _ = apply_ensemble(
                policy, all_params, rnn, norm.normalize(obs_stats, obs),
                assignments, n_total, num_train=cfg.num_train_policies)
            boot_values = denormalize_values(cfg, value_stats, boot_values,
                                             assignments)

    with tracing.span("rollout.buffer"):
        c = cfg.num_bptt_chunks

        def chunked(xs):
            x = torch.stack(xs)
            return x.reshape((c, t_chunk) + x.shape[1:])

        obs_seq = {k: chunked([o[k] for o in store["obs"]])
                   for k in store["obs"][0] if k != FRAME_KEY}
        if frames is not None:
            obs_seq[FRAME_KEY] = frames[:-1].unflatten(0, (c, t_chunk))
            obs = {**obs, FRAME_KEY: frames[-1].clone()}
        buffer = RolloutBuffer(
            obs=obs_seq,
            actions=chunked(store["actions"]),
            log_probs=chunked(store["log_probs"]),
            values=chunked(store["values"]),
            rewards=chunked(store["rewards"]),
            dones=chunked(store["dones"]),
            assignments=chunked(store["assignments"]),
            rnn_start_states=tree_map(lambda *xs: torch.stack(xs),
                                      *rnn_start),
            bootstrap_value=boot_values,
        )
        # World-step counts and the reward sum over every rank's worlds.
        total_ws = float(cfg.steps_per_update * w * mesh.size)
        names = ("hidden", "seek", "locked", "grab", "ramp_locked",
                 "ramp_move")
        sums = dict(zip(names + ("reward",), mesh.all_sum_many(
            [torch.stack(store[k]).sum().to(torch.float32) for k in names] +
            [buffer.rewards.sum()])))
        metrics = {
            "episode_results": torch.stack(store["episode_results"]),
            "dones_w": torch.stack(store["dones_w"]),
            "team_pol": torch.stack(store["team_pol"]),
            "mean_reward": sums["reward"] / (total_ws * a),
            "hidden_frac": sums["hidden"] / torch.clamp(sums["seek"],
                                                        min=1.0),
            "lock_rate": sums["locked"] / total_ws,
            "grab_rate": sums["grab"] / total_ws,
            "ramp_lock_rate": sums["ramp_locked"] / total_ws,
            "ramp_move_rate": sums["ramp_move"] / total_ws,
        }
        new_rollout = RolloutState(env_state=env_state, obs=obs,
                                   rnn_states=rnn, assignments=assignments,
                                   key=key)
        return new_rollout, buffer, metrics


def compute_gae(cfg: TrainConfig, buffer: RolloutBuffer):
    """Masked GAE over the ``C * T`` time axis (rollout.py:379-406):
    A_t = delta_t + gamma * lambda * (1 - done_t) * A_{t+1}, as a reverse
    loop where JAX runs an associative scan (the same recurrence; the sums
    round differently in the last bits). Returns (advantages, returns),
    each ``[C, T, N]``."""
    c, t, n = buffer.rewards.shape
    rewards = buffer.rewards.reshape(c * t, n)
    values = buffer.values.reshape(c * t, n)
    nonterminal = 1.0 - buffer.dones.reshape(c * t, n).to(torch.float32)
    next_values = torch.cat([values[1:], buffer.bootstrap_value[None]], 0)
    delta = rewards + cfg.gamma * next_values * nonterminal - values
    coef = cfg.gamma * cfg.gae_lambda * nonterminal
    advantages = torch.empty_like(delta)
    adv = torch.zeros_like(delta[0])
    for i in range(c * t - 1, -1, -1):
        adv = delta[i] + coef[i] * adv
        advantages[i] = adv
    returns = advantages + values
    return advantages.reshape(c, t, n), returns.reshape(c, t, n)

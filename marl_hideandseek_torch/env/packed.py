"""The packed environment step: ``PackedEnv.init`` / ``PackedEnv.step``.

Port of ``marl_hideandseek_tpu/env/packed.py``. State is packed (every
leaf's world axis LAST), so consecutive CUDA threads reading one row of
consecutive worlds read coalesced addresses. A step is:

1. the megastep (``ops/step.py``): movement, grab/lock, XPBD physics,
   agent zero-velocity, the ray sweep, rewards, dones and episode scores
   - one CUDA kernel on the card, the component functions below on CPU;
2. resets: worlds at the episode end or with a nonzero ``resets`` entry
   are regenerated - all worlds at once (full branch) or, when at most
   ``reset_budget`` trigger, only those (compact branch) - and re-swept
   with the raycast kernel (``ops/rays.py``);
3. observation assembly with flattened feature dims;
4. with ``cfg.render_frames``, every agent's 64x64 RGBD view (K5's
   frames mode, ``ops/rgbd.py``) into a buffer allocated once, as the
   observation ``FRAME_KEY``.

This is the port's one environment core: the classic env
(``env/env.py``) runs it too, overriding only the megastep
(``_megastep``) and the compact merge's float contract
(``_merge_floats``).

Random draws follow JAX's keys (``prng.py``): ``init(key)`` draws the
first episodes from ``key``, resets from ``base_key`` (default
``PRNGKey(cfg.rand_seed)``), as JAX's ``init`` and ``step`` do. Level
regeneration is injectable (``worldgen``): the default draws each
episode from (base key, world id, episode counter) and generates its
level from the world's level key (``env/episode.py``,
``env/levelgen.py``), as JAX does; tests may pass worlds generated
elsewhere.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from marl_hideandseek_torch import math3d, prng
from marl_hideandseek_torch.config import (
    FRAME_FOV,
    FRAME_KEY,
    FRAME_MAX_DEPTH,
    FRAME_SIZE,
    NUM_PREP_STEPS,
    OOB_LIMIT,
    OOB_PENALTY,
    EnvConfig,
)
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env.episode import (
    WorldGen,
    fresh_world,
    levelgen_worldgen,
    regen_world,
)
from marl_hideandseek_torch.env.observations import build_observations_packed
from marl_hideandseek_torch.ops import rays as ops_rays
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.ops import step as ops_step
from marl_hideandseek_torch.types import (
    AGENT_HIDER,
    AGENT_SEEKER,
    OWNER_HIDER,
    OWNER_NONE,
    OWNER_SEEKER,
    EnvState,
    PackedStepResult,
    SweepResults,
    body_slot_ranges,
    on_bits,
)
from marl_hideandseek_torch.utils import tracing

# Movement constants (reference: src/sim.cpp:202-254). Default variant:
# 11 buckets, F_max 60, tau_max 15; ZeroAgentVelocity: 5, 800, 240.
DEFAULT_BUCKETS = 11
DEFAULT_F_MAX = 60.0
DEFAULT_T_MAX = 15.0
INSTANT_BUCKETS = 5
INSTANT_F_MAX = 800.0
INSTANT_T_MAX = 240.0


# ---------------------------------------------------------------------------
# Component-form step phases (packed.py:108-300)
# ---------------------------------------------------------------------------


def movement_scales(cfg: EnvConfig):
    """(half bucket, force per bucket, torque per bucket)."""
    if cfg.zero_agent_velocity:
        half = INSTANT_BUCKETS // 2
        return half, INSTANT_F_MAX / half, INSTANT_T_MAX / half
    half = DEFAULT_BUCKETS // 2
    return half, DEFAULT_F_MAX / half, DEFAULT_T_MAX / half


def _can_act(ps: EnvState):
    seeker_frozen = (ps.agent_type == AGENT_SEEKER) & \
        (ps.step[None, :] < NUM_PREP_STEPS - 1)
    return ps.agent_active & ~seeker_frozen


def movement_packed(cfg: EnvConfig, ps: EnvState, actions):
    """movementSystem (src/sim.cpp:202-254): actions [A, 5, W] ->
    (ext_force [B, 3, W], ext_torque [B, 3, W])."""
    _, _, (agent_lo, agent_hi) = body_slot_ranges(cfg)
    n_body = cfg.num_dyn_bodies
    w = ps.step.shape[0]
    half, f_per, t_per = movement_scales(cfg)
    q = tuple(ps.bodies.quat[agent_lo:agent_hi, k] for k in range(4))
    fx_l = f_per * (actions[:, 0] - half).to(torch.float32)   # [A, W]
    fy_l = f_per * (actions[:, 1] - half).to(torch.float32)
    t_z = t_per * (actions[:, 2] - half).to(torch.float32)
    zero = torch.zeros_like(fx_l)
    gate = _can_act(ps).to(torch.float32)
    fw = math3d.qrot(q, (fx_l, fy_l, zero))
    force_a = torch.stack([c * gate for c in fw], dim=1)         # [A, 3, W]
    torque_a = torch.stack([zero, zero, t_z * gate], dim=1)
    dev = ps.step.device
    ext_force = torch.zeros((n_body, 3, w), device=dev)
    ext_torque = torch.zeros((n_body, 3, w), device=dev)
    ext_force[agent_lo:agent_hi] = force_a
    ext_torque[agent_lo:agent_hi] = torque_a
    return ext_force, ext_torque


def action_system_packed(cfg: EnvConfig, ps: EnvState, actions, hit_t,
                         hit_id) -> EnvState:
    """Grab/lock (actionSystem, src/sim.cpp:270-370); hit_t/hit_id [A, W]
    are the interaction-ray hits carried from the previous step."""
    (box_lo, _), (_, ramp_hi), (agent_lo, agent_hi) = body_slot_ranges(cfg)
    n_body = cfg.num_dyn_bodies
    b = ps.bodies
    dev = ps.step.device

    a_pos = tuple(b.pos[agent_lo:agent_hi, k] for k in range(3))
    a_quat = tuple(b.quat[agent_lo:agent_hi, k] for k in range(4))
    eye = (a_pos[0], a_pos[1], a_pos[2] + 0.5)
    one = torch.ones_like(a_pos[0])
    zero = torch.zeros_like(a_pos[0])
    fwd = math3d.qrot(a_quat, (zero, one, zero))

    can_act = _can_act(ps)
    want_lock = (actions[:, 4] == 1) & can_act
    want_grab = (actions[:, 3] == 1) & can_act
    is_obj = (hit_id >= box_lo) & (hit_id < ramp_hi)
    tgt = torch.where(is_obj, hit_id, 0).long()                # [A, W]

    onehot = tgt[:, None, :] == torch.arange(n_body, device=dev)[None, :,
                                                                  None]
    t_locked = torch.gather(b.locked, 0, tgt)                 # [A, W]
    t_owner = torch.gather(b.owner, 0, tgt)

    my_team = torch.where(ps.agent_type == AGENT_HIDER, OWNER_HIDER,
                          OWNER_SEEKER).to(torch.int32)
    do_unlock = want_lock & is_obj & t_locked & (t_owner == my_team)
    do_lock = want_lock & is_obj & ~t_locked & (t_owner == OWNER_NONE)

    locked_any = torch.any(onehot & do_lock[:, None], dim=0)       # [B, W]
    unlocked_any = torch.any(onehot & do_unlock[:, None], dim=0)
    lock_team = torch.amax(
        torch.where(onehot & do_lock[:, None], my_team[:, None], 0), dim=0)
    locked = torch.where(locked_any, True,
                         torch.where(unlocked_any, False, b.locked))
    owner = torch.where(locked_any, lock_team,
                        torch.where(unlocked_any, OWNER_NONE, b.owner)
                        ).to(torch.int32)

    g = ps.grab
    has_grab = g.target >= 0
    release = want_grab & has_grab
    grabbable = is_obj & ~t_locked & (t_owner == OWNER_NONE)
    acquire = want_grab & ~has_grab & grabbable

    safe_t = torch.where(is_obj, hit_t, 0.0)
    hit_pos = tuple(e + f * safe_t for e, f in zip(eye, fwd))
    t_pos = tuple(torch.gather(b.pos[:, k], 0, tgt) for k in range(3))
    t_quat = tuple(torch.gather(b.quat[:, k], 0, tgt) for k in range(4))
    rel = tuple(hp - tp for hp, tp in zip(hit_pos, t_pos))
    r2_new = math3d.qrot(t_quat, rel, inv=True)
    rel_q_new = math3d.qnorm(math3d.qmul(math3d.qconj(t_quat), a_quat))
    sep_new = safe_t - 1.25

    new_target = torch.where(release, -1,
                             torch.where(acquire, tgt, g.target.long()))
    acq = acquire[:, None, :]
    return ps.replace(
        bodies=b.replace(locked=locked, owner=owner),
        grab=g.replace(
            target=new_target.to(torch.int32),
            r2=torch.where(acq, torch.stack(r2_new, dim=1), g.r2),
            rel_q=torch.where(acq, torch.stack(rel_q_new, dim=1), g.rel_q),
            sep=torch.where(acquire, sep_new, g.sep)))


def zero_agent_velocities_packed(cfg: EnvConfig, ps: EnvState) -> EnvState:
    """agentZeroVelSystem (src/sim.cpp:256-268)."""
    _, _, (agent_lo, agent_hi) = body_slot_ranges(cfg)
    b = ps.bodies
    vel = b.vel.clone()
    omega = b.omega.clone()
    a_vel = vel[agent_lo:agent_hi]
    vel[agent_lo:agent_hi] = torch.stack([
        torch.zeros_like(a_vel[:, 0]), torch.zeros_like(a_vel[:, 1]),
        torch.clamp(a_vel[:, 2], max=0.0)], dim=1)
    omega[agent_lo:agent_hi] = 0.0
    return ps.replace(bodies=b.replace(vel=vel, omega=omega))


def rewards_dones_packed(cfg: EnvConfig, ps: EnvState, team_r):
    """outputRewardsDonesSystem (src/sim.cpp:806-841): team_r [W] ->
    (rewards [A, W] f32, dones [A, W] i32)."""
    _, _, (agent_lo, agent_hi) = body_slot_ranges(cfg)
    cur = ps.step
    sign = torch.where(ps.agent_type == AGENT_SEEKER, -1.0, 1.0)
    reward = sign * team_r[None, :]
    px = ps.bodies.pos[agent_lo:agent_hi, 0]
    py = ps.bodies.pos[agent_lo:agent_hi, 1]
    oob = (torch.abs(px) >= OOB_LIMIT) | (torch.abs(py) >= OOB_LIMIT)
    reward = reward - OOB_PENALTY * oob.to(torch.float32)
    in_prep = cur < NUM_PREP_STEPS - 1
    reward = torch.where(in_prep[None, :], 0.0, reward)
    reward = reward * ps.agent_active.to(torch.float32)
    done = (cur == cfg.episode_len - 1)[None, :].expand(reward.shape)
    return reward, done.to(torch.int32)


def episode_results_packed(cfg: EnvConfig, ps: EnvState, team_r) -> EnvState:
    """updateEpisodeResultsSystem (src/sim.cpp:843-893)."""
    cur = ps.step
    dev = cur.device
    scores = torch.where(cur[None, :] == 0, 0, ps.running_scores)
    finished = torch.where(cur[None, :] == 0, 0.0, ps.finished_scores)
    hid_idx = torch.where(ps.seekers_first, 1, 0)
    winner = torch.where(team_r > 0.0, hid_idx, 1 - hid_idx)
    in_seek = cur >= NUM_PREP_STEPS
    inc = ((torch.arange(2, device=dev)[:, None] == winner[None, :]) &
           in_seek[None, :])
    scores = (scores + inc.to(torch.int32)).to(torch.int32)
    at_end = cur == cfg.episode_len - 1
    s0, s1 = scores[0], scores[1]
    f0 = torch.where(s0 > s1, 1.0, torch.where(s0 < s1, 0.0, 0.5))
    f1 = torch.where(s0 > s1, 0.0, torch.where(s0 < s1, 1.0, 0.5))
    final = torch.stack([f0, f1])
    finished = torch.where(at_end[None, :], final, finished)
    return ps.replace(running_scores=scores, finished_scores=finished)


# ---------------------------------------------------------------------------
# The standalone sweep (packed.py:479)
# ---------------------------------------------------------------------------


def _packed_rays(x: torch.Tensor) -> torch.Tensor:
    """World-first ray tensor [W, R(, 3)] -> packed [R(, 3), W]."""
    return torch.movedim(x, 0, -1).contiguous()


def standalone_sweep_packed(cfg: EnvConfig, ps: EnvState,
                            raycast=ops_rays.raycast_batch_packed
                            ) -> SweepResults:
    """The per-step ray sweep on packed state as two raycast launches
    (obs rays, then the grab/lock rays). ``raycast`` defaults to the K1
    wrapper; the megastep's plain version passes the plain raycast."""
    with tracing.span("env.sweep"):
        st = obs_mod.world_first(ps)
        o, d, m, e = obs_mod.obs_ray_queries(cfg, st)
        obs_t, obs_id = raycast(cfg, ps, _packed_rays(o), _packed_rays(d),
                                _packed_rays(m), _packed_rays(e))
        vis_seen, lidar = obs_mod.consume_obs_sweep(cfg, st, obs_id.T,
                                                    obs_t.T)
        o, d, m, e = obs_mod.action_ray_queries(cfg, st)
        act_t, act_id = raycast(cfg, ps, _packed_rays(o), _packed_rays(d),
                                _packed_rays(m), _packed_rays(e))
        rew_seen = obs_mod.reward_flag_from_vis(cfg, st, vis_seen)
        return SweepResults(
            vis_seen=torch.movedim(vis_seen, 0, -1).contiguous(),
            lidar=torch.movedim(lidar, 0, -1).contiguous(),
            act_t=act_t, act_id=act_id, rew_seen=rew_seen)


# ---------------------------------------------------------------------------
# The packed step
# ---------------------------------------------------------------------------


def _select_worlds(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(mask.reshape((1,) * (new.dim() - 1) + (-1,)), new, old)


def canon_float(x: torch.Tensor) -> torch.Tensor:
    """The compact merge's float contract: finite values stay, anything
    else (NaN, -inf, +inf) becomes +inf (packed.py:677-695)."""
    if not x.is_floating_point():
        return x
    return torch.where(torch.isfinite(x), x, torch.inf)


class PackedEnv:
    """Hide-and-seek over packed worlds; PyTorch port of the JAX
    ``PackedEnv``.

    ``device`` defaults to ``"cuda"`` and must exist: asking for CUDA
    without a card raises rather than running on the CPU. ``worldgen``
    replaces the world generator (see ``WorldGen``); the default is
    JAX's: each episode's draws keyed by (base key, world id, episode
    counter) and each level drawn from its level key.

    With ``cfg.render_frames`` the observations hold ``FRAME_KEY``, the
    env's one frame buffer: the next ``step`` or ``init`` renders over
    it, so a caller that keeps a step's frames copies them (the rollout
    writes each step's into its buffer).
    """

    def __init__(self, cfg: EnvConfig, device="cuda",
                 worldgen: Optional[WorldGen] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch path")
        self.cfg = cfg
        self.device = device
        self.worldgen = worldgen or levelgen_worldgen(cfg)
        # Reset branches taken by step(), for runs that must show them.
        self.reset_counts = {"full": 0, "compact": 0}
        self._frames: Optional[torch.Tensor] = None

    # -- construction -------------------------------------------------------

    def init(self, key: Optional[torch.Tensor] = None,
             world_ids: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, PackedStepResult]:
        """Fresh level-1 worlds drawn from ``key`` (default
        ``PRNGKey(cfg.rand_seed)``), swept, with zero rewards: the worlds
        ``world_ids`` (default all, ``arange(cfg.num_worlds)``), each as
        it is in the whole batch (a shard's init)."""
        with tracing.span("env.init"):
            ids = (torch.arange(self.cfg.num_worlds, device=self.device)
                   if world_ids is None else world_ids.to(self.device))
            w = ids.shape[0]
            ps = fresh_world(self.worldgen, self._key(key), ids,
                             torch.ones(w, dtype=torch.long,
                                        device=self.device))
            return self._swept(ps)

    def _swept(self, ps: EnvState) -> Tuple[EnvState, PackedStepResult]:
        """Sweep fresh or loaded worlds; zero rewards."""
        sweep = standalone_sweep_packed(self.cfg, ps)
        ps = ps.replace(act_hit_t=sweep.act_t, act_hit_id=sweep.act_id)
        return ps, self._result(ps, sweep, None, None)

    # -- stepping -----------------------------------------------------------

    def step(self, ps: EnvState, actions: torch.Tensor,
             resets: Optional[torch.Tensor] = None,
             base_key: Optional[torch.Tensor] = None,
             world_ids: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, PackedStepResult]:
        """One packed step. actions [A, 5, W] int; resets [W] int level
        ids (0 = none); base_key the key of the reset worlds' episode
        draws (default ``PRNGKey(cfg.rand_seed)``); world_ids [W] global
        world indices handed to the level generator (default
        arange(W))."""
        with tracing.span("env.step"):
            return self._step(ps, actions, resets, base_key, world_ids)

    def _step(self, ps, actions, resets, base_key, world_ids):
        cfg = self.cfg
        w = ps.step.shape[0]
        dev = ps.step.device
        if resets is None:
            resets = torch.zeros(w, dtype=torch.int32, device=dev)
        if world_ids is None:
            world_ids = torch.arange(w, device=dev)

        with tracing.span("env.megastep"):
            ps, sweep, rewards, dones, team_r = self._megastep(
                ps, actions.to(torch.int32).contiguous())

        trigger = resets != 0
        if not cfg.ignore_episode_length:
            trigger = trigger | (ps.step == cfg.episode_len - 1)
        with tracing.span("host_read.reset_trigger"):
            n_trig = int(trigger.sum())
        level_ids = torch.where(resets != 0, resets, 1).long()
        if n_trig == 0:
            ps = ps.replace(step=ps.step + 1)
        elif 0 < cfg.reset_budget < w and n_trig <= cfg.reset_budget:
            self.reset_counts["compact"] += 1
            with tracing.span("env.reset"):
                ps, sweep = self._compact_resets(
                    ps, sweep, trigger, level_ids, world_ids,
                    self._key(base_key))
        else:
            self.reset_counts["full"] += 1
            with tracing.span("env.reset"):
                ps, sweep = self._full_resets(ps, trigger, level_ids,
                                              world_ids, self._key(base_key))
        ps = ps.replace(act_hit_t=sweep.act_t, act_hit_id=sweep.act_id)
        return ps, self._result(ps, sweep, rewards, dones, team_r)

    def _megastep(self, ps, actions):
        return ops_step.megastep_packed(self.cfg, ps, actions)

    # The compact merge's float contract.
    _merge_floats = staticmethod(canon_float)

    def _key(self, key: Optional[torch.Tensor]) -> torch.Tensor:
        if key is None:
            return prng.key(self.cfg.rand_seed, self.device)
        return prng.as_key(key, self.device)

    def _full_resets(self, ps, trigger, level_ids, world_ids, base_key):
        """Regenerate every world, keep the triggered ones, re-sweep."""
        regen = regen_world(self.worldgen, base_key, world_ids, ps,
                            level_ids)
        adv = ps.replace(step=ps.step + 1)
        new_p = regen.map2(adv, on_bits(
            lambda n, o: _select_worlds(trigger, n, o)))
        return new_p, standalone_sweep_packed(self.cfg, new_p)

    def _compact_resets(self, ps, sweep, trigger, level_ids, world_ids,
                        base_key):
        """Regenerate only the triggered worlds (at most reset_budget).

        The k = reset_budget slots hold the triggered worlds in ascending
        order, padded with the first one; only the first occurrence of a
        world writes back (packed.py:629-703). Float leaves merge under
        ``_merge_floats``: here the finite-or-+inf contract."""
        k = self.cfg.reset_budget
        w = trigger.shape[0]
        dev = trigger.device
        w_idx = torch.arange(w, device=dev)
        score = torch.where(trigger, w - w_idx, 0)
        top_score, idx = torch.topk(score, k, sorted=True)
        idx = torch.where(top_score > 0, idx, idx[0])
        first = (torch.argmax((idx[:, None] == idx[None, :]).to(torch.int8),
                              dim=1) == torch.arange(k, device=dev))

        sub = ps.map(on_bits(lambda x: x[..., idx]))
        regen = regen_world(self.worldgen, base_key, world_ids[idx], sub,
                            level_ids[idx])
        sub_sweep = standalone_sweep_packed(self.cfg, regen)

        with tracing.span("host_read.compact_cols"):
            cols = idx[first]

        @on_bits
        def merge(old, new):
            out = old.clone()
            with tracing.span("host_read.compact_merge"):
                picked = self._merge_floats(new)[..., first]
            out[..., cols] = picked.to(old.dtype)
            return out

        adv = ps.replace(step=ps.step + 1)
        new_p = adv.map2(regen, merge)
        new_sweep = SweepResults(*(merge(o, n) for o, n in
                                   zip(sweep, sub_sweep)))
        return new_p, new_sweep

    def _render_frames(self, ps: EnvState) -> torch.Tensor:
        """Every agent's view of ``ps`` into the frame buffer, allocated
        at the first render (and again only if the world count
        changes)."""
        w = ps.step.shape[0]
        if self._frames is None or self._frames.shape[0] != w:
            self._frames = ops_rgbd.frames_buffer(
                self.cfg, w, FRAME_SIZE, FRAME_SIZE, self.device)
        return ops_rgbd.render_rgbd_frames(
            self.cfg, ps, FRAME_SIZE, FRAME_SIZE, FRAME_FOV, FRAME_MAX_DEPTH,
            out=self._frames)

    def _result(self, ps, sweep: SweepResults, rewards, dones,
                team_r=None) -> PackedStepResult:
        cfg = self.cfg
        w = ps.step.shape[0]
        dev = ps.step.device
        with tracing.span("env.observations"):
            obs = build_observations_packed(cfg, ps, sweep.vis_seen,
                                            sweep.lidar)
        if cfg.render_frames:
            obs[FRAME_KEY] = self._render_frames(ps)
        if rewards is None:
            rewards = torch.zeros((cfg.max_agents, w), device=dev)
        if dones is None:
            dones = torch.zeros((cfg.max_agents, w), dtype=torch.int32,
                                device=dev)
        if team_r is None:
            team_r = torch.zeros((w,), device=dev)
        return PackedStepResult(obs=obs, rewards=rewards, dones=dones,
                                episode_results=ps.finished_scores,
                                team_reward=team_r)

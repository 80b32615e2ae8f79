"""Ray-sweep glue: ray queries and their consumption (plain PyTorch).

Port of the sweep functions of ``marl_hideandseek_tpu/env/observations.py``
(``obs_ray_queries``, ``action_ray_queries``, ``consume_obs_sweep``,
``reward_flag_from_vis``) with the world axis as a leading batch
dimension. ``st`` arguments are world-first views of the state
(``types.unpack_state`` without the copy: see ``world_first``).

Row conventions: each agent has T = (MAX_AGENTS - 1) + max_boxes +
max_ramps visibility targets (the other agent slots in slot order, the
boxes, the ramps) followed by 30 lidar rays; the grab/lock ray is one per
agent from the eye point along +y of the agent.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from marl_hideandseek_torch import math3d
from marl_hideandseek_torch.config import (
    INTERACT_RAY_LEN,
    LIDAR_MAX_RANGE,
    MAX_AGENTS,
    NUM_LIDAR_SAMPLES,
    VIS_FOV_DEGREES,
    EnvConfig,
)
from marl_hideandseek_torch.types import (
    AGENT_HIDER,
    AGENT_SEEKER,
    EnvState,
    body_slot_ranges,
)

COS_HALF_FOV = float(np.cos(np.deg2rad(VIS_FOV_DEGREES / 2.0)))


def world_first(ps: EnvState) -> EnvState:
    """Views of a packed state with the world axis moved first."""
    return ps.map(lambda x: torch.movedim(x, -1, 0))


def others_index_matrix(n_agents: int) -> np.ndarray:
    """[A, MAX_AGENTS-1] 'other' agent slots per agent (may exceed A-1)."""
    rows = []
    for i in range(n_agents):
        row = [j for j in range(MAX_AGENTS) if j != i]
        rows.append(row[: MAX_AGENTS - 1])
    return np.asarray(rows, np.int64)


def num_vis_targets(cfg: EnvConfig) -> int:
    return (MAX_AGENTS - 1) + cfg.max_boxes + cfg.max_ramps


def vis_target_slots(cfg: EnvConfig) -> np.ndarray:
    """[A, T] body slot of each visibility column (clamped others)."""
    n_a = cfg.max_agents
    (box_lo, box_hi), (ramp_lo, ramp_hi), (agent_lo, _) = \
        body_slot_ranges(cfg)
    o_safe = np.minimum(others_index_matrix(n_a), n_a - 1)
    return np.concatenate([
        agent_lo + o_safe,
        np.broadcast_to(np.arange(box_lo, box_hi)[None], (n_a, cfg.max_boxes)),
        np.broadcast_to(np.arange(ramp_lo, ramp_hi)[None],
                        (n_a, cfg.max_ramps)),
    ], axis=1)


def _vis_targets(cfg: EnvConfig, st: EnvState):
    """Per-agent target slots [A, T] and validity [W, A, T]."""
    n_a = cfg.max_agents
    dev = st.step.device
    others = torch.as_tensor(others_index_matrix(n_a), device=dev)
    o_in_range = others < n_a
    o_safe = torch.clamp(others, max=n_a - 1)
    o_active = st.agent_active[:, o_safe] & o_in_range       # [W, A, 5]
    box_obs = (torch.arange(cfg.max_boxes, device=dev) <
               st.num_active_boxes[:, None])                  # [W, NB]
    ramp_obs = (torch.arange(cfg.max_ramps, device=dev) <
                st.num_active_ramps[:, None])
    w = st.step.shape[0]
    tgt_valid = torch.cat([
        o_active,
        box_obs[:, None].expand(w, n_a, cfg.max_boxes),
        ramp_obs[:, None].expand(w, n_a, cfg.max_ramps),
    ], dim=2)
    slots = torch.as_tensor(vis_target_slots(cfg), device=dev)
    return slots, tgt_valid


def _agent_frames(cfg: EnvConfig, st: EnvState):
    _, _, (agent_lo, agent_hi) = body_slot_ranges(cfg)
    a_pos = st.bodies.pos[:, agent_lo:agent_hi]
    a_quat = st.bodies.quat[:, agent_lo:agent_hi]
    a_fwd = math3d.quat_rotate(a_quat, math3d.vec(math3d.FWD, a_pos))
    return a_pos, a_quat, a_fwd


def lidar_angles(device) -> tuple:
    """(cos, sin) of the 30 lidar directions in the agent frame [30]."""
    idx = torch.arange(NUM_LIDAR_SAMPLES, dtype=torch.float32, device=device)
    theta = 2.0 * math.pi * idx / NUM_LIDAR_SAMPLES + math.pi / 2.0
    return torch.cos(theta), torch.sin(theta)


def obs_ray_queries(cfg: EnvConfig, st: EnvState):
    """Visibility + lidar rays: (origins [W, R, 3], dirs [W, R, 3],
    max_t [W, R], exclude [W, R]), R = A * (T + 30). Visibility dirs are
    unnormalized target offsets (range 1); lidar dirs are unit (range
    200)."""
    n_a = cfg.max_agents
    _, _, (agent_lo, _) = body_slot_ranges(cfg)
    dev = st.step.device
    w = st.step.shape[0]
    a_pos, a_quat, a_fwd = _agent_frames(cfg, st)
    a_right = math3d.quat_rotate(a_quat, math3d.vec(math3d.RIGHT, a_pos))

    slots, _ = _vis_targets(cfg, st)
    n_tgt = slots.shape[1]
    to_tgt = st.bodies.pos[:, slots] - a_pos[:, :, None]       # [W, A, T, 3]
    vis_origins = a_pos[:, :, None].expand(w, n_a, n_tgt, 3)
    vis_maxt = torch.ones((w, n_a, n_tgt), device=dev)

    cos_t, sin_t = lidar_angles(dev)
    lidar_dirs = (cos_t[None, None, :, None] * a_right[:, :, None] +
                  sin_t[None, None, :, None] * a_fwd[:, :, None])
    lidar_dirs = lidar_dirs / torch.clamp(
        math3d.norm(lidar_dirs, keepdim=True), min=1e-9)
    lidar_origins = a_pos[:, :, None].expand(w, n_a, NUM_LIDAR_SAMPLES, 3)
    lidar_maxt = torch.full((w, n_a, NUM_LIDAR_SAMPLES), LIDAR_MAX_RANGE,
                            device=dev)

    self_slot = agent_lo + torch.arange(n_a, device=dev, dtype=torch.int32)
    excl = self_slot[None, :, None].expand(
        w, n_a, n_tgt + NUM_LIDAR_SAMPLES)

    origins = torch.cat([vis_origins, lidar_origins], dim=2)
    dirs = torch.cat([to_tgt, lidar_dirs], dim=2)
    maxt = torch.cat([vis_maxt, lidar_maxt], dim=2)
    return (origins.reshape(w, -1, 3), dirs.reshape(w, -1, 3),
            maxt.reshape(w, -1), excl.reshape(w, -1))


def action_ray_queries(cfg: EnvConfig, st: EnvState):
    """[W, A] grab/lock rays from the eye point along the agent's +y."""
    n_a = cfg.max_agents
    _, _, (agent_lo, _) = body_slot_ranges(cfg)
    a_pos, _, fwd = _agent_frames(cfg, st)
    eye = a_pos + math3d.vec((0.0, 0.0, 0.5), a_pos)
    w = st.step.shape[0]
    maxt = torch.full((w, n_a), INTERACT_RAY_LEN, device=a_pos.device)
    excl = (agent_lo + torch.arange(n_a, device=a_pos.device,
                                    dtype=torch.int32)).expand(w, n_a)
    return eye, fwd, maxt, excl


def consume_obs_sweep(cfg: EnvConfig, st: EnvState, hit_id, hit_t):
    """Obs-sweep hits [W, R] -> (vis_seen [W, A, T] f32, lidar [W, A, 30]).

    Seen: the nearest hit is the target, inside the 135-degree cone, the
    target slot valid and the observer active. Lidar: hit depth, 0 on a
    miss, zeroed for inactive agents."""
    n_a = cfg.max_agents
    a_pos, _, a_fwd = _agent_frames(cfg, st)
    a_active = st.agent_active
    slots, tgt_valid = _vis_targets(cfg, st)
    n_tgt = slots.shape[1]
    to_tgt = st.bodies.pos[:, slots] - a_pos[:, :, None]
    dist = math3d.norm(to_tgt)
    cos_angle = ((to_tgt * a_fwd[:, :, None]).sum(-1) /
                 torch.clamp(dist, min=1e-9))
    in_cone = cos_angle >= COS_HALF_FOV

    w = st.step.shape[0]
    hit_id = hit_id.reshape(w, n_a, n_tgt + NUM_LIDAR_SAMPLES)
    hit_t = hit_t.reshape(w, n_a, n_tgt + NUM_LIDAR_SAMPLES)
    vis_hit = hit_id[:, :, :n_tgt]
    seen = ((vis_hit == slots) & in_cone & tgt_valid &
            a_active[:, :, None])
    lidar_hit = hit_id[:, :, n_tgt:]
    lidar_t = hit_t[:, :, n_tgt:]
    lidar = torch.where(lidar_hit >= 0, lidar_t, 0.0)
    lidar = lidar * a_active[:, :, None].to(torch.float32)
    return seen.to(torch.float32), lidar


def reward_flag_from_vis(cfg: EnvConfig, st: EnvState, vis_seen):
    """[W] bool: some active seeker sees some hider (the agent columns of
    the visibility sweep)."""
    n_a = cfg.max_agents
    o_safe = torch.clamp(torch.as_tensor(others_index_matrix(n_a),
                                         device=vis_seen.device),
                         max=n_a - 1)
    is_seeker = st.agent_active & (st.agent_type == AGENT_SEEKER)
    col_is_hider = st.agent_type[:, o_safe] == AGENT_HIDER     # [W, A, 5]
    pair_seen = ((vis_seen[:, :, :MAX_AGENTS - 1] > 0.5) &
                 is_seeker[:, :, None] & col_is_hider)
    return pair_seen.flatten(1).any(dim=1)

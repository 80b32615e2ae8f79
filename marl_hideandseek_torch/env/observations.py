"""Ray-sweep glue and observation assembly.

Port of the sweep functions of ``marl_hideandseek_tpu/env/observations.py``
(``obs_ray_queries``, ``action_ray_queries``, ``consume_obs_sweep``,
``reward_flag_from_vis``) with the world axis as a leading batch
dimension. ``st`` arguments are world-first views of the state
(``types.unpack_state`` without the copy: see ``world_first``).

Observation assembly (``build_observations_packed``) runs the plain
PyTorch version (``build_observations_plain``) on CPU tensors and K6,
``csrc/observations.cu``, on CUDA tensors: one launch for all eleven
leaves, instead of the plain version's ~760 kernels dispatched one by
one from the host. K6 replaces no Pallas kernel, only XLA's fusion of
the jnp assembly (``marl_hideandseek_tpu/env/observations.py:226``).
Bytes bound it (~1.7 KB read and ~5.0 KB written a 2v2 world, 0.13 ms at
65,536 worlds on 3.35 TB/s): a block stages a tile of worlds' inputs in
shared memory with coalesced loads, computes each (world, agent, entity)
row there and writes each leaf's contiguous range (the source's note).

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
from marl_hideandseek_torch.ops.build import CudaKernel
from marl_hideandseek_torch.ops.common import (
    ARRAY_ENTRY,
    check_view,
    launch_arrays,
)
from marl_hideandseek_torch.types import (
    AGENT_HIDER,
    AGENT_SEEKER,
    OWNER_HIDER,
    EnvState,
    body_slot_ranges,
)
from marl_hideandseek_torch.utils import tracing

COS_HALF_FOV = float(np.cos(np.deg2rad(VIS_FOV_DEGREES / 2.0)))


def world_first(ps: EnvState) -> EnvState:
    """Views of a packed state with the world axis moved first."""
    return ps.map(lambda x: torch.movedim(x, -1, 0))


def world_last(state: EnvState) -> EnvState:
    """Views of a world-major state with the world axis moved last: the
    packed layout, without the copy of ``types.pack_state``."""
    return state.map(lambda x: torch.movedim(x, 0, -1))


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
    with tracing.span("host_read.sweep_consts"):
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
    with tracing.span("host_read.sweep_consts"):
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
    with tracing.span("host_read.sweep_consts"):
        others = torch.as_tensor(others_index_matrix(n_a),
                                 device=vis_seen.device)
    o_safe = torch.clamp(others, max=n_a - 1)
    is_seeker = st.agent_active & (st.agent_type == AGENT_SEEKER)
    col_is_hider = st.agent_type[:, o_safe] == AGENT_HIDER     # [W, A, 5]
    pair_seen = ((vis_seen[:, :, :MAX_AGENTS - 1] > 0.5) &
                 is_seeker[:, :, None] & col_is_hider)
    return pair_seen.flatten(1).any(dim=1)


# ---------------------------------------------------------------------------
# Observation assembly (packed.py:343, observations.py:226-355)
# ---------------------------------------------------------------------------


def _lock_obs(locked, owner):
    lk = locked.to(torch.float32)
    return [lk * (owner == OWNER_HIDER), lk * (owner != OWNER_HIDER)]


def build_observations_packed(cfg: EnvConfig, ps: EnvState, vis_seen, lidar):
    """Flat-feature observations from packed state and the sweep
    (vis_seen [A, T, W], lidar [A, 30, W]); leaves [W, A, F]
    (``observation_leaves``). CPU tensors take the plain version, CUDA
    tensors K6."""
    if ps.step.device.type == "cpu":
        return build_observations_plain(cfg, ps, vis_seen, lidar)
    return build_observations_kernel(cfg, ps, vis_seen, lidar)


def build_observations_plain(cfg: EnvConfig, ps: EnvState, vis_seen, lidar):
    """Plain PyTorch version of ``build_observations_packed``."""
    n_a = cfg.max_agents
    (box_lo, box_hi), (ramp_lo, ramp_hi), (agent_lo, agent_hi) = \
        body_slot_ranges(cfg)
    b = ps.bodies
    w = ps.step.shape[0]
    dev = ps.step.device

    def comps(arr, lo, hi, n):
        return tuple(arr[lo:hi, k] for k in range(n))

    a_pos = comps(b.pos, agent_lo, agent_hi, 3)
    a_quat = comps(b.quat, agent_lo, agent_hi, 4)
    a_vel = comps(b.vel, agent_lo, agent_hi, 3)
    a_omega = comps(b.omega, agent_lo, agent_hi, 3)
    a_inv_q = math3d.qconj(a_quat)
    act_f = ps.agent_active.to(torch.float32)
    is_grabbing = (ps.grab.target >= 0).to(torch.float32)

    def to_wa(feats, dim=1):
        st = torch.stack(feats, dim=dim)
        if st.dim() == 4:                                 # [A, E, F, W]
            st = st.reshape(st.shape[0], -1, st.shape[3])
        return torch.movedim(st, -1, 0).contiguous()

    prep = torch.clamp(cfg.num_prep_steps - ps.step, min=0).to(torch.int32)
    prep_counter = prep[:, None, None].expand(w, n_a, 1).contiguous()

    vel_l = math3d.qrot(a_inv_q, a_vel)
    om_l = math3d.qrot(a_inv_q, a_omega)
    self_feats = (list(a_pos) + list(math3d.euler(a_quat)) + list(vel_l) +
                  list(om_l) + [is_grabbing])
    self_data = to_wa([f * act_f for f in self_feats])
    self_type = torch.movedim(ps.agent_type[:, None], -1, 0).contiguous()
    self_mask = torch.movedim(act_f[:, None], -1, 0).contiguous()

    def exp_a(c):
        return tuple(x[:, None] for x in c)

    def exp_e(c):
        return tuple(x[None] for x in c)

    def entity_feats(lo, hi):
        return math3d.rel_posvel(
            exp_a(a_pos), exp_a(a_inv_q), exp_a(a_vel), exp_a(a_omega),
            exp_e(comps(b.pos, lo, hi, 3)), exp_e(comps(b.quat, lo, hi, 4)),
            exp_e(comps(b.vel, lo, hi, 3)), exp_e(comps(b.omega, lo, hi, 3)))

    box_feats = entity_feats(box_lo, box_hi)
    shape = box_feats[0].shape
    box_size = [(2.0 * b.half_ext[box_lo:box_hi, k])[None].expand(shape)
                for k in range(3)]
    box_lock = [f[None].expand(shape) for f in
                _lock_obs(b.locked[box_lo:box_hi], b.owner[box_lo:box_hi])]
    box_observed = (torch.arange(cfg.max_boxes, device=dev)[:, None] <
                    ps.num_active_boxes[None, :])
    box_gate = box_observed[None].to(torch.float32) * act_f[:, None, :]
    box_data = to_wa([f * box_gate for f in box_feats + box_size + box_lock],
                     dim=2)

    ramp_feats = entity_feats(ramp_lo, ramp_hi)
    rshape = ramp_feats[0].shape
    ramp_lock = [f[None].expand(rshape) for f in
                 _lock_obs(b.locked[ramp_lo:ramp_hi],
                           b.owner[ramp_lo:ramp_hi])]
    ramp_observed = (torch.arange(cfg.max_ramps, device=dev)[:, None] <
                     ps.num_active_ramps[None, :])
    ramp_gate = ramp_observed[None].to(torch.float32) * act_f[:, None, :]
    ramp_data = to_wa([f * ramp_gate for f in ramp_feats + ramp_lock], dim=2)

    others = others_index_matrix(n_a)
    with tracing.span("host_read.obs_consts"):
        o_in_range = torch.as_tensor(others < n_a, device=dev)
    with tracing.span("host_read.obs_consts"):
        o_safe = torch.as_tensor(np.minimum(others, n_a - 1), device=dev)

    def gather_o(c):
        return tuple(x[o_safe] for x in c)                # [A, 5, W]

    o_active = ps.agent_active[o_safe] & o_in_range[:, :, None]
    ag_feats = math3d.rel_posvel(
        exp_a(a_pos), exp_a(a_inv_q), exp_a(a_vel), exp_a(a_omega),
        gather_o(a_pos), gather_o(a_quat), gather_o(a_vel),
        gather_o(a_omega))
    o_is_hider = (ps.agent_type[o_safe] == AGENT_HIDER).to(torch.float32)
    o_grabbing = is_grabbing[o_safe]
    ag_gate = o_active.to(torch.float32) * act_f[:, None, :]
    agent_data = to_wa([f * ag_gate for f in ag_feats +
                        [o_is_hider, o_grabbing]], dim=2)

    t_agents = MAX_AGENTS - 1
    return {
        "prep_counter": prep_counter,
        "self_data": self_data,
        "self_type": self_type,
        "self_mask": self_mask,
        "self_lidar": torch.movedim(lidar, -1, 0).contiguous(),
        "agent_data": agent_data,
        "box_data": box_data,
        "ramp_data": ramp_data,
        "vis_agents_mask": torch.movedim(vis_seen[:, :t_agents], -1,
                                         0).contiguous(),
        "vis_boxes_mask": torch.movedim(
            vis_seen[:, t_agents:t_agents + cfg.max_boxes], -1,
            0).contiguous(),
        "vis_ramps_mask": torch.movedim(
            vis_seen[:, t_agents + cfg.max_boxes:], -1, 0).contiguous(),
    }


# K6: observation assembly in one launch (csrc/observations.cu).
OBSERVATIONS = CudaKernel("observations", "mhs_observations", ARRAY_ENTRY)


def observation_leaves(cfg: EnvConfig) -> list:
    """The assembly's leaves in K6's output order: (name, F, dtype) of
    each ``[W, A, F]`` leaf."""
    t = MAX_AGENTS - 1
    f32, i32 = torch.float32, torch.int32
    return [("prep_counter", 1, i32), ("self_data", 13, f32),
            ("self_type", 1, i32), ("self_mask", 1, f32),
            ("self_lidar", NUM_LIDAR_SAMPLES, f32),
            ("agent_data", t * 14, f32),
            ("box_data", cfg.max_boxes * 17, f32),
            ("ramp_data", cfg.max_ramps * 14, f32),
            ("vis_agents_mask", t, f32),
            ("vis_boxes_mask", cfg.max_boxes, f32),
            ("vis_ramps_mask", cfg.max_ramps, f32)]


def observation_inputs(cfg: EnvConfig, ps: EnvState, vis_seen, lidar):
    """What one K6 launch reads, in csrc/observations.cu's input order: a
    list of (tensor, shape without the world axis, dtype)."""
    nb, na = cfg.num_dyn_bodies, cfg.max_agents
    b = ps.bodies
    f32, i32, bool_ = torch.float32, torch.int32, torch.bool
    return [
        (b.pos, (nb, 3), f32), (b.quat, (nb, 4), f32), (b.vel, (nb, 3), f32),
        (b.omega, (nb, 3), f32), (b.half_ext, (nb, 3), f32),
        (b.locked, (nb,), bool_), (b.owner, (nb,), i32),
        (ps.grab.target, (na,), i32), (ps.agent_type, (na,), i32),
        (ps.agent_active, (na,), bool_), (ps.num_active_boxes, (), i32),
        (ps.num_active_ramps, (), i32), (ps.step, (), i32),
        (vis_seen, (na, num_vis_targets(cfg)), f32),
        (lidar, (na, NUM_LIDAR_SAMPLES), f32),
    ]


def observation_params(cfg: EnvConfig, ps: EnvState, vis_seen, lidar):
    """Checked input pointers and the ints of one K6 launch: the world
    count, the entity counts, the preparation steps, then each input's
    element strides (row dimensions padded with 0, then the world axis),
    so that any layout is read as it lies."""
    dev = ps.step.device
    w = ps.step.shape[-1]
    ptrs, strides = [], []
    for i, (t, shape, dt) in enumerate(
            observation_inputs(cfg, ps, vis_seen, lidar)):
        shape = (*shape, w)
        # check_view's tests, inline since this runs every step;
        # check_view raises with the reason.
        if t.device != dev or t.dtype != dt or t.shape != shape:
            check_view(t, f"observations input {i}", shape, dt, dev)
        ptrs.append(t.data_ptr())
        st = t.stride()
        strides += [*st[:-1], *(0,) * (3 - len(st)), st[-1]]
    if max(strides) >= 2 ** 31:
        raise ValueError("observations: a stride exceeds the kernel's int")
    iparams = [w, cfg.max_boxes, cfg.max_ramps, cfg.max_agents,
               cfg.num_prep_steps, *strides]
    return ptrs, iparams


def build_observations_kernel(cfg: EnvConfig, ps: EnvState, vis_seen,
                              lidar) -> dict:
    """K6: ``build_observations_plain``'s leaves in one launch, from
    CUDA tensors in any layout. Raises on another device, dtype or
    shape."""
    dev = ps.step.device
    if dev.type != "cuda":
        raise ValueError(f"observations kernel: state on {dev}, expected a "
                         f"CUDA device")
    ptrs, iparams = observation_params(cfg, ps, vis_seen, lidar)
    out = observation_outputs(cfg, iparams[0], dev)
    launch_arrays(OBSERVATIONS, ptrs + [t.data_ptr() for t in out.values()],
                  iparams, [], dev)
    return out


def observation_outputs(cfg: EnvConfig, w: int, device) -> dict:
    """K6's leaves as contiguous views of one allocation (one call to the
    caching allocator, not eleven: the wrapper's host time is the card's
    idle time after the reset trigger's read), each starting on a
    16-byte boundary, where the kernel's bulk copies need it."""
    na = cfg.max_agents
    leaves = observation_leaves(cfg)
    sizes = [-(-w * na * f // 4) * 4 for _, f, _ in leaves]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    out, at = {}, 0
    for (name, f, dt), n in zip(leaves, sizes):
        leaf = buf.as_strided((w, na, f), (na * f, f, 1), at)
        out[name] = leaf if dt == torch.float32 else leaf.view(dt)
        at += n
    return out


def reference_obs(cfg: EnvConfig, obs: dict) -> dict:
    """Flat-feature dict -> the reference's exported shapes."""
    w, n_a = obs["self_data"].shape[:2]
    return {
        **obs,
        "agent_data": obs["agent_data"].reshape(w, n_a, MAX_AGENTS - 1, 14),
        "box_data": obs["box_data"].reshape(w, n_a, cfg.max_boxes, 17),
        "ramp_data": obs["ramp_data"].reshape(w, n_a, cfg.max_ramps, 14),
        "vis_agents_mask": obs["vis_agents_mask"][..., None],
        "vis_boxes_mask": obs["vis_boxes_mask"][..., None],
        "vis_ramps_mask": obs["vis_ramps_mask"][..., None],
    }


def global_debug_positions(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """[W, max_boxes + max_ramps + MAX_AGENTS, 2] xy positions of the
    observed bodies, zero elsewhere (reference: globalPositionsDebugSystem
    src/sim.cpp:895-941), world-major state."""
    (box_lo, box_hi), (ramp_lo, ramp_hi), (agent_lo, agent_hi) = \
        body_slot_ranges(cfg)
    b = state.bodies
    dev = b.pos.device
    box_on = torch.arange(cfg.max_boxes, device=dev) < \
        state.num_active_boxes[:, None]
    ramp_on = torch.arange(cfg.max_ramps, device=dev) < \
        state.num_active_ramps[:, None]
    out = torch.cat([
        b.pos[:, box_lo:box_hi, :2] * box_on[..., None],
        b.pos[:, ramp_lo:ramp_hi, :2] * ramp_on[..., None],
        b.pos[:, agent_lo:agent_hi, :2] * state.agent_active[..., None],
    ], dim=1)
    pad = cfg.max_boxes + cfg.max_ramps + MAX_AGENTS - out.shape[1]
    return torch.nn.functional.pad(out, (0, 0, 0, pad))

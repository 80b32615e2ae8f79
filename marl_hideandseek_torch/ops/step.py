"""K4: the megastep - the whole packed step before resets.

``megastep_plain`` is the port's one composition of the step's systems:
movement, grab/lock, a physics-and-sweep phase, agent zero-velocity,
rewards, dones and episode scores. Its three phases: the plain K3
(``ops/fused.py::fused_step_plain``), which makes the plain megastep, the
JAX package's fallback branch (env/packed.py:576-595); K3
(``fused_step_packed``), the classic env's step; K2 then the standalone
sweep, the classic env's unfused branch (``env/env.py``).

``megastep_packed`` launches ``csrc/megastep.cu`` for CUDA tensors: one
warp per world (its lanes over the world's bodies, contact slots, agents
and rays) runs the whole composition - movement decode, grab/lock, the
XPBD physics step, agent zero-velocity, the ray sweep (visibility, lidar,
next-step grab/lock rays, the seeker-sees-hider flag), rewards, dones and
episode scores. For CPU tensors it runs the plain megastep. Replaces
``marl_hideandseek_tpu/ops/pallas_step.py::megastep_packed``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from marl_hideandseek_torch.config import (
    INTERACT_RAY_LEN,
    LIDAR_MAX_RANGE,
    MAX_WALLS,
    NUM_LIDAR_SAMPLES,
    NUM_PREP_STEPS,
    EnvConfig,
)
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.ops import fused as ops_fused
from marl_hideandseek_torch.ops.build import CudaKernel
from marl_hideandseek_torch.ops.common import (
    ARRAY_ENTRY,
    as_f32,
    check,
    launch_arrays,
    wall_bound,
)
from marl_hideandseek_torch.types import EnvState, SweepResults

MEGASTEP = CudaKernel("megastep", "mhs_megastep", ARRAY_ENTRY)


def megastep_occupancy() -> Dict[str, int]:
    """Launch shape and occupancy of ``csrc/megastep.cu``'s three kernels
    on the current card: worlds per block, shared bytes per world, and the
    blocks and worlds resident per SM of K4 (megastep), K2 (physics) and
    K3 (fused), as the CUDA runtime reckons them from the registers and
    shared memory of each."""
    import ctypes

    from marl_hideandseek_torch.ops.build import load

    fn = load("megastep").mhs_megastep_occupancy
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"mhs_megastep_occupancy failed: cudaError {err}")
    per_block = out[0]
    res = {"worlds_per_block": per_block, "smem_bytes_per_world": out[1]}
    for name, blocks in zip(("megastep", "physics", "fused"), out[2:5]):
        res[f"{name}_blocks_per_sm"] = blocks
        res[f"{name}_worlds_per_sm"] = blocks * per_block
    return res


def megastep_plain(cfg: EnvConfig, ps: EnvState, actions: torch.Tensor,
                   tally: Optional[Dict[str, int]] = None,
                   phase: Optional[Callable] = None):
    """The step's systems around a physics-and-sweep ``phase(cfg, ps,
    ext_force, ext_torque) -> (bodies, SweepResults)``, by default the
    plain K3 (``fused_step_plain``, which ``tally`` is passed to: the
    physics' work counts). actions [A, 5, W] i32 -> (ps2, SweepResults,
    rewards [A, W] f32, dones [A, W] i32, team_r [W] f32). ps2 has the
    new bodies, locks, grabs, scores and team reward; step bookkeeping is
    left to the caller."""
    from marl_hideandseek_torch.env import packed as P

    if phase is None:
        phase = functools.partial(ops_fused.fused_step_plain, tally=tally)
    ext_force, ext_torque = P.movement_packed(cfg, ps, actions)
    ps = P.action_system_packed(cfg, ps, actions, ps.act_hit_t,
                                ps.act_hit_id)
    bodies, sweep = phase(cfg, ps, ext_force, ext_torque)
    ps = ps.replace(bodies=bodies)
    if cfg.zero_agent_velocity:
        ps = P.zero_agent_velocities_packed(cfg, ps)
    team_r = torch.where(sweep.rew_seen, -1.0, 1.0)
    ps = ps.replace(hider_team_reward=team_r)
    rewards, dones = P.rewards_dones_packed(cfg, ps, team_r)
    ps = P.episode_results_packed(cfg, ps, team_r)
    return ps, sweep, rewards, dones, team_r


def megastep_packed(cfg: EnvConfig, ps: EnvState, actions: torch.Tensor):
    """The step before resets; see ``megastep_plain`` for the contract.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if ps.step.device.type == "cpu":
        return megastep_plain(cfg, ps, actions)
    return _megastep_cuda(cfg, ps, actions)


def megastep_inputs(cfg: EnvConfig, ps: EnvState, actions: torch.Tensor):
    """What one megastep launch reads, in MegaArgs' pointer order
    (csrc/megastep.cu): a list of (tensor, shape without the world axis,
    dtype)."""
    nb, na = cfg.num_dyn_bodies, cfg.max_agents
    b, s, g = ps.bodies, ps.statics, ps.grab
    n_wall = s.wall_active.shape[0]
    n_plane = s.plane_active.shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    return [
        (b.pos, (nb, 3), f32), (b.quat, (nb, 4), f32), (b.vel, (nb, 3), f32),
        (b.omega, (nb, 3), f32), (b.inv_mass, (nb,), f32),
        (b.inv_inertia, (nb, 3), f32), (b.active.view(u8), (nb,), u8),
        (b.locked.view(u8), (nb,), u8), (b.owner, (nb,), i32),
        (b.half_ext, (nb, 3), f32), (b.friction_mu, (nb,), f32),
        (s.wall_pos, (n_wall, 3), f32), (s.wall_half_ext, (n_wall, 3), f32),
        (s.wall_active.view(u8), (n_wall,), u8),
        (s.plane_point, (n_plane, 3), f32),
        (s.plane_normal, (n_plane, 3), f32),
        (s.plane_active.view(u8), (n_plane,), u8),
        (g.target, (na,), i32), (g.r2, (na, 3), f32),
        (g.rel_q, (na, 4), f32), (g.sep, (na,), f32),
        (ps.agent_type, (na,), i32), (ps.agent_active.view(u8), (na,), u8),
        (ps.num_active_boxes, (), i32), (ps.num_active_ramps, (), i32),
        (actions, (na, 5), i32), (ps.act_hit_t, (na,), f32),
        (ps.act_hit_id, (na,), i32), (ps.step, (), i32),
        (ps.seekers_first.view(u8), (), u8), (ps.running_scores, (2,), i32),
        (ps.finished_scores, (2,), f32),
    ]


def megastep_buffers(cfg: EnvConfig, ps: EnvState, actions: torch.Tensor):
    """Checked input pointers, allocated outputs and the scalar parameters
    of one megastep launch: (ptrs, iparams, fparams, outputs, keepalive).
    The pointer order is MegaArgs' in csrc/megastep.cu."""
    from marl_hideandseek_torch.env.packed import movement_scales

    dev = ps.step.device
    w = ps.step.shape[0]
    nb, na = cfg.num_dyn_bodies, cfg.max_agents
    n_tgt = obs_mod.num_vis_targets(cfg)
    s = ps.statics
    n_wall = s.wall_active.shape[0]
    n_plane = s.plane_active.shape[0]
    if n_wall != MAX_WALLS or n_plane > 3:
        raise ValueError("megastep: wall/plane slots exceed the kernel's")
    f32, i32 = torch.float32, torch.int32

    ins = megastep_inputs(cfg, ps, actions)
    ptrs = [check(t, f"megastep input {i}", shape + (w,), dt, dev)
            for i, (t, shape, dt) in enumerate(ins)]
    bound = wall_bound(s.wall_active)
    cos_t, sin_t = obs_mod.lidar_angles(dev)
    lidar_cs = torch.stack([cos_t, sin_t]).contiguous()
    ptrs += [bound.data_ptr(), lidar_cs.data_ptr()]

    e = lambda *shape, dtype=f32: torch.empty(shape + (w,), dtype=dtype,
                                              device=dev)
    out = dict(
        pos=e(nb, 3), quat=e(nb, 4), vel=e(nb, 3), omega=e(nb, 3),
        locked=e(nb, dtype=torch.bool), owner=e(nb, dtype=i32),
        g_target=e(na, dtype=i32), g_r2=e(na, 3), g_relq=e(na, 4),
        g_sep=e(na), vis=e(na, n_tgt), lidar=e(na, NUM_LIDAR_SAMPLES),
        act_t=e(na), act_id=e(na, dtype=i32), rew_seen=e(dtype=torch.bool),
        rewards=e(na), dones=e(na, dtype=i32), team_r=e(),
        running=e(2, dtype=i32), finished=e(2))
    ptrs += [t.data_ptr() for t in out.values()]

    half, f_per, t_per = movement_scales(cfg)
    h = cfg.dt / cfg.num_physics_substeps
    iparams = [w, cfg.max_boxes, cfg.max_ramps, na, n_wall, n_plane, n_tgt,
               int(cfg.zero_agent_velocity), cfg.episode_len,
               cfg.num_physics_substeps, half, NUM_PREP_STEPS]
    fparams = [as_f32(v) for v in (
        cfg.dt, h, f_per, t_per, 2.0 / h, cfg.restitution, 2.0 * 9.8 * h,
        obs_mod.COS_HALF_FOV, INTERACT_RAY_LEN, LIDAR_MAX_RANGE)]
    return ptrs, iparams, fparams, out, (bound, lidar_cs)


def megastep_results(ps: EnvState, out: dict):
    """Launch outputs -> (ps2, SweepResults, rewards, dones, team_r)."""
    b, g = ps.bodies, ps.grab
    ps2 = ps.replace(
        bodies=b.replace(pos=out["pos"], quat=out["quat"], vel=out["vel"],
                         omega=out["omega"], locked=out["locked"],
                         owner=out["owner"]),
        grab=g.replace(target=out["g_target"], r2=out["g_r2"],
                       rel_q=out["g_relq"], sep=out["g_sep"]),
        hider_team_reward=out["team_r"],
        running_scores=out["running"],
        finished_scores=out["finished"])
    sweep = SweepResults(vis_seen=out["vis"], lidar=out["lidar"],
                         act_t=out["act_t"], act_id=out["act_id"],
                         rew_seen=out["rew_seen"])
    return ps2, sweep, out["rewards"], out["dones"], out["team_r"]


def _megastep_cuda(cfg: EnvConfig, ps: EnvState, actions: torch.Tensor):
    # `_keep` holds the inputs made here until the launch is queued.
    ptrs, iparams, fparams, out, _keep = megastep_buffers(cfg, ps, actions)
    launch_arrays(MEGASTEP, ptrs, iparams, fparams, ps.step.device)
    return megastep_results(ps, out)

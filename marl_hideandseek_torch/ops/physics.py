"""K2: the XPBD physics step on its own.

``physics_packed`` launches ``csrc/megastep.cu``'s ``mhs_physics`` for
CUDA tensors: one warp per world runs the ``physics_step`` device
function that the megastep (K4) and the fused step (K3) run too. For CPU
tensors it runs the plain version, ``env/physics.py::physics_step``.
Replaces ``marl_hideandseek_tpu/ops/pallas_physics.py::
physics_step_batch`` (``_physics_pallas``). The classic env's unfused
branch is its one caller in the program.

The launch arguments (``physics_inputs``, ``step_params``) are shared with
K3 (``ops/fused.py``): its pointer list starts with this one.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from marl_hideandseek_torch.config import (
    INTERACT_RAY_LEN,
    LIDAR_MAX_RANGE,
    MAX_WALLS,
    EnvConfig,
)
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env import physics
from marl_hideandseek_torch.ops.build import CudaKernel
from marl_hideandseek_torch.ops.common import (
    ARRAY_ENTRY,
    as_f32,
    check,
    launch_arrays,
)
from marl_hideandseek_torch.types import RigidBodies

PHYSICS = CudaKernel("megastep", "mhs_physics", ARRAY_ENTRY)


def physics_inputs(cfg: EnvConfig, bodies, statics, grab, ext_force,
                   ext_torque):
    """What the physics block of a K2/K3 launch reads, in StepArgs'
    pointer order (csrc/megastep.cu), packed: a list of (tensor, shape
    without the world axis, dtype)."""
    nb, na = cfg.num_dyn_bodies, cfg.max_agents
    b, s, g = bodies, statics, grab
    n_wall = s.wall_active.shape[0]
    n_plane = s.plane_active.shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    return [
        (b.pos, (nb, 3), f32), (b.quat, (nb, 4), f32), (b.vel, (nb, 3), f32),
        (b.omega, (nb, 3), f32), (b.inv_mass, (nb,), f32),
        (b.inv_inertia, (nb, 3), f32), (b.active.view(u8), (nb,), u8),
        (b.locked.view(u8), (nb,), u8), (b.half_ext, (nb, 3), f32),
        (b.friction_mu, (nb,), f32), (ext_force, (nb, 3), f32),
        (ext_torque, (nb, 3), f32),
        (s.wall_pos, (n_wall, 3), f32), (s.wall_half_ext, (n_wall, 3), f32),
        (s.wall_active.view(u8), (n_wall,), u8),
        (s.plane_point, (n_plane, 3), f32),
        (s.plane_normal, (n_plane, 3), f32),
        (s.plane_active.view(u8), (n_plane,), u8),
        (g.target, (na,), i32), (g.r2, (na, 3), f32),
        (g.rel_q, (na, 4), f32), (g.sep, (na,), f32),
    ]


def step_params(cfg: EnvConfig, statics, w: int):
    """The (ints, floats) of a K2/K3 launch, in StepArgs' order."""
    n_wall = statics.wall_active.shape[0]
    n_plane = statics.plane_active.shape[0]
    if n_wall != MAX_WALLS or n_plane > 3:
        raise ValueError("physics: wall/plane slots exceed the kernel's")
    h = cfg.dt / cfg.num_physics_substeps
    iparams = [w, cfg.max_boxes, cfg.max_ramps, cfg.max_agents, n_wall,
               n_plane, obs_mod.num_vis_targets(cfg),
               cfg.num_physics_substeps]
    fparams = [as_f32(v) for v in (
        cfg.dt, h, 2.0 / h, cfg.restitution, 2.0 * 9.8 * h,
        obs_mod.COS_HALF_FOV, INTERACT_RAY_LEN, LIDAR_MAX_RANGE)]
    return iparams, fparams


def checked(ins, w: int, device, what: str):
    """Data pointers of ``ins`` (see ``physics_inputs``), checked."""
    return [check(t, f"{what} input {i}", shape + (w,), dt, device)
            for i, (t, shape, dt) in enumerate(ins)]


def body_outputs(cfg: EnvConfig, w: int, device) -> Dict[str, torch.Tensor]:
    nb = cfg.num_dyn_bodies
    e = lambda *shape: torch.empty(shape + (w,), device=device)
    return dict(pos=e(nb, 3), quat=e(nb, 4), vel=e(nb, 3), omega=e(nb, 3))


def physics_plain(cfg: EnvConfig, bodies, statics, grab, ext_force,
                  ext_torque, tally: Optional[Dict[str, int]] = None
                  ) -> RigidBodies:
    """Plain version on packed subtrees: ``env/physics.py::physics_step``
    on world-first views; returns the packed bodies with the new pose and
    velocities. ``tally`` collects the physics' work counts."""
    wf = lambda x: torch.movedim(x, -1, 0)
    pos, quat, vel, omega = physics.physics_step(
        cfg, bodies.map(wf), statics.map(wf), grab.map(wf), wf(ext_force),
        wf(ext_torque), tally=tally)
    pk = lambda x: torch.movedim(x, 0, -1).contiguous()
    return bodies.replace(pos=pk(pos), quat=pk(quat), vel=pk(vel),
                          omega=pk(omega))


def physics_packed(cfg: EnvConfig, bodies, statics, grab, ext_force,
                   ext_torque) -> RigidBodies:
    """One physics step of packed ``bodies`` / ``statics`` / ``grab``
    under ``ext_force, ext_torque [B, 3, W]``; returns the new bodies.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if bodies.pos.device.type == "cpu":
        return physics_plain(cfg, bodies, statics, grab, ext_force,
                             ext_torque)
    ptrs, iparams, fparams, out = physics_buffers(
        cfg, bodies, statics, grab, ext_force, ext_torque)
    launch_arrays(PHYSICS, ptrs, iparams, fparams, bodies.pos.device)
    return bodies.replace(**out)


def physics_buffers(cfg: EnvConfig, bodies, statics, grab, ext_force,
                    ext_torque):
    """Checked input pointers, allocated outputs and the scalar parameters
    of one K2 launch: (ptrs, iparams, fparams, outputs)."""
    dev = bodies.pos.device
    w = bodies.pos.shape[-1]
    ptrs = checked(physics_inputs(cfg, bodies, statics, grab, ext_force,
                                  ext_torque), w, dev, "physics")
    out = body_outputs(cfg, w, dev)
    ptrs += [t.data_ptr() for t in out.values()]
    return (ptrs, *step_params(cfg, statics, w), out)

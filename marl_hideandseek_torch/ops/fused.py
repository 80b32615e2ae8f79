"""K3: the physics step fused with the post-physics ray sweep.

``fused_step_packed`` launches ``csrc/megastep.cu``'s ``mhs_fused`` for
CUDA tensors: one warp per world runs the ``physics_step`` and ``sweep``
device functions that the megastep (K4) runs too - visibility, lidar, the
next step's grab/lock rays and the seeker-sees-hider flag on the moved
bodies, with the sweep's wall loop bounded by the batch's largest
active-wall count (computed on the device, no host sync). For CPU tensors
it runs the plain version, ``fused_step_plain``: the plain physics, then
``standalone_sweep_packed`` with the plain raycast - the composite the
JAX kernel is tested against (tests/test_pallas_kernels.py:70-146).
Replaces ``marl_hideandseek_tpu/ops/pallas_step.py::fused_step_packed``
(``_fused_pallas``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from marl_hideandseek_torch.config import NUM_LIDAR_SAMPLES, EnvConfig
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.ops import physics as ops_physics
from marl_hideandseek_torch.ops import rays as ops_rays
from marl_hideandseek_torch.ops.build import CudaKernel
from marl_hideandseek_torch.ops.common import (
    ARRAY_ENTRY,
    launch_arrays,
    wall_bound,
)
from marl_hideandseek_torch.types import EnvState, RigidBodies, SweepResults

FUSED = CudaKernel("megastep", "mhs_fused", ARRAY_ENTRY)


def fused_inputs(cfg: EnvConfig, ps: EnvState, ext_force, ext_torque):
    """What one K3 launch reads with the world axis, in StepArgs' pointer
    order: the physics block, then the sweep's per-world inputs."""
    na = cfg.max_agents
    i32, u8 = torch.int32, torch.uint8
    return ops_physics.physics_inputs(
        cfg, ps.bodies, ps.statics, ps.grab, ext_force, ext_torque) + [
        (ps.agent_type, (na,), i32), (ps.agent_active.view(u8), (na,), u8),
        (ps.num_active_boxes, (), i32), (ps.num_active_ramps, (), i32),
    ]


def fused_step_plain(cfg: EnvConfig, ps: EnvState, ext_force, ext_torque,
                     tally: Optional[Dict[str, int]] = None):
    """Plain version: packed ``ps``, ``ext_force, ext_torque [B, 3, W]``
    -> (bodies, SweepResults), packed. ``tally`` collects the physics'
    work counts."""
    from marl_hideandseek_torch.env.packed import standalone_sweep_packed

    bodies = ops_physics.physics_plain(cfg, ps.bodies, ps.statics, ps.grab,
                                       ext_force, ext_torque, tally=tally)
    sweep = standalone_sweep_packed(cfg, ps.replace(bodies=bodies),
                                    raycast=ops_rays.raycast_packed_plain)
    return bodies, sweep


def fused_step_packed(cfg: EnvConfig, ps: EnvState, ext_force, ext_torque):
    """Physics, then the sweep on the moved bodies; see
    ``fused_step_plain`` for the contract. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if ps.step.device.type == "cpu":
        return fused_step_plain(cfg, ps, ext_force, ext_torque)
    return _fused_cuda(cfg, ps, ext_force, ext_torque)


def fused_buffers(cfg: EnvConfig, ps: EnvState, ext_force, ext_torque):
    """Checked input pointers, allocated outputs and the scalar parameters
    of one K3 launch: (ptrs, iparams, fparams, body outputs, sweep
    outputs, keepalive). The pointer order is StepArgs' in
    csrc/megastep.cu."""
    dev = ps.step.device
    w = ps.step.shape[0]
    na = cfg.max_agents
    n_tgt = obs_mod.num_vis_targets(cfg)
    ins = ops_physics.checked(fused_inputs(cfg, ps, ext_force, ext_torque),
                              w, dev, "fused")
    n_phys = len(ins) - 4              # the sweep block's four inputs
    out = ops_physics.body_outputs(cfg, w, dev)
    ptrs = ins[:n_phys] + [t.data_ptr() for t in out.values()] + ins[n_phys:]
    bound = wall_bound(ps.statics.wall_active)
    cos_t, sin_t = obs_mod.lidar_angles(dev)
    lidar_cs = torch.stack([cos_t, sin_t]).contiguous()
    e = lambda *shape, dtype=torch.float32: torch.empty(
        shape + (w,), dtype=dtype, device=dev)
    sweep = SweepResults(vis_seen=e(na, n_tgt),
                         lidar=e(na, NUM_LIDAR_SAMPLES), act_t=e(na),
                         act_id=e(na, dtype=torch.int32),
                         rew_seen=e(dtype=torch.bool))
    ptrs += [bound.data_ptr(), lidar_cs.data_ptr()]
    ptrs += [t.data_ptr() for t in sweep]
    iparams, fparams = ops_physics.step_params(cfg, ps.statics, w)
    return ptrs, iparams, fparams, out, sweep, (bound, lidar_cs)


def _fused_cuda(cfg: EnvConfig, ps: EnvState, ext_force, ext_torque):
    # `_keep` holds the inputs made here until the launch is queued.
    ptrs, iparams, fparams, out, sweep, _keep = fused_buffers(
        cfg, ps, ext_force, ext_torque)
    launch_arrays(FUSED, ptrs, iparams, fparams, ps.step.device)
    bodies: RigidBodies = ps.bodies.replace(**out)
    return bodies, sweep

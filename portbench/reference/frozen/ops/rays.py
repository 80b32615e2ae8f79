# Frozen copy of marl_hideandseek_torch/ops/rays.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""K1: the batched raycast, over packed or world-major state.

``raycast_batch_packed`` (packed) and ``raycast_batch`` (world-major)
launch the CUDA kernel ``csrc/raycast.cu`` for CUDA tensors and run the
plain PyTorch version (``env/rays.py::raycast_world``) for CPU tensors.
Replaces ``marl_hideandseek_tpu/ops/pallas_rays.py::raycast_batch_packed``
and ``raycast_batch``.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.config import EnvConfig
from portbench.reference.frozen.env import rays as plain_rays
from portbench.reference.frozen.ops.build import CudaKernel
from portbench.reference.frozen.ops.common import INT, PTR, check, stream_ptr
from portbench.reference.frozen.types import EnvState, body_slot_ranges

RAYCAST = CudaKernel("raycast", "mhs_raycast", [PTR] * 16 + [INT] * 7 + [PTR])


def _wm(x: torch.Tensor) -> torch.Tensor:
    """Packed leaf -> world axis first (a view)."""
    return torch.movedim(x, -1, 0)


def raycast_packed_plain(cfg: EnvConfig, ps: EnvState, origins, dirs,
                         max_t, exclude):
    """Plain PyTorch version: origins/dirs ``[R, 3, W]``, max_t/exclude
    ``[R, W]`` -> (t ``[R, W]``, hit_id ``[R, W]``)."""
    b, s = ps.bodies, ps.statics
    t, hit = plain_rays.raycast_world(
        cfg, _wm(b.pos), _wm(b.quat), _wm(b.half_ext), _wm(b.active),
        _wm(s.wall_pos), _wm(s.wall_half_ext), _wm(s.wall_active),
        _wm(s.plane_point), _wm(s.plane_normal), _wm(s.plane_active),
        _wm(origins), _wm(dirs), _wm(max_t), _wm(exclude))
    return t.T.contiguous(), hit.T.contiguous()


def raycast_batch_packed(cfg: EnvConfig, ps: EnvState, origins, dirs,
                         max_t, exclude):
    """Nearest-hit raycast of ``R`` rays in each of ``W`` packed worlds.

    ``origins, dirs [R, 3, W]`` f32; ``max_t [R, W]`` f32; ``exclude
    [R, W]`` i32. Returns ``(t [R, W] f32, +inf on a miss; id [R, W] i32,
    -1 on a miss)``. CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    if True:  # frozen: always the plain version
        return raycast_packed_plain(cfg, ps, origins, dirs, max_t, exclude)
    b, s = ps.bodies, ps.statics
    return _raycast_cuda(cfg, (b.pos, b.quat, b.half_ext, b.active),
                         (s.wall_pos, s.wall_half_ext, s.wall_active,
                          s.plane_point, s.plane_normal, s.plane_active),
                         origins, dirs, max_t, exclude)


def raycast_batch(cfg: EnvConfig, state: EnvState, origins, dirs, max_t,
                  exclude):
    """World-major twin of ``raycast_batch_packed`` (pallas_rays.py:264):
    ``state`` with the world axis first, ``origins, dirs [W, R, 3]``,
    ``max_t, exclude [W, R]`` -> ``(t [W, R], id [W, R])``. On CUDA the
    geometry and the rays are transposed to the packed layout around the
    same kernel."""
    b, s = state.bodies, state.statics
    if True:  # frozen: always the plain version
        return plain_rays.raycast_world(
            cfg, b.pos, b.quat, b.half_ext, b.active, s.wall_pos,
            s.wall_half_ext, s.wall_active, s.plane_point, s.plane_normal,
            s.plane_active, origins, dirs, max_t, exclude)
    pk = lambda x: torch.movedim(x, 0, -1).contiguous()
    t, hit = _raycast_cuda(
        cfg, [pk(x) for x in (b.pos, b.quat, b.half_ext, b.active)],
        [pk(x) for x in (s.wall_pos, s.wall_half_ext, s.wall_active,
                         s.plane_point, s.plane_normal, s.plane_active)],
        pk(origins), pk(dirs), pk(max_t), pk(exclude))
    return t.T.contiguous(), hit.T.contiguous()


def _raycast_cuda(cfg: EnvConfig, bodies, statics, origins, dirs, max_t,
                  exclude):
    """One K1 launch on packed tensors: bodies (pos, quat, half_ext,
    active), statics (wall pos, half, active, plane point, normal,
    active)."""
    dev = origins.device
    r, w = max_t.shape
    n_body = cfg.num_dyn_bodies
    _, (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)
    pos, quat, half, active = bodies
    wpos, whalf, wact, ppt, pnrm, pact = statics
    n_wall = wact.shape[0]
    n_plane = pact.shape[0]
    f32, u8, i32 = torch.float32, torch.uint8, torch.int32
    t_out = torch.empty((r, w), dtype=f32, device=dev)
    id_out = torch.empty((r, w), dtype=i32, device=dev)
    ptrs = [
        check(pos, "pos", (n_body, 3, w), f32, dev),
        check(quat, "quat", (n_body, 4, w), f32, dev),
        check(half, "half_ext", (n_body, 3, w), f32, dev),
        check(active.view(u8), "active", (n_body, w), u8, dev),
        check(wpos, "wall_pos", (n_wall, 3, w), f32, dev),
        check(whalf, "wall_half_ext", (n_wall, 3, w), f32, dev),
        check(wact.view(u8), "wall_active", (n_wall, w), u8, dev),
        check(ppt, "plane_point", (n_plane, 3, w), f32, dev),
        check(pnrm, "plane_normal", (n_plane, 3, w), f32, dev),
        check(pact.view(u8), "plane_active", (n_plane, w), u8, dev),
        check(origins, "origins", (r, 3, w), f32, dev),
        check(dirs, "dirs", (r, 3, w), f32, dev),
        check(max_t, "max_t", (r, w), f32, dev),
        check(exclude, "exclude", (r, w), i32, dev),
        t_out.data_ptr(), id_out.data_ptr(),
    ]
    RAYCAST(*ptrs, w, r, n_body, ramp_lo, ramp_hi, n_wall, n_plane,
            stream_ptr(dev))
    return t_out, id_out

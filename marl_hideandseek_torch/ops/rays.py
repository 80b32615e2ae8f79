"""K1: the batched raycast over packed state.

``raycast_batch_packed`` launches the CUDA kernel ``csrc/raycast.cu`` for
CUDA tensors and runs the plain PyTorch version
(``env/rays.py::raycast_world``) for CPU tensors. Replaces
``marl_hideandseek_tpu/ops/pallas_rays.py::raycast_batch_packed``.
"""

from __future__ import annotations

import torch

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.env import rays as plain_rays
from marl_hideandseek_torch.ops.build import CudaKernel
from marl_hideandseek_torch.ops.common import INT, PTR, check, stream_ptr
from marl_hideandseek_torch.types import EnvState, body_slot_ranges

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
    if origins.device.type == "cpu":
        return raycast_packed_plain(cfg, ps, origins, dirs, max_t, exclude)
    dev = origins.device
    r, w = max_t.shape
    n_body = cfg.num_dyn_bodies
    _, (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)
    b, s = ps.bodies, ps.statics
    n_wall = s.wall_active.shape[0]
    n_plane = s.plane_active.shape[0]
    f32, u8, i32 = torch.float32, torch.uint8, torch.int32
    t_out = torch.empty((r, w), dtype=f32, device=dev)
    id_out = torch.empty((r, w), dtype=i32, device=dev)
    ptrs = [
        check(b.pos, "pos", (n_body, 3, w), f32, dev),
        check(b.quat, "quat", (n_body, 4, w), f32, dev),
        check(b.half_ext, "half_ext", (n_body, 3, w), f32, dev),
        check(b.active.view(u8), "active", (n_body, w), u8, dev),
        check(s.wall_pos, "wall_pos", (n_wall, 3, w), f32, dev),
        check(s.wall_half_ext, "wall_half_ext", (n_wall, 3, w), f32, dev),
        check(s.wall_active.view(u8), "wall_active", (n_wall, w), u8, dev),
        check(s.plane_point, "plane_point", (n_plane, 3, w), f32, dev),
        check(s.plane_normal, "plane_normal", (n_plane, 3, w), f32, dev),
        check(s.plane_active.view(u8), "plane_active", (n_plane, w), u8,
              dev),
        check(origins, "origins", (r, 3, w), f32, dev),
        check(dirs, "dirs", (r, 3, w), f32, dev),
        check(max_t, "max_t", (r, w), f32, dev),
        check(exclude, "exclude", (r, w), i32, dev),
        t_out.data_ptr(), id_out.data_ptr(),
    ]
    RAYCAST(*ptrs, w, r, n_body, ramp_lo, ramp_hi, n_wall, n_plane,
            stream_ptr(dev))
    return t_out, id_out

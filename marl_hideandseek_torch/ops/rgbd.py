"""K5: per-agent RGBD rendering over packed state.

``render_rgbd_packed_fast`` launches ``csrc/rgbd.cu`` for CUDA tensors:
one warp per (world, agent) over the world's primitives staged in shared
memory, writing one packed RGBA u32 and one f32 depth per pixel in the
``[A, H*W, W]`` layout. For CPU tensors it runs the plain renderer
(``viz/rgbd.py``) and packs its output the same way. ``unpack_rgba`` and ``to_reference_layout`` turn the packed
outputs into the reference's ``[W, A, H, W, 4]`` u8 / ``[W, A, H, W, 1]``
f32 tensors. Replaces ``marl_hideandseek_tpu/ops/pallas_rgbd.py::
render_rgbd_packed_fast`` (``_rgbd_pallas``), ``unpack_rgba`` and
``to_reference_layout``.

``render_rgbd_frames`` is K5's frames mode (``rgbd_frames_kernel``): the
same pixels stored as the policy reads them, ``[W, A, 4, H, W]`` float32
(RGB / 255, depth / max_depth), in one launch; on the CPU, the plain
renderer's output through ``to_frames``, which defines the values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.ops.build import CudaKernel
from marl_hideandseek_torch.ops.common import (
    ARRAY_ENTRY,
    as_f32,
    check,
    launch_arrays,
    wall_bound,
)
from marl_hideandseek_torch.types import EnvState, body_slot_ranges
from marl_hideandseek_torch.utils import tracing
from marl_hideandseek_torch.viz import rgbd as plain_rgbd

RGBD = CudaKernel("rgbd", "mhs_rgbd", ARRAY_ENTRY)
RGBD_FRAMES = CudaKernel("rgbd", "mhs_rgbd_frames", ARRAY_ENTRY)


def pack_rgba(rgba: torch.Tensor) -> torch.Tensor:
    """[..., 4] u8 -> [...] u32, R | G << 8 | B << 16 | A << 24."""
    c = rgba.to(torch.int32)
    packed = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | (c[..., 3] << 24)
    return packed.view(torch.uint32)


def unpack_rgba(packed: torch.Tensor) -> torch.Tensor:
    """[A, P, W] u32 -> [A, P, W, 4] u8 (R, G, B, A)."""
    x = packed.view(torch.int32)
    return torch.stack([((x >> s) & 0xFF).to(torch.uint8)
                        for s in (0, 8, 16, 24)], dim=-1)


def to_reference_layout(cfg: EnvConfig, packed: torch.Tensor,
                        depth: torch.Tensor, img_h: int = 64,
                        img_w: int = 64):
    """Packed outputs -> (rgb ``[W, A, H, W, 4]`` u8, depth ``[W, A, H,
    W, 1]`` f32)."""
    n_a = cfg.max_agents
    rgb = torch.movedim(unpack_rgba(packed), 2, 0).reshape(
        -1, n_a, img_h, img_w, 4)
    d = torch.movedim(depth, 2, 0).reshape(-1, n_a, img_h, img_w, 1)
    return rgb, d


def to_frames(rgb: torch.Tensor, depth: torch.Tensor,
              max_depth: float = 200.0) -> torch.Tensor:
    """Reference-layout images (rgb ``[W, A, H, W, 4]`` u8, depth ``[W,
    A, H, W, 1]`` f32) -> frames ``[W, A, 4, H, W]`` f32: R, G, B over 255
    and depth over ``max_depth``, each the float32 quotient correctly
    rounded (taken in float64, which rounds it exactly once more), as the
    frames mode divides."""
    chans = torch.cat([rgb[..., :3].to(torch.float64) / 255.0,
                       depth.to(torch.float64) / as_f32(max_depth)], -1)
    return chans.to(torch.float32).permute(0, 1, 4, 2, 3).contiguous()


def frames_buffer(cfg: EnvConfig, w: int, img_h: int = 64, img_w: int = 64,
                  device="cuda") -> torch.Tensor:
    """The output of one frames-mode render, ``[W, A, 4, H, W]`` f32."""
    return torch.empty((w, cfg.max_agents, 4, img_h, img_w),
                       dtype=torch.float32, device=device)


def render_rgbd_frames(cfg: EnvConfig, ps: EnvState, img_h: int = 64,
                       img_w: int = 64, fov_deg: float = 90.0,
                       max_depth: float = 200.0,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every agent's RGBD view of packed ``ps`` as policy frames ``[W, A,
    4, H, W]`` f32 (``to_frames``'s values), written into ``out`` (from
    ``frames_buffer``) if given. CUDA tensors take K5's frames mode, one
    launch; CPU tensors the plain renderer."""
    with tracing.span("rgbd.render"):
        w = ps.step.shape[-1]
        if ps.step.device.type == "cpu":
            rgb, depth = plain_rgbd.render_rgbd_packed(cfg, ps, img_h, img_w,
                                                       fov_deg, max_depth)
            frames = to_frames(rgb, depth, max_depth)
            if out is None:
                return frames
            return out.copy_(frames)
        out = out if out is not None else frames_buffer(
            cfg, w, img_h, img_w, ps.step.device)
        ptrs, iparams, fparams, _, _keep = rgbd_args(
            cfg, ps, img_h, img_w, fov_deg, max_depth, frames=out)
        launch_arrays(RGBD_FRAMES, ptrs, iparams, fparams, ps.step.device)
        return out


def rgbd_buffers(cfg: EnvConfig, w: int, img_h: int = 64, img_w: int = 64,
                 device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Output buffers of one render (rgba u32, depth f32, ``[A, H*W,
    W]``), for callers that render every step into the same memory."""
    shape = (cfg.max_agents, img_h * img_w, w)
    return (torch.empty(shape, dtype=torch.int32,
                        device=device).view(torch.uint32),
            torch.empty(shape, dtype=torch.float32, device=device))


def render_rgbd_packed_fast(cfg: EnvConfig, ps: EnvState, img_h: int = 64,
                            img_w: int = 64, fov_deg: float = 90.0,
                            max_depth: float = 200.0,
                            out: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None):
    """Every agent's RGBD view of packed ``ps``: (rgba ``[A, H*W, W]``
    u32, depth ``[A, H*W, W]`` f32). ``out``, from ``rgbd_buffers``, is
    written in place and returned. CPU tensors take the plain renderer,
    CUDA tensors the kernel."""
    with tracing.span("rgbd.render"):
        return _render(cfg, ps, img_h, img_w, fov_deg, max_depth, out)


def _render(cfg, ps, img_h, img_w, fov_deg, max_depth, out):
    w = ps.step.shape[-1]
    dev = ps.step.device
    if dev.type == "cpu":
        rgb, depth = plain_rgbd.render_rgbd_packed(cfg, ps, img_h, img_w,
                                                   fov_deg, max_depth)
        n_a = cfg.max_agents
        packed = torch.movedim(pack_rgba(rgb).view(torch.int32).reshape(
            w, n_a, -1), 0, -1)
        depth = torch.movedim(depth.reshape(w, n_a, -1), 0, -1)
        if out is None:
            return packed.contiguous().view(torch.uint32), depth.contiguous()
        out[0].view(torch.int32).copy_(packed)
        out[1].copy_(depth)
        return out

    # `_keep` holds the wall bound made here until the launch is queued.
    ptrs, iparams, fparams, (rgba, depth), _keep = rgbd_args(
        cfg, ps, img_h, img_w, fov_deg, max_depth, out)
    launch_arrays(RGBD, ptrs, iparams, fparams, dev)
    return rgba, depth


def rgbd_args(cfg: EnvConfig, ps: EnvState, img_h: int, img_w: int,
              fov_deg: float, max_depth: float, out=None, frames=None):
    """Checked pointers, outputs and scalar parameters of one K5 launch:
    (ptrs, iparams, fparams, outputs, keepalive). The pointer order is
    RgbdArgs' in csrc/rgbd.cu. The packed mode's outputs are (rgba,
    depth); with ``frames`` (``frames_buffer``'s layout) the frames
    mode's, ``(frames,)``, and the packed outputs' pointers are null."""
    w = ps.step.shape[-1]
    dev = ps.step.device
    n_body, n_a = cfg.num_dyn_bodies, cfg.max_agents
    _, (ramp_lo, ramp_hi), (agent_lo, _) = body_slot_ranges(cfg)
    b, s = ps.bodies, ps.statics
    n_wall = s.wall_active.shape[0]
    n_plane = s.plane_active.shape[0]
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    if frames is None:
        rgba, depth = out if out is not None else rgbd_buffers(
            cfg, w, img_h, img_w, dev)
        outs = [check(rgba.view(i32), "rgba", (n_a, img_h * img_w, w), i32,
                      dev),
                check(depth, "depth", (n_a, img_h * img_w, w), f32, dev), 0]
        outputs = (rgba, depth)
    else:
        outs = [0, 0, check(frames, "frames", (w, n_a, 4, img_h, img_w), f32,
                            dev)]
        outputs = (frames,)
    bound = wall_bound(s.wall_active)
    ptrs = [
        check(b.pos, "pos", (n_body, 3, w), f32, dev),
        check(b.quat, "quat", (n_body, 4, w), f32, dev),
        check(b.half_ext, "half_ext", (n_body, 3, w), f32, dev),
        check(b.active.view(u8), "active", (n_body, w), u8, dev),
        check(b.locked.view(u8), "locked", (n_body, w), u8, dev),
        check(ps.agent_type, "agent_type", (n_a, w), i32, dev),
        check(s.wall_pos, "wall_pos", (n_wall, 3, w), f32, dev),
        check(s.wall_half_ext, "wall_half_ext", (n_wall, 3, w), f32, dev),
        check(s.wall_active.view(u8), "wall_active", (n_wall, w), u8, dev),
        check(s.plane_point, "plane_point", (n_plane, 3, w), f32, dev),
        check(s.plane_normal, "plane_normal", (n_plane, 3, w), f32, dev),
        check(s.plane_active.view(u8), "plane_active", (n_plane, w), u8,
              dev),
        bound.data_ptr(),
        *outs,
    ]
    ha, half = plain_rgbd.camera_params(img_h, img_w, fov_deg)
    iparams = [w, img_h, img_w, n_body, ramp_lo, ramp_hi, agent_lo, n_a,
               n_wall, n_plane]
    fparams = [ha, half, as_f32(max_depth)]
    return ptrs, iparams, fparams, outputs, bound

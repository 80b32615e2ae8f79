# Frozen copy of marl_hideandseek_torch/viz/rgbd.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Batched per-agent RGBD rendering, plain PyTorch.

Port of ``marl_hideandseek_tpu/viz/rgbd.py`` (the reference's batch
renderer tensors, src/mgr.cpp:873-903: rgb ``[W, A, H, W, 4]`` u8, depth
``[W, A, H, W, 1]`` f32): a ray caster over the simulation's primitives
(OBB boxes and agents, wedge ramps, axis-aligned walls, one-sided planes;
``env/rays.py``), flat Lambert shading under one directional light, the
team / lock palette, sky and depth 0 on a miss.

It is the plain version of the RGBD kernel (``ops/rgbd.py``,
``csrc/rgbd.cu``), whose source copies this file's op order: every dot
product and norm is written out component by component, and normals come
from the hit point's dominant ratio to the primitive's half extents, as in
the JAX renderer.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.frozen import math3d
from portbench.reference.frozen.config import EnvConfig
from portbench.reference.frozen.env import rays
from portbench.reference.frozen.env.observations import world_first
from portbench.reference.frozen.ops.common import as_f32
from portbench.reference.frozen.types import AGENT_HIDER, EnvState, body_slot_ranges

# Palette (viz/rgbd.py of the JAX package), RGB.
SKY = (135.0, 206.0, 235.0)
FLOOR = (200.0, 200.0, 200.0)
WALL = (120.0, 120.0, 120.0)
BOX = (230.0, 126.0, 34.0)
BOX_LOCKED = (192.0, 57.0, 43.0)
RAMP = (155.0, 89.0, 182.0)
RAMP_LOCKED = (108.0, 52.0, 131.0)
HIDER = (39.0, 174.0, 96.0)
SEEKER = (41.0, 128.0, 185.0)
LIGHT = (0.408, 0.408, 0.816)          # world light direction


def camera_params(img_h: int, img_w: int, fov_deg: float):
    """(tan(fov / 2) * aspect, tan(fov / 2)) as float32 values."""
    half = math.tan(math.radians(fov_deg) * 0.5)
    return as_f32(half * (img_w / img_h)), as_f32(half)


def camera_rays(quat: torch.Tensor, img_h: int, img_w: int,
                fov_deg: float) -> torch.Tensor:
    """Per-pixel unit ray directions ``[..., H*W, 3]`` of a camera that
    looks along the body's +y with world +z up (agents only yaw); rows
    top to bottom, columns left to right."""
    dev = quat.device
    fwd = math3d.quat_rotate(quat, math3d.vec(math3d.FWD, quat[..., :3]))
    right = math3d.quat_rotate(quat, math3d.vec(math3d.RIGHT, quat[..., :3]))
    ha, half = camera_params(img_h, img_w, fov_deg)
    u = (torch.arange(img_w, device=dev) + 0.5) / img_w * 2.0 - 1.0
    v = 1.0 - (torch.arange(img_h, device=dev) + 0.5) / img_h * 2.0
    uh = (u * ha)[None, :].expand(img_h, img_w).reshape(-1)     # [P]
    vh = (v * half)[:, None].expand(img_h, img_w).reshape(-1)
    up = (0.0, 0.0, 1.0)
    d = [(fwd[..., None, k] + uh * right[..., None, k]) + vh * up[k]
         for k in range(3)]
    n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return torch.stack([c / n for c in d], dim=-1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [c, N, k] at idx [c, R] -> [c, R, k]."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _dominant_normal(r: torch.Tensor) -> torch.Tensor:
    """sign(r) on the first axis of largest |r|, zero elsewhere."""
    ax = torch.argmax(torch.abs(r), dim=-1)
    return torch.sign(r) * (torch.arange(3, device=r.device) == ax[..., None])


def hit_normals(cfg: EnvConfig, b, s, o, d, t, hit_id) -> torch.Tensor:
    """Unit flat-shading normals ``[c, R, 3]`` from the hit primitive: a
    box face by the hit point's dominant ratio to the half extents, the
    wedge face whose halfspace value is largest, a wall face by the
    dominant ratio, a plane's normal."""
    n_body = cfg.num_dyn_bodies
    n_wall = s.wall_pos.shape[1]
    _, (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)
    p = o + d * torch.where(torch.isfinite(t), t, 0.0)[..., None]

    bi = torch.clamp(hit_id, 0, n_body - 1).long()
    c_b, q_b, h_b = (_gather(x, bi) for x in (b.pos, b.quat, b.half_ext))
    p_l = math3d.quat_rotate_inv(q_b, p - c_b)
    n_box = _dominant_normal(p_l / torch.clamp(h_b, min=1e-6))
    d_f = torch.stack([
        p_l[..., 0] * wn[0] + p_l[..., 1] * wn[1] + p_l[..., 2] * wn[2] - off
        for wn, off in zip(rays.WEDGE_NORMALS, rays.WEDGE_OFFSETS)], dim=-1)
    wedge_n = torch.tensor(rays.WEDGE_NORMALS, device=p.device)
    n_wedge = wedge_n[torch.argmax(d_f, dim=-1)]
    is_ramp = (hit_id >= ramp_lo) & (hit_id < ramp_hi)
    n_dyn = math3d.quat_rotate(
        q_b, torch.where(is_ramp[..., None], n_wedge, n_box))

    wi = torch.clamp(hit_id - n_body, 0, n_wall - 1).long()
    c_w, h_w = _gather(s.wall_pos, wi), _gather(s.wall_half_ext, wi)
    n_wallv = _dominant_normal((p - c_w) / torch.clamp(h_w, min=1e-6))

    pi = torch.clamp(hit_id - n_body - n_wall, 0,
                     s.plane_normal.shape[1] - 1).long()
    n_plane = _gather(s.plane_normal, pi)

    is_b = (hit_id >= 0) & (hit_id < n_body)
    is_w = (hit_id >= n_body) & (hit_id < n_body + n_wall)
    n = torch.where(is_b[..., None], n_dyn,
                    torch.where(is_w[..., None], n_wallv, n_plane))
    ln = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] +
                    n[..., 2] * n[..., 2])
    return n / torch.clamp(ln, min=1e-6)[..., None]


def base_colors(cfg: EnvConfig, b, agent_type, hit_id, n_wall) -> torch.Tensor:
    """Per-ray RGB ``[c, R, 3]`` of the hit primitive (sky on a miss)."""
    n_body = cfg.num_dyn_bodies
    (box_lo, box_hi), (ramp_lo, ramp_hi), (agent_lo, agent_hi) = \
        body_slot_ranges(cfg)
    dev = hit_id.device
    bi = torch.clamp(hit_id, 0, n_body - 1).long()
    locked = torch.gather(b.locked, 1, bi)
    ai = torch.clamp(hit_id - agent_lo, 0, agent_type.shape[1] - 1).long()
    hider = torch.gather(agent_type, 1, ai) == AGENT_HIDER
    col = lambda c: torch.tensor(c, device=dev)
    pick = lambda m, a, z: torch.where(m[..., None], a, z)
    c = col(SKY).expand(*hit_id.shape, 3)
    c = pick((hit_id >= box_lo) & (hit_id < box_hi),
             pick(locked, col(BOX_LOCKED), col(BOX)), c)
    c = pick((hit_id >= ramp_lo) & (hit_id < ramp_hi),
             pick(locked, col(RAMP_LOCKED), col(RAMP)), c)
    c = pick((hit_id >= agent_lo) & (hit_id < agent_hi),
             pick(hider, col(HIDER), col(SEEKER)), c)
    c = pick((hit_id >= n_body) & (hit_id < n_body + n_wall), col(WALL), c)
    return pick(hit_id >= n_body + n_wall, col(FLOOR), c)


def _render_chunk(cfg: EnvConfig, st: EnvState, img_h, img_w, fov_deg,
                  max_depth):
    """World-first state of c worlds -> (rgba [c, A, P, 4] u8, depth
    [c, A, P] f32)."""
    _, _, (agent_lo, agent_hi) = body_slot_ranges(cfg)
    b, s = st.bodies, st.statics
    c, n_a = b.pos.shape[0], cfg.max_agents
    n_pix = img_h * img_w
    a_pos = b.pos[:, agent_lo:agent_hi]
    eye = a_pos + math3d.vec((0.0, 0.0, 0.5), a_pos)
    d = camera_rays(b.quat[:, agent_lo:agent_hi], img_h, img_w, fov_deg)
    o = eye[:, :, None].expand(c, n_a, n_pix, 3)
    d = d.reshape(c, n_a * n_pix, 3)
    o = o.reshape(c, n_a * n_pix, 3)
    excl = (agent_lo + torch.arange(n_a, device=o.device, dtype=torch.int32)
            )[:, None].expand(n_a, n_pix).reshape(1, -1).expand(c, -1)
    t, hit_id = rays.raycast_world(
        cfg, b.pos, b.quat, b.half_ext, b.active, s.wall_pos,
        s.wall_half_ext, s.wall_active, s.plane_point, s.plane_normal,
        s.plane_active, o, d, max_depth, excl)

    n = hit_normals(cfg, b, s, o, d, t, hit_id)
    base = base_colors(cfg, b, st.agent_type, hit_id, s.wall_pos.shape[1])
    lam = torch.abs(n[..., 0] * LIGHT[0] + n[..., 1] * LIGHT[1] +
                    n[..., 2] * LIGHT[2])
    shade = 0.45 + 0.55 * lam
    miss = ~torch.isfinite(t)
    rgb = torch.where(miss[..., None], torch.tensor(SKY, device=o.device),
                      base * shade[..., None])
    rgb = torch.clamp(rgb, 0.0, 255.0).to(torch.uint8)
    rgba = torch.cat([rgb, torch.full_like(rgb[..., :1], 255)], dim=-1)
    depth = torch.where(miss, 0.0, t)
    return (rgba.reshape(c, n_a, n_pix, 4), depth.reshape(c, n_a, n_pix))


def render_rgbd(cfg: EnvConfig, state: EnvState, img_h: int = 64,
                img_w: int = 64, fov_deg: float = 90.0,
                max_depth: float = 200.0, world_chunk: int = 64):
    """Every agent's view of world-major ``state``: (rgb ``[W, A, H, W,
    4]`` u8, depth ``[W, A, H, W, 1]`` f32). Inactive agents render like
    active ones. Worlds go in chunks of ``world_chunk`` to bound the
    ``[chunk, A * H * W, primitives]`` intermediates."""
    n_w = state.step.shape[0]
    n_a = cfg.max_agents
    rgb, depth = [], []
    for lo in range(0, n_w, world_chunk):
        sub = state.map(lambda x: x[lo:lo + world_chunk])
        r, d = _render_chunk(cfg, sub, img_h, img_w, fov_deg, max_depth)
        rgb.append(r)
        depth.append(d)
    rgb = torch.cat(rgb).reshape(n_w, n_a, img_h, img_w, 4)
    depth = torch.cat(depth).reshape(n_w, n_a, img_h, img_w, 1)
    return rgb, depth


def render_rgbd_packed(cfg: EnvConfig, ps: EnvState, img_h: int = 64,
                       img_w: int = 64, fov_deg: float = 90.0,
                       max_depth: float = 200.0, world_chunk: int = 64):
    """``render_rgbd`` of packed state (world axis last), on views."""
    return render_rgbd(cfg, world_first(ps), img_h, img_w, fov_deg,
                       max_depth, world_chunk)

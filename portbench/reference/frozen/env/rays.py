# Frozen copy of marl_hideandseek_torch/env/rays.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Nearest-hit raycasting against a world's primitives (plain PyTorch).

Port of ``marl_hideandseek_tpu/env/rays.py`` with the world axis as a
leading batch dimension instead of ``vmap``. It is the plain version of
the raycast kernel (``ops/rays.py``), whose CUDA source copies this op
order.

Semantics: ``t`` is parametric along the (possibly unnormalized) ray
direction; a primitive whose interior contains the ray origin is skipped;
the nearest hit's entity id is returned, -1 on a miss. Id space per world:

  [0, B)            dynamic body slots (boxes, ramps, agents)
  [B, B+MW)         wall slots
  [B+MW, B+MW+P)    planes
"""

from __future__ import annotations

import math

import torch

from portbench.reference.frozen import math3d
from portbench.reference.frozen.config import EnvConfig
from portbench.reference.frozen.types import body_slot_ranges

EPS = 1e-7
INF = math.inf

# Wedge (ramp) halfspaces in the body frame: x in [-1, 1], profile
# triangle (y, z) = (1, 1), (1, -1), (-2, -1). Halfspace f: n_f . x <= d_f.
_S13 = math.sqrt(13.0)
WEDGE_NORMALS = (
    (1.0, 0.0, 0.0),
    (-1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0),
    (0.0, 0.0, -1.0),
    (0.0, -2.0 / _S13, 3.0 / _S13),
)
WEDGE_OFFSETS = (1.0, 1.0, 1.0, 1.0, 1.0 / _S13)


def _dot3(v: torch.Tensor, n) -> torch.Tensor:
    """v . n for a constant 3-vector n, summed in component order."""
    return v[..., 0] * n[0] + v[..., 1] * n[1] + v[..., 2] * n[2]


def ray_aabb(o, d, lo, hi):
    """Slab test; entry t, +inf on a miss or with the origin inside."""
    small = torch.abs(d) < EPS
    safe_d = torch.where(small, EPS, d)
    t1 = (lo - o) / safe_d
    t2 = (hi - o) / safe_d
    near = torch.minimum(t1, t2)
    far = torch.maximum(t1, t2)
    outside = small & ((o < lo) | (o > hi))
    near = torch.where(outside, INF, near)
    far = torch.where(outside, -INF, far)
    tmin = torch.amax(near, dim=-1)
    tmax = torch.amin(far, dim=-1)
    hit = (tmax >= tmin) & (tmin > EPS)
    return torch.where(hit, tmin, INF)


def ray_obb(o, d, center, quat, half_ext):
    o_l = math3d.quat_rotate_inv(quat, o - center)
    d_l = math3d.quat_rotate_inv(quat, d)
    return ray_aabb(o_l, d_l, -half_ext, half_ext)


def ray_convex(o_l, d_l):
    """Cyrus-Beck entry t against the wedge halfspaces, +inf on a miss."""
    t_in = None
    t_out = None
    miss = None
    for n, off in zip(WEDGE_NORMALS, WEDGE_OFFSETS):
        denom = _dot3(d_l, n)
        num = off - _dot3(o_l, n)
        small = torch.abs(denom) < EPS
        t = num / torch.where(small, EPS, denom)
        te = torch.where(small | (denom > 0), -INF, t)
        tx = torch.where(small | (denom < 0), INF, t)
        mp = small & (num < 0)
        t_in = te if t_in is None else torch.maximum(t_in, te)
        t_out = tx if t_out is None else torch.minimum(t_out, tx)
        miss = mp if miss is None else (miss | mp)
    hit = (t_out >= t_in) & (t_in > EPS) & ~miss
    return torch.where(hit, t_in, INF)


def ray_wedge(o, d, center, quat):
    o_l = math3d.quat_rotate_inv(quat, o - center)
    d_l = math3d.quat_rotate_inv(quat, d)
    return ray_convex(o_l, d_l)


def ray_plane(o, d, point, normal):
    """One-sided plane: hits only when approaching from the normal side."""
    denom = (d[..., 0] * normal[..., 0] + d[..., 1] * normal[..., 1] +
             d[..., 2] * normal[..., 2])
    pm = point - o
    num = (pm[..., 0] * normal[..., 0] + pm[..., 1] * normal[..., 1] +
           pm[..., 2] * normal[..., 2])
    t = num / torch.where(torch.abs(denom) < EPS, -EPS, denom)
    hit = (denom < -EPS) & (t > EPS)
    return torch.where(hit, t, INF)


def raycast_world(cfg: EnvConfig, bpos, bquat, bhalf, bactive,
                  wall_pos, wall_half, wall_active,
                  plane_point, plane_normal, plane_active,
                  origins, dirs, max_t, exclude=None):
    """Nearest-hit raycast, world axis leading.

    Bodies ``[W, B, 3|4]`` / ``[W, B]``, walls ``[W, MW, 3]`` / ``[W, MW]``,
    planes ``[W, P, 3]`` / ``[W, P]``; rays ``origins, dirs [W, R, 3]``,
    ``max_t [W, R]``, ``exclude [W, R]`` (entity id never hit).
    Returns ``(t [W, R] f32, +inf miss; hit_id [W, R] i32, -1 miss)``.
    """
    n_body = cfg.num_dyn_bodies
    _, (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)
    dev = origins.device

    o = origins[:, :, None, :]                       # [W, R, 1, 3]
    d = dirs[:, :, None, :]
    slot = torch.arange(n_body, device=dev)
    is_ramp = (slot >= ramp_lo) & (slot < ramp_hi)

    c = bpos[:, None]                                # [W, 1, B, 3]
    q = bquat[:, None]
    t_box = ray_obb(o, d, c, q, bhalf[:, None])      # [W, R, B]
    t_wedge = ray_wedge(o, d, c, q)
    t_dyn = torch.where(is_ramp, t_wedge, t_box)
    t_dyn = torch.where(bactive[:, None, :], t_dyn, INF)

    w_lo = wall_pos - wall_half
    w_hi = wall_pos + wall_half
    t_wall = ray_aabb(o, d, w_lo[:, None], w_hi[:, None])    # [W, R, MW]
    t_wall = torch.where(wall_active[:, None, :], t_wall, INF)

    t_plane = ray_plane(o, d, plane_point[:, None], plane_normal[:, None])
    t_plane = torch.where(plane_active[:, None, :], t_plane, INF)

    t_all = torch.cat([t_dyn, t_wall, t_plane], dim=-1)     # [W, R, N]
    max_t = torch.broadcast_to(torch.as_tensor(max_t, device=dev),
                               origins.shape[:2])
    t_all = torch.where(t_all <= max_t[..., None], t_all, INF)
    if exclude is not None:
        ids = torch.arange(t_all.shape[-1], device=dev)
        t_all = torch.where(ids == exclude[..., None], INF, t_all)

    t_hit, hit_prim = torch.min(t_all, dim=-1)
    hit_id = torch.where(torch.isfinite(t_hit), hit_prim, -1)
    return t_hit, hit_id.to(torch.int32)

# Frozen copy of marl_hideandseek_torch/env/physics.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""XPBD rigid-body physics step, plain PyTorch (world axis leading).

Port of ``marl_hideandseek_tpu/env/physics.py`` (lines 203-734): the
per-vertex persistent manifold built once per step at the predicted
pose, then ``num_physics_substeps`` substeps of integration, contact
refresh, Jacobi position solve with positional static friction, grab
joints, velocity reconstruction, and the velocity passes (dynamic
friction, restitution). The JAX version is single-world under ``vmap``;
here the world axis is an explicit leading batch dimension.

Approximations kept as the reference has them (STATUS.md, "Standing
limitations"): Coulomb-clamped positional static friction, applied to
the owning body only, measured against a stationary neighbour; the
restitution pass likewise owner-only.

This is the plain version of the physics inside the megastep kernel
(``ops/step.py``, ``csrc/megastep.cu``), which copies its op order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from portbench.reference.frozen import math3d
from portbench.reference.frozen.config import EnvConfig
from portbench.reference.frozen.env.rays import WEDGE_NORMALS, WEDGE_OFFSETS
from portbench.reference.frozen.types import body_slot_ranges

GRAVITY = (0.0, 0.0, -9.8)
CONTACT_MARGIN = 1.5
K_WALL = 3
K_PAIR = 3
WEDGE_RADIUS = 6.0 ** 0.5
WEDGE_VERTS = (
    (1.0, 1.0, 1.0),
    (1.0, 1.0, -1.0),
    (1.0, -2.0, -1.0),
    (-1.0, 1.0, 1.0),
    (-1.0, 1.0, -1.0),
    (-1.0, -2.0, -1.0),
    (1.0, -0.5, 0.0),
    (-1.0, -0.5, 0.0),
)
MU_S_BODY = 0.5
MU_S_STATIC = 2.0
VERT_INSET = 0.05
BOX_CORNER_SIGNS = tuple(
    (sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
    for sz in (-1.0, 1.0))

KIND_NONE = 0
KIND_PLANE = 1
KIND_WALL = 2
KIND_PAIR = 3


def _is_ramp(cfg: EnvConfig, device) -> torch.Tensor:
    _, (ramp_lo, ramp_hi), _ = body_slot_ranges(cfg)
    slot = torch.arange(cfg.num_dyn_bodies, device=device)
    return (slot >= ramp_lo) & (slot < ramp_hi)


def body_vertices_local(cfg: EnvConfig, half_ext: torch.Tensor):
    """[W, B, 3] half extents -> [W, B, 8, 3] local vertices."""
    signs = torch.tensor(BOX_CORNER_SIGNS, device=half_ext.device)
    wedge = torch.tensor(WEDGE_VERTS, device=half_ext.device)
    box = half_ext[..., None, :] * signs
    is_ramp = _is_ramp(cfg, half_ext.device)
    return torch.where(is_ramp[:, None, None], wedge, box)


def aabb_sdf_normal(rel: torch.Tensor, half_ext: torch.Tensor):
    """Box SDF and outward face normal; ``rel`` relative to the centre."""
    q = torch.abs(rel) - half_ext
    qx, qy, qz = q.unbind(-1)
    sdf = torch.maximum(torch.maximum(qx, qy), qz)
    is_x = (qx >= qy) & (qx >= qz)
    is_y = (~is_x) & (qy >= qz)
    is_z = ~(is_x | is_y)
    n = torch.stack([torch.sign(rel[..., 0]) * is_x,
                     torch.sign(rel[..., 1]) * is_y,
                     torch.sign(rel[..., 2]) * is_z], dim=-1)
    return sdf, n


def convex_sdf_local(p: torch.Tensor, half_ext: torch.Tensor,
                     is_ramp: torch.Tensor):
    """SDF and normal of a box (or wedge, where ``is_ramp``), local frame.
    Wedge ties blend the adjoining face normals (an edge normal)."""
    box_sdf, box_n = aabb_sdf_normal(p, half_ext)
    ds = [p[..., 0] * n[0] + p[..., 1] * n[1] + p[..., 2] * n[2] - off
          for n, off in zip(WEDGE_NORMALS, WEDGE_OFFSETS)]
    wedge_sdf = ds[0]
    for d in ds[1:]:
        wedge_sdf = torch.maximum(wedge_sdf, d)
    comps = []
    for k in range(3):
        acc = None
        for d, n in zip(ds, WEDGE_NORMALS):
            term = (d >= wedge_sdf).to(p.dtype) * n[k]
            acc = term if acc is None else acc + term
        comps.append(acc)
    wedge_n = torch.stack(comps, dim=-1)
    wedge_n = wedge_n / torch.clamp(math3d.norm(wedge_n, keepdim=True),
                                    min=1e-9)
    sdf = torch.where(is_ramp, wedge_sdf, box_sdf)
    normal = torch.where(is_ramp[..., None], wedge_n, box_n)
    return sdf, normal


def apply_inv_inertia(quat, inv_diag, u):
    """R diag(inv) R^T u."""
    u_b = math3d.quat_rotate_inv(quat, u)
    return math3d.quat_rotate(quat, inv_diag * u_b)


def apply_rot(quat, drot):
    """Small-angle update of quaternions by rotation vectors."""
    dq = 0.5 * torch.cat([torch.zeros_like(drot[..., :1]), drot], dim=-1)
    return math3d.quat_normalize(quat + math3d.quat_mul(dq, quat))


def _sum_c(x: torch.Tensor) -> torch.Tensor:
    """Sum over the contact axis (2) of ``[W, B, C, ...]`` in slot order."""
    acc = x[:, :, 0]
    for c in range(1, x.shape[2]):
        acc = acc + x[:, :, c]
    return acc


def _gather_b(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[w, idx[w, ...]] for per-body x [W, B(, k)], idx [W, ...] >= 0."""
    w = x.shape[0]
    flat = idx.reshape(w, -1)
    if x.dim() == 2:
        return torch.gather(x, 1, flat).reshape(idx.shape)
    k = x.shape[-1]
    g = torch.gather(x, 1, flat[..., None].expand(-1, -1, k))
    return g.reshape(idx.shape + (k,))


def _stable_smallest(lb: torch.Tensor, k: int):
    """k smallest along the last axis, ties to the lower index (the order
    of ``jax.lax.top_k`` on ``-lb``). Returns (values, indices)."""
    vals, idx = torch.sort(lb, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


class Manifold(NamedTuple):
    """Per-body persistent contacts, arrays [W, B, C, ...]."""

    kind: torch.Tensor       # i64 KIND_*
    v_local: torch.Tensor    # [.., 3] contact vertex, body frame
    flat_n: torch.Tensor     # [.., 3] plane normal (plane kind)
    flat_pt: torch.Tensor    # [.., 3] plane point / wall centre
    wall_half: torch.Tensor  # [.., 3]
    nb_idx: torch.Tensor     # i64 neighbour slot (pair kind), -1 else
    nb_half: torch.Tensor    # [.., 3]
    nb_is_ramp: torch.Tensor
    mu: torch.Tensor
    valid: torch.Tensor

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Per-body x [W, B(, k)] read at each contact's neighbour;
        zero where there is none (the JAX one-hot product)."""
        has = self.nb_idx >= 0
        g = _gather_b(x, torch.clamp(self.nb_idx, min=0))
        if g.dim() > has.dim():
            has = has[..., None]
        return torch.where(has, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))

    def scatter(self, vals: torch.Tensor) -> torch.Tensor:
        """Sum per-contact vals [W, B, C(, k)] into the neighbour body
        [W, B(, k)] (the JAX one-hot contraction)."""
        n_body = self.kind.shape[1]
        oh = (self.nb_idx[..., None] ==
              torch.arange(n_body, device=vals.device)).to(vals.dtype)
        if vals.dim() == 3:
            return torch.einsum("wbcj,wbc->wj", oh, vals)
        return torch.einsum("wbcj,wbcd->wjd", oh, vals)


def build_manifold(cfg: EnvConfig, b, s, pos_pred, quat_pred,
                   verts_local) -> Manifold:
    """Per-vertex nearest-surface narrowphase at the predicted pose."""
    n_body = cfg.num_dyn_bodies
    dev = pos_pred.device
    slot = torch.arange(n_body, device=dev)
    is_ramp = _is_ramp(cfg, dev)
    active = b.active
    mu_body = b.friction_mu
    k_pair = min(K_PAIR, n_body - 1)

    verts_w = pos_pred[:, :, None, :] + math3d.quat_rotate(
        quat_pred[:, :, None, :], verts_local)            # [W, B, 8, 3]
    verts_in = verts_local - VERT_INSET * torch.sign(verts_local)
    verts_w_in = pos_pred[:, :, None, :] + math3d.quat_rotate(
        quat_pred[:, :, None, :], verts_in)

    r_bound = torch.where(is_ramp, WEDGE_RADIUS, math3d.norm(b.half_ext))

    # Per-body candidate preselection by centre lower bounds.
    lb_w, _ = aabb_sdf_normal(pos_pred[:, :, None, :] - s.wall_pos[:, None],
                              s.wall_half_ext[:, None])   # [W, B, NW]
    lb_w = torch.where(s.wall_active[:, None, :], lb_w - r_bound[..., None],
                       1e9)
    lb_wk, wsel = _stable_smallest(lb_w, K_WALL)           # [W, B, K]
    wall_pos_k = _gather_b(s.wall_pos, wsel)               # [W, B, K, 3]
    wall_half_k = _gather_b(s.wall_half_ext, wsel)
    wall_ok_k = lb_wk < 1e8

    pair_ok = active[:, None, :] & (slot[:, None] != slot[None, :])
    lb_p = (math3d.norm(pos_pred[:, :, None] - pos_pred[:, None])
            - r_bound[:, :, None] - r_bound[:, None, :])
    lb_p = torch.where(pair_ok, lb_p, 1e9)
    lb_pk, psel = _stable_smallest(lb_p, k_pair)
    nb_pos_k = _gather_b(pos_pred, psel)
    nb_quat_k = _gather_b(quat_pred, psel)
    nb_half_k = _gather_b(b.half_ext, psel)
    nb_ramp_k = is_ramp[psel]
    nb_mu_k = _gather_b(mu_body, psel)
    pair_ok_k = lb_pk < 1e8

    # Plane candidates [W, B, 8, P].
    rel_p = verts_w[:, :, :, None, :] - s.plane_point[:, None, None]
    pn = s.plane_normal[:, None, None]
    sdf_pl = (rel_p[..., 0] * pn[..., 0] + rel_p[..., 1] * pn[..., 1] +
              rel_p[..., 2] * pn[..., 2])
    sdf_pl = torch.where(s.plane_active[:, None, None, :], sdf_pl, 1e9)

    # Wall candidates (inset samples) [W, B, 8, K].
    rel_w = verts_w_in[:, :, :, None, :] - wall_pos_k[:, :, None]
    sdf_wl, _ = aabb_sdf_normal(rel_w, wall_half_k[:, :, None])
    sdf_wl = torch.where(wall_ok_k[:, :, None, :], sdf_wl, 1e9)

    # Pair candidates (inset samples) [W, B, 8, K].
    rel_d = verts_w_in[:, :, :, None, :] - nb_pos_k[:, :, None]
    pl = math3d.quat_rotate_inv(nb_quat_k[:, :, None], rel_d)
    sdf_pr, _ = convex_sdf_local(
        pl, nb_half_k[:, :, None],
        nb_ramp_k[:, :, None].expand(pl.shape[:-1]))
    sdf_pr = torch.where(pair_ok_k[:, :, None, :], sdf_pr, 1e9)

    def pick(sdf, meta):
        """min over the candidate axis; meta [W, B(, P), T(, d)] read at
        the argmin (first on ties)."""
        best, am = torch.min(sdf, dim=-1)                  # [W, B, 8]
        out = []
        for m in meta:
            if m.dim() == 3:                               # [W, B, T]
                out.append(torch.gather(m, 2, am))
            else:                                          # [W, B, T, d]
                d = m.shape[-1]
                out.append(torch.gather(
                    m, 2, am[..., None].expand(-1, -1, -1, d)))
        return best, out

    n_worlds = s.plane_normal.shape[0]

    def tile(m):
        return m[:, None].expand(n_worlds, n_body, *m.shape[1:])

    s_pl, (pl_n, pl_pt) = pick(sdf_pl, (tile(s.plane_normal),
                                        tile(s.plane_point)))
    s_wl, (wl_pt, wl_half) = pick(sdf_wl, (wall_pos_k, wall_half_k))
    s_pr, (pr_idx, pr_ramp, pr_mu, pr_half) = pick(
        sdf_pr, (psel, nb_ramp_k, nb_mu_k, nb_half_k))

    # Plane beats wall beats pair on exact ties.
    best = torch.minimum(torch.minimum(s_pl, s_wl), s_pr)
    is_plane = s_pl <= best
    is_wall = (~is_plane) & (s_wl <= best)
    is_pair = ~(is_plane | is_wall)
    valid = (best < CONTACT_MARGIN) & active[:, :, None]
    kind = torch.where(valid, torch.where(
        is_plane, KIND_PLANE, torch.where(is_wall, KIND_WALL, KIND_PAIR)),
        KIND_NONE)

    mu_static = torch.clamp(mu_body, min=2.0)[:, :, None]
    mu = torch.where(is_pair, torch.maximum(mu_body[:, :, None], pr_mu),
                     mu_static)
    return Manifold(
        kind=kind,
        v_local=verts_local,
        flat_n=pl_n,
        flat_pt=torch.where(is_wall[..., None], wl_pt, pl_pt),
        wall_half=torch.clamp(wl_half, min=1e-3),
        nb_idx=torch.where(is_pair & valid, pr_idx, -1),
        nb_half=torch.clamp(pr_half, min=1e-3),
        nb_is_ramp=pr_ramp,
        mu=mu,
        valid=valid,
    )


def _inset(v_local):
    return v_local - VERT_INSET * torch.sign(v_local)


def refresh_contacts(man: Manifold, pos, quat):
    """World contact point, depth and normal of each manifold slot at the
    current pose: plane slots at the exact vertex, wall/pair slots at the
    inset sample."""
    q3 = quat[:, :, None, :]
    p_ex = pos[:, :, None, :] + math3d.quat_rotate(q3, man.v_local)
    p_in = pos[:, :, None, :] + math3d.quat_rotate(q3, _inset(man.v_local))

    is_pair = man.kind == KIND_PAIR
    nb_pos = man.gather(pos)
    nb_quat_raw = man.gather(quat)
    ident = math3d.vec((1.0, 0.0, 0.0, 0.0), quat)
    nb_quat = torch.where(is_pair[..., None], nb_quat_raw, ident)
    nb_pos = torch.where(is_pair[..., None], nb_pos, 1e6)

    dp = p_ex - man.flat_pt
    d_plane = (dp[..., 0] * man.flat_n[..., 0] +
               dp[..., 1] * man.flat_n[..., 1] +
               dp[..., 2] * man.flat_n[..., 2])
    sdf_w, n_w = aabb_sdf_normal(p_in - man.flat_pt, man.wall_half)
    p_l = math3d.quat_rotate_inv(nb_quat, p_in - nb_pos)
    sdf_p, n_l = convex_sdf_local(p_l, man.nb_half, man.nb_is_ramp)
    n_p = math3d.quat_rotate(nb_quat, n_l)

    is_plane = man.kind == KIND_PLANE
    is_wall = man.kind == KIND_WALL
    depth = torch.where(is_plane, -d_plane,
                        torch.where(is_wall, -sdf_w, -sdf_p))
    n = torch.where(is_plane[..., None], man.flat_n,
                    torch.where(is_wall[..., None], n_w, n_p))
    p = torch.where(is_plane[..., None], p_ex, p_in)
    mask = man.valid & (man.kind > 0) & (depth > 0.0)
    return p, n, depth, mask, nb_pos, nb_quat


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def contact_solve(man: Manifold, pos, quat, w_lin, inv_I, p, n, depth, mask,
                  nb_pos, nb_quat, pos_prev, quat_prev):
    """Jacobi position pass over the manifold: normal corrections plus
    XPBD positional static friction (Coulomb-clamped, owner-only)."""
    is_pair = man.kind == KIND_PAIR
    nb_w = man.gather(w_lin) * is_pair
    nb_ii = man.gather(inv_I) * is_pair[..., None]

    r_a = p - pos[:, :, None, :]
    r_b = p - nb_pos
    q_a = quat[:, :, None, :]
    ii_a = inv_I[:, :, None, :]

    rxn_a = math3d.cross(r_a, n)
    rxn_b = math3d.cross(r_b, n)
    w_ang_a = _dot(rxn_a, apply_inv_inertia(q_a, ii_a, rxn_a))
    w_ang_b = _dot(rxn_b, apply_inv_inertia(nb_quat, nb_ii, rxn_b))
    w_sum = w_lin[:, :, None] + w_ang_a + nb_w + w_ang_b

    lam = torch.where(mask & (w_sum > 1e-9),
                      depth / torch.clamp(w_sum, min=1e-9), 0.0)
    imp = lam[..., None] * n

    # Positional static friction against a stationary neighbour.
    is_plane_k = (man.kind == KIND_PLANE)[..., None]
    v_eval = torch.where(is_plane_k, man.v_local, _inset(man.v_local))
    p_prev_a = pos_prev[:, :, None, :] + math3d.quat_rotate(
        quat_prev[:, :, None, :], v_eval)
    dp = p - p_prev_a
    dpt = dp - _dot(dp, n)[..., None] * n
    dpt_len = math3d.norm(dpt)
    t_dir = dpt / torch.clamp(dpt_len, min=1e-9)[..., None]
    rxt_a = math3d.cross(r_a, t_dir)
    w_t = (w_lin[:, :, None] + nb_w +
           _dot(rxt_a, apply_inv_inertia(q_a, ii_a, rxt_a)))
    lam_t = dpt_len / torch.clamp(w_t, min=1e-9)
    mu_s = torch.where(is_pair, MU_S_BODY, MU_S_STATIC)
    static_ok = mask & (lam > 0.0) & (w_t > 1e-9)
    lam_tc = torch.minimum(lam_t, mu_s * lam)
    imp_t = -torch.where(static_ok, lam_tc, 0.0)[..., None] * t_dir

    dpos_a = _sum_c(imp) * w_lin[:, :, None]
    drot_a = _sum_c(apply_inv_inertia(q_a, ii_a, math3d.cross(r_a, imp)))
    imp_b = -imp * nb_w[..., None]
    ang_b = apply_inv_inertia(nb_quat, nb_ii, math3d.cross(r_b, -imp))
    dpos = dpos_a + man.scatter(imp_b)
    drot = drot_a + man.scatter(ang_b)

    dpos_t = _sum_c(imp_t) * w_lin[:, :, None]
    drot_t = _sum_c(apply_inv_inertia(q_a, ii_a, math3d.cross(r_a, imp_t)))

    m_f = mask.to(pos.dtype)
    cnt = _sum_c(m_f) + man.scatter(m_f)
    return dpos, drot, cnt, lam, dpos_t, drot_t, w_sum


def contact_friction(man: Manifold, pos, quat, vel, omega, w_lin, inv_I,
                     p, n, mask, nb_pos, nb_quat, lam, h):
    """XPBD velocity-pass dynamic friction."""
    is_pair = man.kind == KIND_PAIR
    nb_w = man.gather(w_lin) * is_pair
    nb_ii = man.gather(inv_I) * is_pair[..., None]
    nb_vel = man.gather(vel)
    nb_om = man.gather(omega)

    r_a = p - pos[:, :, None, :]
    r_b = p - nb_pos
    v_a = vel[:, :, None, :] + math3d.cross(
        omega[:, :, None, :].expand_as(r_a), r_a)
    v_b = nb_vel + math3d.cross(nb_om, r_b)
    v_rel = v_a - v_b
    v_n = _dot(v_rel, n)[..., None] * n
    v_t = v_rel - v_n
    v_t_len = math3d.norm(v_t)
    t_dir = v_t / torch.clamp(v_t_len, min=1e-9)[..., None]

    q_a = quat[:, :, None, :]
    ii_a = inv_I[:, :, None, :]
    rxt_a = math3d.cross(r_a, t_dir)
    rxt_b = math3d.cross(r_b, t_dir)
    w_sum = (w_lin[:, :, None] + nb_w +
             _dot(rxt_a, apply_inv_inertia(q_a, ii_a, rxt_a)) +
             _dot(rxt_b, apply_inv_inertia(nb_quat, nb_ii, rxt_b)))
    w_sum = torch.clamp(w_sum, min=1e-9)

    active = mask & (lam > 0.0)
    j = torch.minimum(v_t_len / w_sum, man.mu * lam / h)
    j = torch.where(active, j, 0.0)
    imp = -j[..., None] * t_dir

    dvel_a = _sum_c(imp) * w_lin[:, :, None]
    dom_a = _sum_c(apply_inv_inertia(q_a, ii_a, math3d.cross(r_a, imp)))
    imp_b = -imp * nb_w[..., None]
    ang_b = apply_inv_inertia(nb_quat, nb_ii, math3d.cross(r_b, -imp))
    dvel = dvel_a + man.scatter(imp_b)
    dom = dom_a + man.scatter(ang_b)

    a_f = active.to(pos.dtype)
    cnt = _sum_c(a_f) + man.scatter(a_f)
    return dvel, dom, cnt


def contact_normal_vel(man: Manifold, pos, vel, omega, p, n, nb_pos):
    """Relative normal velocity at each contact point."""
    is_pair = (man.kind == KIND_PAIR)[..., None]
    nb_vel = man.gather(vel) * is_pair
    nb_om = man.gather(omega) * is_pair
    r_a = p - pos[:, :, None, :]
    r_b = p - nb_pos
    v_a = vel[:, :, None, :] + math3d.cross(
        omega[:, :, None, :].expand_as(r_a), r_a)
    v_b = nb_vel + math3d.cross(nb_om, r_b)
    return _dot(v_a - v_b, n)


def contact_restitution(man: Manifold, pos, quat, vel, omega, w_lin, inv_I,
                        p, n, mask, nb_pos, lam, w_n, vn_pre, e, h):
    """Drive the post-solve normal velocity to -e * vn_pre for contacts
    that came in faster than 2 g h (owner-only, reusing w_n)."""
    vn_now = contact_normal_vel(man, pos, vel, omega, p, n, nb_pos)
    r_a = p - pos[:, :, None, :]
    q_a = quat[:, :, None, :]
    ii_a = inv_I[:, :, None, :]
    thresh = 2.0 * 9.8 * h
    need = mask & (lam > 0.0) & (vn_pre < -thresh) & (w_n > 1e-9)
    j = torch.where(need, (-e * vn_pre - vn_now) /
                    torch.clamp(w_n, min=1e-9), 0.0)
    imp = j[..., None] * n
    dvel = _sum_c(imp) * w_lin[:, :, None]
    dom = _sum_c(apply_inv_inertia(q_a, ii_a, math3d.cross(r_a, imp)))
    return dvel, dom


def solve_grab_joints(cfg: EnvConfig, pos, quat, eff_inv_m, inv_inertia,
                      target, r2, rel_q, sep):
    """Positional + angular corrections of the per-agent fixed joints.

    Anchor: (x_t + R_t r2) == (x_a + R_a r1'), r1' = (0, 1.25 + sep, 0.5);
    the angular part drives the relative rotation back to ``rel_q``.
    Grab arrays are [W, A(, k)]. Returns (dpos, drot) [W, B, 3].
    """
    n_body = cfg.num_dyn_bodies
    _, _, (agent_lo, agent_hi) = body_slot_ranges(cfg)
    has = target >= 0
    oh = (target[..., None] == torch.arange(n_body, device=pos.device)
          ).to(pos.dtype)                                   # [W, A, B]
    safe = torch.clamp(target, min=0).long()

    def tgt(x):
        g = _gather_b(x, safe)
        hk = has if g.dim() == has.dim() else has[..., None]
        return torch.where(hk, g, torch.zeros((), device=g.device))

    x_a = pos[:, agent_lo:agent_hi]
    q_a = quat[:, agent_lo:agent_hi]
    x_t = tgt(pos)
    q_t = torch.where(has[..., None], tgt(quat),
                      math3d.vec((1.0, 0.0, 0.0, 0.0), quat))
    w_t = torch.where(has, tgt(eff_inv_m), 0.0)
    ii_t = torch.where(has[..., None], tgt(inv_inertia), 0.0)
    w_a = eff_inv_m[:, agent_lo:agent_hi]
    ii_a = inv_inertia[:, agent_lo:agent_hi]

    r1 = torch.stack([torch.zeros_like(sep), 1.25 + sep,
                      torch.full_like(sep, 0.5)], dim=-1)
    p_a = x_a + math3d.quat_rotate(q_a, r1)
    p_t = x_t + math3d.quat_rotate(q_t, r2)
    delta = p_t - p_a
    c_len = math3d.norm(delta)
    nrm = delta / torch.clamp(c_len, min=1e-9)[..., None]

    r_a = p_a - x_a
    r_t = p_t - x_t
    ca = math3d.cross(r_a, nrm)
    ct = math3d.cross(r_t, nrm)
    gw_a = w_a + _dot(ca, apply_inv_inertia(q_a, ii_a, ca))
    gw_t = w_t + _dot(ct, apply_inv_inertia(q_t, ii_t, ct))
    w_sum = gw_a + gw_t
    lam = torch.where(has & (w_sum > 1e-9),
                      c_len / torch.clamp(w_sum, min=1e-9), 0.0)
    imp = lam[..., None] * nrm

    dpos_a = imp * w_a[..., None]
    dpos_t = -imp * w_t[..., None]
    drot_a = apply_inv_inertia(q_a, ii_a, math3d.cross(r_a, imp))
    drot_t = apply_inv_inertia(q_t, ii_t, math3d.cross(r_t, -imp))

    rel_now = math3d.quat_mul(math3d.quat_inv(q_t), q_a)
    err_q = math3d.quat_mul(rel_now, math3d.quat_inv(rel_q))
    sign = torch.sign(err_q[..., :1])
    theta = math3d.quat_rotate(q_t, 2.0 * err_q[..., 1:] * sign)
    ia_th = apply_inv_inertia(q_a, ii_a, theta)
    it_th = apply_inv_inertia(q_t, ii_t, theta)
    ang_w_a = _dot(ia_th, theta)
    ang_w_t = _dot(it_th, theta)
    tnorm2 = _dot(theta, theta)
    denom = ang_w_a + ang_w_t
    scale = torch.where(has & (denom > 1e-9) & (tnorm2 > 1e-12),
                        tnorm2 / torch.clamp(denom, min=1e-9), 0.0)
    drot_a = drot_a - ia_th * scale[..., None]
    drot_t = drot_t + it_th * scale[..., None]

    dpos = torch.einsum("wab,wak->wbk", oh, dpos_t)
    drot = torch.einsum("wab,wak->wbk", oh, drot_t)
    dpos = torch.cat([dpos[:, :agent_lo], dpos[:, agent_lo:agent_hi] + dpos_a,
                      dpos[:, agent_hi:]], dim=1)
    drot = torch.cat([drot[:, :agent_lo], drot[:, agent_lo:agent_hi] + drot_a,
                      drot[:, agent_hi:]], dim=1)
    return dpos, drot


def _tally_substep(tally, man: Manifold, mask, lam, target) -> None:
    """Adds one substep's work counts over all worlds: manifold slots
    refreshed, by kind (``live_*``); contacts solved (``masked``) and
    those with a positive normal impulse (``pushing``), each also for
    pairs alone; grab joints solved (``joints``)."""
    pair = man.kind == KIND_PAIR
    push = mask & (lam > 0.0)
    for key, x in (("live_plane", man.kind == KIND_PLANE),
                   ("live_wall", man.kind == KIND_WALL),
                   ("live_pair", pair), ("masked", mask),
                   ("masked_pair", mask & pair), ("pushing", push),
                   ("pushing_pair", push & pair), ("joints", target >= 0)):
        tally[key] = tally.get(key, 0) + int(x.sum())


def physics_step(cfg: EnvConfig, b, s, g, ext_force, ext_torque,
                 tally: Optional[Dict[str, int]] = None):
    """``cfg.num_physics_substeps`` XPBD substeps for all worlds.

    ``b``, ``s``, ``g``: RigidBodies / StaticGeom / GrabState with the
    world axis FIRST; ext_force/ext_torque [W, B, 3]. Returns the new
    (pos, quat, vel, omega), world axis first. ``tally``, when given,
    gets each substep's work counts added (see ``_tally_substep``).
    """
    h = cfg.dt / cfg.num_physics_substeps
    dynamic = b.active & ~b.locked
    eff_inv_m = torch.where(dynamic, b.inv_mass, 0.0)
    eff_inv_I = torch.where(dynamic[..., None], b.inv_inertia, 0.0)
    verts_local = body_vertices_local(cfg, b.half_ext)

    dyn_f = dynamic[..., None]
    pos_pred = b.pos + cfg.dt * b.vel * dyn_f
    man = build_manifold(cfg, b, s, pos_pred, b.quat, verts_local)
    gravity = math3d.vec(GRAVITY, b.pos)

    pos, quat, vel, omega = b.pos, b.quat, b.vel, b.omega
    for _ in range(cfg.num_physics_substeps):
        acc = gravity * (eff_inv_m > 0.0)[..., None] \
            + ext_force * eff_inv_m[..., None]
        vel_i = vel + h * acc
        ang_acc = apply_inv_inertia(quat, eff_inv_I, ext_torque)
        omega_i = omega + h * ang_acc
        pos_prev, quat_prev = pos, quat
        pos_i = pos + h * vel_i
        quat_i = math3d.quat_integrate(quat, omega_i, h)

        p, n, depth, mask, nb_pos, nb_quat = refresh_contacts(
            man, pos_i, quat_i)
        dpos, drot, cnt, lam, dpos_t, drot_t, w_n = contact_solve(
            man, pos_i, quat_i, eff_inv_m, eff_inv_I, p, n, depth, mask,
            nb_pos, nb_quat, pos_prev, quat_prev)
        if tally is not None:
            _tally_substep(tally, man, mask, lam, g.target)
        norm = 1.0 / torch.clamp(cnt, min=1.0)
        pos_c = pos_i + dpos * norm[..., None] + dpos_t
        quat_c = apply_rot(quat_i, drot * norm[..., None] + drot_t)

        dpos_j, drot_j = solve_grab_joints(
            cfg, pos_c, quat_c, eff_inv_m, eff_inv_I,
            g.target, g.r2, g.rel_q, g.sep)
        pos_c = pos_c + dpos_j
        quat_c = apply_rot(quat_c, drot_j)

        vel_n = (pos_c - pos_prev) / h
        dq = math3d.quat_mul(quat_c, math3d.quat_inv(quat_prev))
        omega_n = 2.0 / h * dq[..., 1:] * torch.sign(dq[..., :1])

        dvel, dom, fcnt = contact_friction(
            man, pos_c, quat_c, vel_n, omega_n, eff_inv_m, eff_inv_I,
            p, n, mask, nb_pos, nb_quat, lam, h)
        fnorm = 1.0 / torch.clamp(fcnt, min=1.0)
        r_pre = p - pos_i[:, :, None, :]
        v_pre = vel_i[:, :, None, :] + math3d.cross(
            omega_i[:, :, None, :].expand_as(r_pre), r_pre)
        vn_pre = _dot(v_pre, n)
        dvel_r, dom_r = contact_restitution(
            man, pos_c, quat_c, vel_n, omega_n, eff_inv_m, eff_inv_I,
            p, n, mask, nb_pos, lam, w_n, vn_pre, cfg.restitution, h)
        vel_n = vel_n + dvel * fnorm[..., None] + dvel_r
        omega_n = omega_n + dom * fnorm[..., None] + dom_r

        vel = torch.where(dyn_f, vel_n, 0.0)
        omega = torch.where(dyn_f, omega_n, 0.0)
        pos = torch.where(dyn_f, pos_c, pos_prev)
        quat = torch.where(dyn_f, quat_c, quat_prev)
    return pos, quat, vel, omega

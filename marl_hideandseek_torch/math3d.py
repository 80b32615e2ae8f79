"""Quaternion and vector math on tensors, in two forms.

* Last-axis form (``quat_*``): quaternions are ``[..., 4]`` (w, x, y, z),
  vectors ``[..., 3]``, any leading batch shape. Port of
  ``marl_hideandseek_tpu/math3d.py``; world up is +z, body forward +y,
  body right +x.
* Component form (``qrot``, ``qmul``, ...): a quaternion is a tuple of 4
  tensors and a vector a tuple of 3, each of any (broadcastable) shape.
  This is the form of the packed step (world axis last), and its op order
  is the one the CUDA kernels copy line by line.
"""

from __future__ import annotations

import math

import torch

from marl_hideandseek_torch.utils import tracing

FWD = (0.0, 1.0, 0.0)
RIGHT = (1.0, 0.0, 0.0)


def vec(c, like: torch.Tensor) -> torch.Tensor:
    """A constant 3- or 4-vector on ``like``'s device and dtype (a copy
    from the host: on the card, the host waits for the stream)."""
    with tracing.span("host_read.vec"):
        return torch.tensor(c, dtype=like.dtype, device=like.device)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def quat_identity(shape=(), device="cpu") -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(norm(q, keepdim=True), min=eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion)."""
    return q * vec((1.0, -1.0, -1.0, -1.0), q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v' = v + 2 (w (u x v) + u x (u x v))."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_inv(q), v)


def quat_from_angle_axis(angle, axis) -> torch.Tensor:
    angle = torch.as_tensor(angle, dtype=torch.float32)
    axis = torch.as_tensor(axis, dtype=torch.float32)
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about +z by ``yaw``."""
    half = 0.5 * yaw
    zero = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zero, zero, torch.sin(half)], -1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Roll/pitch/yaw (reference quatToEuler, src/sim.cpp:372-399)."""
    return torch.stack(euler(q.unbind(-1)), dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """First-order integration by world-frame angular velocity."""
    omega_q = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    dq = 0.5 * dt * quat_mul(omega_q, q)
    return quat_normalize(q + dq)


def obb_world_aabb(pos, q, half_ext):
    """World AABB (lo, hi) of an oriented box centred at ``pos``."""
    m = torch.abs(quat_to_mat(q))
    world_half = torch.sum(m * half_ext[..., None, :], dim=-1)
    return pos - world_half, pos + world_half


def aabb_overlap(lo_a, hi_a, lo_b, hi_b) -> torch.Tensor:
    return torch.all(lo_a <= hi_b, dim=-1) & torch.all(lo_b <= hi_a, dim=-1)


# ---------------------------------------------------------------------------
# Component form (packed step; op order copied by the CUDA kernels)
# ---------------------------------------------------------------------------


def ccross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def qrot(q, v, inv: bool = False):
    """Rotate v by q (or by conj(q) when ``inv``)."""
    w = q[0]
    u = (q[1], q[2], q[3])
    c = ccross(u, v)
    d = ccross(u, c)
    s = -2.0 if inv else 2.0
    return (v[0] + s * w * c[0] + 2.0 * d[0],
            v[1] + s * w * c[1] + 2.0 * d[1],
            v[2] + s * w * c[2] + 2.0 * d[2])


def qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def qconj(q):
    return (q[0], -q[1], -q[2], -q[3])


def qnorm(q):
    inv = torch.rsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                      q[3] * q[3] + 1e-12)
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def euler(q):
    """quatToEuler in component form (reference: src/sim.cpp:372-399)."""
    w, x, y, z = q
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = 2.0 * (w * y - z * x)
    pitch = torch.where(torch.abs(sinp) >= 1.0,
                        torch.sign(sinp) * (math.pi / 2.0),
                        torch.asin(torch.clamp(sinp, -1.0, 1.0)))
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return roll, pitch, yaw


def rel_posvel(a_pos, a_inv_q, a_vel, a_omega, e_pos, e_quat, e_vel,
               e_omega):
    """computeRelativePosVelObs (reference: src/sim.cpp:401-420) in
    component form: observer components broadcast against entity
    components. Returns a list of 12 features (pos 3, euler 3, lin 3,
    ang 3), each in the observer's frame."""
    rel = tuple(e - a for e, a in zip(e_pos, a_pos))
    x = qrot(a_inv_q, rel)
    q = qnorm(qmul(a_inv_q, e_quat))
    eul = euler(q)
    lin = qrot(a_inv_q, tuple(e - a for e, a in zip(e_vel, a_vel)))
    ang = qrot(a_inv_q, tuple(e - a for e, a in zip(e_omega, a_omega)))
    return list(x) + list(eul) + list(lin) + list(ang)

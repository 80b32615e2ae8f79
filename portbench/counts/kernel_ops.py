"""Least work of the port's kernels K4 (megastep, ``csrc/megastep.cu``)
and K5 (RGBD, ``csrc/rgbd.cu``) on a given state.

Frozen from chip_smoke.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb
(the OPS_* constants, ``body_ray_ops``, ``static_ray_ops``, ``sweep_ops``,
``physics_ops``, ``megastep_ops``, ``rgbd_least_ops``), so that a change to a
kernel does not change the count of its work. Operations per primitive were
counted from the sources: every float add, subtract, multiply, divide,
square root, absolute value, min/max and compare is one; negations and
selects are not counted. Each count leaves out some set-up (loads, index
arithmetic, movement decode, grab/lock, rewards, the rare restitution
impulse), so it errs low, and the roofline share with it. The physics'
data-dependent work (contacts solved, joints) is the plain physics' tally
on the same state (``reference/frozen/env/physics.py``).
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.env.observations import num_vis_targets
from portbench.reference.frozen.types import body_slot_ranges

# Rays: ray_body on an OBB (2 rotations, slab test) or a wedge (2
# rotations, 5 faces), ray_aabb on a wall, ray_plane, each with cast_ray's
# two compares.
OPS_RAY_BOX, OPS_RAY_WEDGE, OPS_RAY_WALL, OPS_RAY_PLANE = 101, 160, 44, 20
# Sweep per agent: 2 rotations; per visibility ray 17, per lidar ray 19.
OPS_SWEEP_AGENT, OPS_VIS_RAY, OPS_LIDAR_RAY = 60, 17, 19
# build_manifold per body slot (active or not): 8 vertices x 390 (2
# rotations, 3 planes, 3 wall and 3 pair candidates), the two candidate
# selections and r_bound; plus 12 per active wall and 11 per other active
# body (preselection).
OPS_MANIFOLD_SLOT, OPS_PRESEL_WALL, OPS_PRESEL_BODY = 3585, 12, 11
# Per body slot and substep: integrate 140, combine the solve 81, apply
# the joints 51, velocities from positions 42, combine the velocity
# passes 33.
OPS_SUBSTEP_SLOT = 347
# Per live manifold slot and substep, the refresh: 81 plus the surface
# test by kind.
OPS_REFRESH = {"live_plane": 90, "live_wall": 105, "live_pair": 251}
# Per solved contact and substep: the position solve with static friction
# 409 plus the velocity pass 53; per contact with a positive impulse the
# dynamic friction 190; a pair adds 160 to each; a grab joint 660.
OPS_TALLY = {"masked": 462, "masked_pair": 160, "pushing": 190,
             "pushing_pair": 160, "joints": 660}
# K5 per pixel ray: the camera ray 88; per hit pixel the shading about 100.
OPS_PIXEL_RAY, OPS_PIXEL_SHADE = 88, 100
NUM_LIDAR = 30


def body_ray_ops(cfg, ps) -> torch.Tensor:
    """[B, W] operations of one ray's test against each body slot (0 for
    an inactive body)."""
    _, (rl, rh), _ = body_slot_ranges(cfg)
    per = torch.full((cfg.num_dyn_bodies, 1), float(OPS_RAY_BOX),
                     device=ps.step.device)
    per[rl:rh] = OPS_RAY_WEDGE
    return ps.bodies.active.float() * per


def static_ray_ops(ps) -> torch.Tensor:
    """[W] operations of one ray's tests against a world's statics."""
    s = ps.statics
    return (s.wall_active.float().sum(0) * OPS_RAY_WALL +
            s.plane_active.float().sum(0) * OPS_RAY_PLANE)


def sweep_ops(cfg, ps) -> float:
    """Operations of the sweep: per agent, the visibility targets, 30 lidar
    and 1 grab ray, each against every active primitive but the agent."""
    _, _, (al, ah) = body_slot_ranges(cfg)
    n_tgt = num_vis_targets(cfg)
    per_body = body_ray_ops(cfg, ps)
    per_ray = per_body.sum(0) + static_ray_ops(ps)
    own = per_body[al:ah]
    rays = (n_tgt + NUM_LIDAR + 1) * (per_ray[None] - own)
    return rays.sum().item() + cfg.max_agents * ps.step.numel() * (
        OPS_SWEEP_AGENT + n_tgt * OPS_VIS_RAY + NUM_LIDAR * OPS_LIDAR_RAY)


def physics_ops(cfg, ps, tally: dict) -> float:
    """Operations of the physics step: the manifold build and the
    substeps' per-slot work, plus the refreshes, solves and joints of the
    plain physics' ``tally`` on the same input."""
    n_slot = cfg.num_dyn_bodies
    walls = ps.statics.wall_active.float().sum(0)
    active = ps.bodies.active.float().sum(0)
    manifold = (n_slot * (OPS_MANIFOLD_SLOT + OPS_PRESEL_WALL * walls) +
                OPS_PRESEL_BODY * active * (n_slot - 1)).sum().item()
    substeps = (cfg.num_physics_substeps * n_slot * OPS_SUBSTEP_SLOT *
                ps.step.numel())
    work = sum(OPS_REFRESH.get(k, 0) * v + OPS_TALLY.get(k, 0) * v
               for k, v in tally.items())
    return manifold + substeps + work


def megastep_ops(cfg, ps, tally: dict) -> float:
    """Operations of one K4 launch on this state: the sweep and the
    physics step."""
    return sweep_ops(cfg, ps) + physics_ops(cfg, ps, tally)


def megastep_bytes(cfg, ps, n_targets: int) -> float:
    """Bytes one K4 launch must read and write, each once: the state's
    leaves that the step reads (every leaf of the packed state, which errs
    high by the few it skips), the actions, and the outputs of
    ``ops/step.py::megastep_buffers`` (frozen here as shapes)."""
    w = ps.step.shape[0]
    nb, na = cfg.num_dyn_bodies, cfg.max_agents
    read = sum(t.numel() * t.element_size() for t in ps.leaves())
    actions = na * 5 * 4 * w
    out_per_world = (nb * (3 + 4 + 3 + 3) * 4 + nb * (1 + 4) +
                     na * (4 + 3 * 4 + 4 * 4 + 4) +
                     na * n_targets * 4 + na * NUM_LIDAR * 4 +
                     na * (4 + 4) + 1 + na * (4 + 4) + 4 + 2 * 4 + 2 * 4)
    return float(read + actions + out_per_world * w)


def rgbd_least_ops(depth: torch.Tensor) -> float:
    """The least operations any kernel must do for one K5 launch: the
    camera ray of every pixel, and one primitive test (the cheapest, a
    plane's) and the shading of every hit pixel (``depth`` > 0). It errs
    low whatever a kernel culls."""
    hits = (depth > 0).sum().item()
    return (OPS_PIXEL_RAY * depth.numel() +
            (OPS_PIXEL_SHADE + OPS_RAY_PLANE) * hits)


def rgbd_bytes(ps, rgba: torch.Tensor, depth: torch.Tensor) -> float:
    """Bytes one K5 launch must read and write: the primitives' leaves it
    reads and the image it writes, each once."""
    b, s = ps.bodies, ps.statics
    ins = (b.pos, b.quat, b.half_ext, b.active, b.locked, ps.agent_type,
           s.wall_pos, s.wall_half_ext, s.wall_active, s.plane_point,
           s.plane_normal, s.plane_active)
    return float(sum(t.numel() * t.element_size() for t in ins + (rgba, depth)))

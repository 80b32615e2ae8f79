"""Level generation, batched over worlds: the procedural training arena
(level 1) and the debug levels 2-8.

Port of ``marl_hideandseek_tpu/env/levelgen.py`` (reference:
src/level_gen.cpp). Generation fills a fixed-capacity packed state -
box, ramp, agent and wall slots with active masks - for ``k`` worlds at
once; rejection placement samples all 21 candidate poses (20 rejections
and a forced accept) per entity and world and keeps the first one that
clears every placed AABB, as the reference's sequential accept loop
does. Draws follow the JAX generator's key tree from each world's level
key (``prng.py``), drawn up front in a few batched launches
(``level_draws``), so a world equals JAX's ``generate_world`` for its key.

On CUDA tensors level 1 is one launch of K7 (``ops/levelgen.py``,
``csrc/levelgen.cu``), which maps those draws to every leaf of the packed
state; on CPU tensors the plain generator below
(``generate_training_world``) runs op by op and is K7's oracle.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from marl_hideandseek_torch import math3d, prng
from marl_hideandseek_torch.config import (
    ARENA_HALF,
    MAX_PLANES,
    MAX_WALLS,
    EnvConfig,
)
from marl_hideandseek_torch.env import geometry
from marl_hideandseek_torch.ops import levelgen as ops_levelgen
from marl_hideandseek_torch.ops import threefry as tf
from marl_hideandseek_torch.types import (
    AGENT_HIDER,
    AGENT_SEEKER,
    INV_MASS_AGENT,
    INV_MASS_BOX,
    INV_MASS_RAMP,
    MU_D_AGENT,
    MU_D_CUBE,
    MU_D_ELONGATED,
    MU_D_RAMP,
    OWNER_NONE,
    OWNER_UNOWNABLE,
    EnvState,
    GrabState,
    RigidBodies,
    StaticGeom,
    body_slot_ranges,
    pack_state,
)
from marl_hideandseek_torch.utils import tracing

CUBE_HALF = (1.0, 1.0, 1.0)
ELONGATED_HALF = (4.0, 0.75, 1.0)
AGENT_HALF = (1.0, 1.0, 1.0)
RAMP_HALF = (1.0, 1.5, 1.0)          # OBB of the wedge
RAMP_CENTER_OFF = (0.0, -0.5, 0.0)   # wedge OBB centre in the body frame
MAX_REJECTIONS = 20


def box_inv_inertia(half_ext: torch.Tensor, inv_mass: torch.Tensor):
    """Diagonal inverse inertia of a solid box (body frame)."""
    a2 = half_ext[..., 0] ** 2
    b2 = half_ext[..., 1] ** 2
    c2 = half_ext[..., 2] ** 2
    m = 1.0 / torch.clamp(inv_mass, min=1e-9)
    i = (m / 3.0)[..., None] * torch.stack([b2 + c2, a2 + c2, a2 + b2], -1)
    return torch.where(inv_mass[..., None] > 0.0,
                       1.0 / torch.clamp(i, min=1e-9), 0.0)


def empty_world(cfg: EnvConfig, k: int, device) -> EnvState:
    """k all-inactive worlds, world axis FIRST."""
    nb, na = cfg.num_dyn_bodies, cfg.max_agents
    f = dict(device=device)
    z = lambda *s: torch.zeros((k,) + s, **f)
    ones = lambda *s: torch.ones((k,) + s, **f)
    plane_normal = z(MAX_PLANES, 3)
    plane_normal[..., 2] = 1.0
    plane_active = torch.zeros((k, MAX_PLANES), dtype=torch.bool, **f)
    plane_active[:, 0] = True
    return EnvState(
        bodies=RigidBodies(
            pos=z(nb, 3), quat=math3d.quat_identity((k, nb), device),
            vel=z(nb, 3), omega=z(nb, 3), half_ext=ones(nb, 3),
            inv_mass=z(nb), inv_inertia=z(nb, 3), friction_mu=ones(nb),
            active=torch.zeros((k, nb), dtype=torch.bool, **f),
            locked=torch.zeros((k, nb), dtype=torch.bool, **f),
            owner=torch.full((k, nb), OWNER_NONE, dtype=torch.int32, **f)),
        statics=StaticGeom(
            wall_pos=z(MAX_WALLS, 3), wall_half_ext=ones(MAX_WALLS, 3),
            wall_active=torch.zeros((k, MAX_WALLS), dtype=torch.bool, **f),
            plane_point=z(MAX_PLANES, 3), plane_normal=plane_normal,
            plane_active=plane_active),
        grab=GrabState(
            target=torch.full((k, na), -1, dtype=torch.int32, **f),
            r2=z(na, 3), rel_q=math3d.quat_identity((k, na), device),
            sep=z(na)),
        agent_type=torch.zeros((k, na), dtype=torch.int32, **f),
        agent_active=torch.zeros((k, na), dtype=torch.bool, **f),
        num_hiders=torch.zeros(k, dtype=torch.int32, **f),
        num_seekers=torch.zeros(k, dtype=torch.int32, **f),
        num_active_boxes=torch.zeros(k, dtype=torch.int32, **f),
        num_active_ramps=torch.zeros(k, dtype=torch.int32, **f),
        step=torch.zeros(k, dtype=torch.int32, **f),
        episode_counter=torch.zeros(k, dtype=torch.uint32, **f),
        ep_key=torch.zeros((k, 2), dtype=torch.uint32, **f),
        level_key=torch.zeros((k, 2), dtype=torch.uint32, **f),
        seekers_first=torch.zeros(k, dtype=torch.bool, **f),
        running_scores=torch.zeros((k, 2), dtype=torch.int32, **f),
        finished_scores=z(2),
        hider_team_reward=ones(),
        act_hit_t=torch.full((k, na), math.inf, **f),
        act_hit_id=torch.full((k, na), -1, dtype=torch.int32, **f),
    )


def _set_body(b: RigidBodies, slot: int, *, pos, quat, half_ext, inv_mass,
              inv_inertia, friction_mu, active, locked, owner,
              vel=None, omega=None) -> None:
    """Write body ``slot`` of world-first bodies in place (k worlds)."""
    b.pos[:, slot] = pos
    b.quat[:, slot] = quat
    b.vel[:, slot] = 0.0 if vel is None else vel
    b.omega[:, slot] = 0.0 if omega is None else omega
    b.half_ext[:, slot] = half_ext
    b.inv_mass[:, slot] = inv_mass
    b.inv_inertia[:, slot] = inv_inertia
    b.friction_mu[:, slot] = friction_mu
    b.active[:, slot] = active
    b.locked[:, slot] = locked
    b.owner[:, slot] = owner


def _rejection_place(xy, yaw, placed_lo, placed_hi, placed_mask, half_ext,
                     center_off):
    """21 candidate poses per world: xy ``[n, 21, 2]`` uniform in [-18,
    18]^2 at z = 1, yaw ``[n, 21]`` uniform in [0, pi); the first whose
    rotated AABB clears every placed AABB wins, else the last
    (level_gen.cpp:125-156).
    half_ext [n, 3]; returns (pos, quat, lo, hi), each [n, 3|4]."""
    dev = placed_lo.device
    n, n_trials = yaw.shape
    pos = torch.cat([xy, torch.ones((n, n_trials, 1), device=dev)], -1)
    quat = math3d.quat_from_yaw(yaw)
    off = math3d.vec(center_off, pos).expand(n, n_trials, 3)
    centers = pos + math3d.quat_rotate(quat, off)
    lo, hi = math3d.obb_world_aabb(
        centers, quat, half_ext[:, None, :].expand(n, n_trials, 3))
    overlap = math3d.aabb_overlap(lo[:, :, None], hi[:, :, None],
                                  placed_lo[:, None], placed_hi[:, None])
    any_overlap = (overlap & placed_mask[:, None, :]).any(-1)   # [n, T]
    ok_rank = torch.where(~any_overlap,
                          torch.arange(n_trials, device=dev), n_trials)
    win = torch.clamp(torch.argmin(ok_rank, dim=-1), max=n_trials - 1)
    ar = torch.arange(n, device=dev)
    return pos[ar, win], quat[ar, win], lo[ar, win], hi[ar, win]


class LevelDraws(NamedTuple):
    """Every draw of level 1 for n worlds: ``counts [n, 2, 2]`` u32, the
    (high, low) words of the box count's and the elongated count's
    randints; ``pose_u [n, slots, 2, 2 x 21]`` f32, each body slot's
    position uniforms (x, y of 21 trials) and yaw uniforms (the first
    21); the walls' draws. K7 (``ops/levelgen.py``) reads them as they
    are."""

    counts: torch.Tensor
    pose_u: torch.Tensor
    walls: geometry.WallDraws


def level_draws(cfg: EnvConfig, level_key: torch.Tensor) -> LevelDraws:
    """The draws of the worlds of ``level_key [n, 2]``, from JAX's key
    tree (levelgen.py:247-291): ``k_counts, k_place = split(key)``, the
    counts from ``split(k_counts)``, the walls from ``fold_in(k_place,
    1000)``, slot i's poses from ``split(fold_in(k_place, 2000),
    slots)[i]`` split into the position and the yaw key."""
    n_ent = cfg.max_boxes + cfg.max_ramps + cfg.max_agents
    k_counts, k_place = prng.split(level_key).unbind(1)
    counts = prng.bits(prng.split(prng.split(k_counts)))     # [n, 2, 2]
    # Every slot's poses in one launch: the yaw key's first 21 draws of
    # the 42 the position key takes.
    k_pose = prng.split(prng.split(prng.fold_in(k_place, 2000), n_ent))
    pose_u = prng.uniform(k_pose, (2 * (MAX_REJECTIONS + 1),))
    walls = geometry.draw_walls(prng.fold_in(k_place, 1000))
    return LevelDraws(counts=counts, pose_u=pose_u, walls=walls)


def _training_geometry(cfg: EnvConfig, level_key: torch.Tensor):
    """Level-1 layout of the worlds of ``level_key [n, 2]``
    (level_gen.cpp:79-308) from their draws (``level_draws``): box
    counts, walls, and every slot's placement. Returns a world-first
    state of n worlds with all agent slots placed (their activity and
    types are set by the caller) and the box counts."""
    nb, nr, na = cfg.max_boxes, cfg.max_ramps, cfg.max_agents
    n, device = level_key.shape[0], level_key.device
    n_trials = MAX_REJECTIONS + 1
    st = empty_world(cfg, n, device)
    b = st.bodies

    d = level_draws(cfg, level_key)
    hi, lo = tf.words(d.counts[..., 0]), tf.words(d.counts[..., 1])
    total_boxes = prng.randint_from_bits(hi[:, 0], lo[:, 0], 3,
                                         cfg.max_boxes + 1)
    num_elong = 3 + prng.randint_from_bits(
        hi[:, 1], lo[:, 1], 0, torch.clamp(total_boxes - 3, min=1))
    num_elong = torch.minimum(num_elong, total_boxes)
    u = d.pose_u                                         # [n, slots, 2, 42]
    xy_all = prng.uniform_scale(u[:, :, 0], -ARENA_HALF, ARENA_HALF).reshape(
        n, nb + nr + na, n_trials, 2)
    yaw_all = u[:, :, 1, :n_trials] * math.pi

    ws = geometry.build_walls(d.walls)
    ws = geometry.scale_walls(ws, -ARENA_HALF, ARENA_HALF)
    wall_pos, wall_half, wall_act = geometry.walls_to_obbs(ws)
    st = st.replace(statics=st.statics.replace(
        wall_pos=wall_pos, wall_half_ext=wall_half, wall_active=wall_act))

    n_cap = MAX_WALLS + nb + nr
    placed_lo = torch.zeros((n, n_cap, 3), device=device)
    placed_hi = torch.zeros((n, n_cap, 3), device=device)
    placed_mask = torch.zeros((n, n_cap), dtype=torch.bool, device=device)
    placed_lo[:, :MAX_WALLS] = wall_pos - wall_half
    placed_hi[:, :MAX_WALLS] = wall_pos + wall_half
    placed_mask[:, :MAX_WALLS] = wall_act

    def const(c):
        with tracing.span("host_read.levelgen_consts"):
            return torch.tensor(c, device=device).expand(n, len(c))

    for slot in range(nb + nr + na):
        if slot < nb:
            is_elong = (slot < num_elong)[:, None]
            half = torch.where(is_elong, const(ELONGATED_HALF),
                               const(CUBE_HALF))
            friction = torch.where(is_elong[:, 0], MU_D_ELONGATED, MU_D_CUBE)
            inv_mass = torch.full((n,), INV_MASS_BOX, device=device)
            off = (0.0, 0.0, 0.0)
            active = slot < total_boxes
        elif slot < nb + nr:
            half = const(RAMP_HALF)
            friction = torch.full((n,), MU_D_RAMP, device=device)
            inv_mass = torch.full((n,), INV_MASS_RAMP, device=device)
            off = RAMP_CENTER_OFF
            active = torch.ones(n, dtype=torch.bool, device=device)
        else:
            half = const(AGENT_HALF)
            friction = torch.full((n,), MU_D_AGENT, device=device)
            inv_mass = torch.full((n,), INV_MASS_AGENT, device=device)
            off = (0.0, 0.0, 0.0)
            active = torch.ones(n, dtype=torch.bool, device=device)

        pos, quat, lo, hi = _rejection_place(
            xy_all[:, slot], yaw_all[:, slot], placed_lo, placed_hi,
            placed_mask, half, off)
        inv_inertia = box_inv_inertia(half, inv_mass)
        if slot >= nb + nr:
            # Agents only yaw (reference: src/mgr.cpp:576-584).
            inv_inertia = inv_inertia * math3d.vec((0.0, 0.0, 1.0),
                                                   inv_inertia)
            owner = OWNER_UNOWNABLE
        else:
            owner = OWNER_NONE
        _set_body(b, slot, pos=pos, quat=quat, half_ext=half,
                  inv_mass=inv_mass, inv_inertia=inv_inertia,
                  friction_mu=friction, active=active,
                  locked=torch.zeros_like(active),
                  owner=torch.where(active, owner, OWNER_NONE).to(
                      torch.int32))
        if slot < nb + nr:
            # Agents are not added to the overlap set (level_gen.cpp:285).
            j = MAX_WALLS + slot
            act = active[:, None]
            placed_lo[:, j] = torch.where(act, lo, placed_lo[:, j])
            placed_hi[:, j] = torch.where(act, hi, placed_hi[:, j])
            placed_mask[:, j] = placed_mask[:, j] | active
    return st, total_boxes


def generate_training_world(cfg: EnvConfig, level_key, ep_key,
                            num_hiders, num_seekers, seekers_first):
    """Level 1 for k worlds, world axis FIRST, from their level keys
    ``[2, k]`` u32. Under ``UseFixedWorld`` every level key is zero (the
    episode draws set it so): one layout is drawn and shared by all
    worlds."""
    k = num_hiders.shape[0]
    dev = num_hiders.device
    _, _, (agent_lo, agent_hi) = body_slot_ranges(cfg)
    if cfg.use_fixed_world:
        zero = torch.zeros((1, 2), dtype=torch.uint32, device=dev)
        st1, tb1 = _training_geometry(cfg, zero)
        st = st1.map(lambda x: x.expand((k,) + x.shape[1:]).clone())
        total_boxes = tb1.expand(k).clone()
    else:
        st, total_boxes = _training_geometry(
            cfg, level_key.view(torch.int32).T.contiguous().view(torch.uint32))

    na = cfg.max_agents
    idx = torch.arange(na, device=dev)
    size0 = torch.where(seekers_first, num_seekers, num_hiders)
    type0 = torch.where(seekers_first, AGENT_SEEKER, AGENT_HIDER)
    type1 = torch.where(seekers_first, AGENT_HIDER, AGENT_SEEKER)
    agent_act = idx < (num_hiders + num_seekers)[:, None]
    types = torch.where(idx < size0[:, None], type0[:, None], type1[:, None])
    b = st.bodies
    b.active[:, agent_lo:agent_hi] = agent_act
    b.owner[:, agent_lo:agent_hi] = torch.where(
        agent_act, OWNER_UNOWNABLE, OWNER_NONE).to(torch.int32)
    return st.replace(
        agent_type=torch.where(agent_act, types, 0).to(torch.int32),
        agent_active=agent_act,
        num_hiders=num_hiders.to(torch.int32),
        num_seekers=num_seekers.to(torch.int32),
        num_active_boxes=total_boxes.to(torch.int32),
        num_active_ramps=torch.full((k,), cfg.max_ramps, dtype=torch.int32,
                                    device=dev),
        seekers_first=seekers_first.clone(),
        level_key=level_key.T.contiguous(),
        ep_key=ep_key.T.contiguous())


# ---------------------------------------------------------------------------
# Debug levels 2-8 (reference: src/level_gen.cpp:336-526)
# ---------------------------------------------------------------------------


def _q_aa(deg, axis):
    return math3d.quat_from_angle_axis(
        torch.deg2rad(torch.tensor(deg, dtype=torch.float32)),
        torch.tensor(axis, dtype=torch.float32))


def _body(st, slot, pos, quat, half, inv_mass, friction, locked=False,
          owner=OWNER_NONE, vel=None):
    half = torch.tensor(half)
    inv_m = torch.tensor(inv_mass)
    _set_body(st.bodies, slot, pos=torch.tensor(pos), quat=quat,
              half_ext=half, inv_mass=inv_m,
              inv_inertia=box_inv_inertia(half, inv_m),
              friction_mu=friction, active=True, locked=locked, owner=owner,
              vel=None if vel is None else torch.tensor(vel))


def _add_box(st, cfg, i, pos, quat, half, locked=False):
    _body(st, i, pos, quat, half, INV_MASS_BOX, MU_D_CUBE, locked=locked)


def _add_ramp(st, cfg, i, pos, quat, locked=False, vel=None):
    _, (ramp_lo, _), _ = body_slot_ranges(cfg)
    _body(st, ramp_lo + i, pos, quat, RAMP_HALF, INV_MASS_RAMP, MU_D_RAMP,
          locked=locked, vel=vel)


def _add_agent(st, cfg, i, pos, quat, agent_type):
    _, _, (agent_lo, _) = body_slot_ranges(cfg)
    slot = agent_lo + i
    _body(st, slot, pos, quat, AGENT_HALF, INV_MASS_AGENT, MU_D_AGENT,
          owner=OWNER_UNOWNABLE)
    st.bodies.inv_inertia[:, slot] *= torch.tensor([0.0, 0.0, 1.0])
    st.agent_type[:, i] = agent_type
    st.agent_active[:, i] = True
    if agent_type == AGENT_HIDER:
        st.num_hiders += 1
    else:
        st.num_seekers += 1


def _add_side_planes(st):
    s = st.statics
    s.plane_point[:, 1] = torch.tensor([-20.0, 0.0, 0.0])
    s.plane_point[:, 2] = torch.tensor([20.0, 0.0, 0.0])
    s.plane_normal[:, 1] = torch.tensor([1.0, 0.0, 0.0])
    s.plane_normal[:, 2] = torch.tensor([-1.0, 0.0, 0.0])
    s.plane_active[:, 1:3] = True


def debug_level(cfg: EnvConfig, level: int) -> EnvState:
    """One world of debug level 2-8, world axis FIRST, on the CPU."""
    st = empty_world(cfg, 1, "cpu")
    ident = math3d.quat_identity()
    if level == 2:      # tilted cube drop
        rot = math3d.quat_normalize(math3d.quat_mul(
            math3d.quat_from_angle_axis(torch.atan(torch.tensor(
                1.0 / math.sqrt(2.0))), torch.tensor([0.0, 1.0, 0.0])),
            _q_aa(45.0, [1.0, 0.0, 0.0])))
        _add_box(st, cfg, 0, [0.0, 0.0, 5.0], rot, CUBE_HALF)
    elif level == 3:    # axis-aligned cube drop
        _add_box(st, cfg, 0, [0.0, 0.0, 5.0], ident, CUBE_HALF)
    elif level == 4:    # elongated box at 45 degrees
        _add_box(st, cfg, 0, [0.0, 0.0, 10.0], _q_aa(45.0, [0.0, 1.0, 0.0]),
                 ELONGATED_HALF)
    elif level == 5:    # lone hider
        _add_agent(st, cfg, 0, [0.0, 0.0, 1.0], ident, AGENT_HIDER)
    elif level == 6:    # wall + cube + hider + seeker
        s = st.statics
        s.wall_pos[:, 0] = torch.tensor([0.0, 0.0, 1.25])
        s.wall_half_ext[:, 0] = torch.tensor([10.0, 0.2, 1.25])
        s.wall_active[:, 0] = True
        _add_box(st, cfg, 0, [0.0, -5.0, 1.0], ident, CUBE_HALF)
        _add_agent(st, cfg, 0, [-15.0, -15.0, 1.5],
                   _q_aa(-45.0, [0.0, 0.0, 1.0]), AGENT_HIDER)
        if cfg.max_agents >= 2:
            _add_agent(st, cfg, 1, [-15.0, -10.0, 1.5],
                       _q_aa(45.0, [0.0, 0.0, 1.0]), AGENT_SEEKER)
    elif level == 7:    # two stacked tilted cubes in a 3-plane corner
        rot = math3d.quat_normalize(math3d.quat_mul(
            _q_aa(45.0, [0.0, 1.0, 0.0]), _q_aa(40.0, [1.0, 0.0, 0.0])))
        _add_box(st, cfg, 0, [0.0, 0.0, 5.0], rot, CUBE_HALF)
        _add_box(st, cfg, 1, [0.0, 0.0, 10.0], rot, CUBE_HALF)
        _add_side_planes(st)
    elif level == 8:    # ramp dropped onto a static ramp
        ramp_rot = math3d.quat_normalize(math3d.quat_mul(
            math3d.quat_mul(_q_aa(25.0, [0.0, 1.0, 0.0]),
                            _q_aa(90.0, [0.0, 0.0, 1.0])),
            _q_aa(45.0, [1.0, 0.0, 0.0])))
        _add_ramp(st, cfg, 0, [0.0, 0.0, 10.0], ramp_rot,
                  vel=[0.0, 0.0, -30.0])
        static_rot = math3d.quat_normalize(math3d.quat_mul(
            _q_aa(-90.0, [1.0, 0.0, 0.0]), _q_aa(180.0, [0.0, 1.0, 0.0])))
        _add_ramp(st, cfg, 1, [-0.5, -0.5, 1.0], static_rot, locked=True)
        _add_side_planes(st)
    else:
        raise ValueError(f"no debug level {level}")
    return st


def training_world_packed(cfg: EnvConfig, level_key, ep_key, num_hiders,
                          num_seekers, seekers_first) -> EnvState:
    """Level 1 for k worlds, PACKED (arguments as
    ``generate_training_world``): on CUDA tensors one launch of K7
    (``ops/levelgen.py``) from the worlds' draws, on CPU tensors the plain
    generator. Under ``UseFixedWorld`` K7 reads the zero key's draws for
    every world."""
    if num_hiders.device.type == "cpu":
        return pack_state(generate_training_world(
            cfg, level_key, ep_key, num_hiders, num_seekers, seekers_first))
    contig = lambda k: prng.u32(prng.i32(k).contiguous())
    return ops_levelgen.training_world_kernel(
        cfg, training_draws(cfg, level_key), contig(level_key),
        contig(ep_key), num_hiders.long().contiguous(),
        num_seekers.long().contiguous(), seekers_first.contiguous())


def training_draws(cfg: EnvConfig, level_key) -> LevelDraws:
    """The draws K7 reads for the worlds of ``level_key [2, k]`` u32: one
    row a world, or under ``UseFixedWorld`` the zero key's single row."""
    if cfg.use_fixed_world:
        keys = torch.zeros((1, 2), dtype=torch.uint32,
                           device=level_key.device)
    else:
        keys = prng.u32(prng.i32(level_key).T.contiguous())
    return level_draws(cfg, keys)


def with_debug_levels(cfg: EnvConfig, ps: EnvState, level_ids) -> EnvState:
    """Packed worlds ``ps`` with the worlds of ``level_ids`` 2-8 replaced
    by those debug levels (ids above 8 are level 8, the JAX switch's
    clip), keeping their keys."""
    lvl = torch.clamp(level_ids, 1, 8)
    # Two waits: unique's output size, then the copy to the host.
    with tracing.span("host_read.levels"):
        levels = torch.unique(lvl)
    with tracing.span("host_read.levels"):
        levels = levels.tolist()
    debug = sorted(int(v) for v in levels if v != 1)
    for level in debug:
        m = lvl == level
        tmpl = pack_state(debug_level(cfg, level)).map(
            lambda x: x.to(m.device))
        tmpl = tmpl.replace(level_key=ps.level_key, ep_key=ps.ep_key)

        def pick(new, old, m=m):
            if old.dtype == torch.uint32:
                return torch.where(m, new.view(torch.int32),
                                   old.view(torch.int32)).view(torch.uint32)
            return torch.where(m, new, old)

        ps = tmpl.map2(ps, pick)
    return ps


def generate_world(cfg: EnvConfig, level_key, ep_key, level_ids,
                   num_hiders, num_seekers, seekers_first) -> EnvState:
    """k fresh worlds by level id, PACKED (world axis last). Level 1 (and
    any id below 2) is the training arena (``training_world_packed``),
    2-8 the debug fixtures. level_key/ep_key are [2, k] u32."""
    return with_debug_levels(cfg, training_world_packed(
        cfg, level_key, ep_key, num_hiders, num_seekers, seekers_first),
        level_ids)


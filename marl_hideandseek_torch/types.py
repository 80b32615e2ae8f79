"""State types of the PyTorch port: dataclasses of tensors.

Mirrors ``marl_hideandseek_tpu/types.py`` field for field and in the same
order, so a state converts leaf by leaf between the two packages
(``bridge.py``). Dynamic rigid bodies live in one slot array per world:

  slot [0, max_boxes)                      -> boxes (OBBs)
  slot [max_boxes, max_boxes+max_ramps)    -> ramps (wedges)
  slot [.., .. + max_agents)               -> agents (OBBs, half-extent 1)

The port keeps the JAX package's *packed* layout everywhere: every leaf
has its world axis LAST (``pos [B, 3, W]``, ``step [W]``), so a CUDA thread
per world reads consecutive addresses across a warp. ``pack_state`` /
``unpack_state`` move the world axis between first and last.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from marl_hideandseek_torch.config import EnvConfig

# Owner-team encoding (reference: src/sim.hpp:127-132).
OWNER_NONE = 0
OWNER_SEEKER = 1
OWNER_HIDER = 2
OWNER_UNOWNABLE = 3

# Agent type encoding (reference: src/sim.hpp:138-141).
AGENT_SEEKER = 0
AGENT_HIDER = 1

# Inverse masses (reference: src/mgr.cpp:521-559).
INV_MASS_BOX = 0.5
INV_MASS_RAMP = 0.5
INV_MASS_AGENT = 1.0

# Dynamic friction coefficients (reference: src/mgr.cpp:476-559).
MU_D_CUBE = 2.0
MU_D_ELONGATED = 4.0
MU_D_RAMP = 1.0
MU_D_AGENT = 16.0


class _Tree:
    """Field-ordered tensor container helpers shared by the state types."""

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """Apply ``fn`` to every tensor leaf, recursing into sub-trees."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.map(fn) if isinstance(v, _Tree) else fn(v)
        return type(self)(**out)

    def map2(self, other, fn):
        """``fn(a, b)`` leaf by leaf over two trees of the same type."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            out[f.name] = a.map2(b, fn) if isinstance(a, _Tree) else fn(a, b)
        return type(self)(**out)

    def leaves(self):
        """Tensor leaves in field order (the JAX pytree leaf order)."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out.extend(v.leaves() if isinstance(v, _Tree) else [v])
        return out


@dataclasses.dataclass
class RigidBodies(_Tree):
    pos: torch.Tensor          # [B, 3, W] f32
    quat: torch.Tensor         # [B, 4, W] f32 (w, x, y, z)
    vel: torch.Tensor          # [B, 3, W] f32
    omega: torch.Tensor        # [B, 3, W] f32
    half_ext: torch.Tensor     # [B, 3, W] f32
    inv_mass: torch.Tensor     # [B, W] f32
    inv_inertia: torch.Tensor  # [B, 3, W] f32 body-frame diagonal
    friction_mu: torch.Tensor  # [B, W] f32
    active: torch.Tensor       # [B, W] bool
    locked: torch.Tensor       # [B, W] bool
    owner: torch.Tensor        # [B, W] i32


@dataclasses.dataclass
class StaticGeom(_Tree):
    wall_pos: torch.Tensor       # [MW, 3, W] f32
    wall_half_ext: torch.Tensor  # [MW, 3, W] f32
    wall_active: torch.Tensor    # [MW, W] bool
    plane_point: torch.Tensor    # [P, 3, W] f32
    plane_normal: torch.Tensor   # [P, 3, W] f32
    plane_active: torch.Tensor   # [P, W] bool


@dataclasses.dataclass
class GrabState(_Tree):
    target: torch.Tensor  # [A, W] i32 dynamic-body slot, -1 = none
    r2: torch.Tensor      # [A, 3, W] f32 attach point, target frame
    rel_q: torch.Tensor   # [A, 4, W] f32 attach rotation, target frame
    sep: torch.Tensor     # [A, W] f32


@dataclasses.dataclass
class EnvState(_Tree):
    bodies: RigidBodies
    statics: StaticGeom
    grab: GrabState
    agent_type: torch.Tensor         # [A, W] i32
    agent_active: torch.Tensor       # [A, W] bool
    num_hiders: torch.Tensor         # [W] i32
    num_seekers: torch.Tensor        # [W] i32
    num_active_boxes: torch.Tensor   # [W] i32
    num_active_ramps: torch.Tensor   # [W] i32
    step: torch.Tensor               # [W] i32
    episode_counter: torch.Tensor    # [W] u32
    ep_key: torch.Tensor             # [2, W] u32
    level_key: torch.Tensor          # [2, W] u32
    seekers_first: torch.Tensor      # [W] bool
    running_scores: torch.Tensor     # [2, W] i32
    finished_scores: torch.Tensor    # [2, W] f32
    hider_team_reward: torch.Tensor  # [W] f32
    act_hit_t: torch.Tensor          # [A, W] f32 (+inf miss)
    act_hit_id: torch.Tensor         # [A, W] i32 (-1 miss)

    @property
    def num_worlds(self) -> int:
        return self.step.shape[-1]


def body_slot_ranges(cfg: EnvConfig):
    """(box_lo, box_hi), (ramp_lo, ramp_hi), (agent_lo, agent_hi)."""
    b1 = cfg.max_boxes
    r1 = b1 + cfg.max_ramps
    a1 = r1 + cfg.max_agents
    return (0, b1), (b1, r1), (r1, a1)


def pack_state(state: EnvState) -> EnvState:
    """World axis first -> last on every leaf."""
    return state.map(lambda x: torch.movedim(x, 0, -1).contiguous())


def unpack_state(pstate: EnvState) -> EnvState:
    """World axis last -> first on every leaf."""
    return pstate.map(lambda x: torch.movedim(x, -1, 0).contiguous())


def on_bits(fn):
    """Run a leaf op on u32 leaves through their i32 view (PyTorch
    implements few ops for uint32); the bits are unchanged."""
    def g(*xs):
        if xs[0].dtype == torch.uint32:
            return fn(*(x.view(torch.int32) for x in xs)).view(torch.uint32)
        return fn(*xs)
    return g


def pack_actions(actions: torch.Tensor) -> torch.Tensor:
    """[W, A, 5] -> [A, 5, W]."""
    return torch.movedim(actions, 0, -1).contiguous()


class SweepResults(NamedTuple):
    """Per-step ray-sweep outputs, packed (world axis last)."""

    vis_seen: torch.Tensor  # [A, T, W] f32 final visibility mask values
    lidar: torch.Tensor     # [A, 30, W] f32 depths (0 on miss)
    act_t: torch.Tensor     # [A, W] f32 next-step grab/lock hit t
    act_id: torch.Tensor    # [A, W] i32 next-step grab/lock hit entity
    rew_seen: torch.Tensor  # [W] bool seeker-sees-hider flag


class PackedStepResult(NamedTuple):
    obs: dict                       # flat-feature dict, leaves [W, A, F]
    rewards: torch.Tensor           # [A, W] f32
    dones: torch.Tensor             # [A, W] i32
    episode_results: torch.Tensor   # [2, W] f32
    # Hider-team reward of this transition, captured before any reset
    # regeneration overwrites the state (+1 hidden / -1 seen).
    team_reward: Optional[torch.Tensor] = None  # [W] f32


class StepResult(NamedTuple):
    """Outputs of one classic (world-major) env step (reference:
    src/mgr.cpp:1338-1375)."""

    obs: dict                       # named observations, leaves [W, A, ...]
    rewards: torch.Tensor           # [W, A, 1] f32
    dones: torch.Tensor             # [W, A, 1] i32
    episode_results: torch.Tensor   # [W, 2] f32

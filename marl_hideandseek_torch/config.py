"""Environment configuration for the PyTorch port.

A standalone copy of ``marl_hideandseek_tpu/config.py`` (the port imports
nothing from the JAX package): the same ``SimFlags`` bits, capacity and
episode constants, and the frozen ``EnvConfig`` with its validation and
derived quantities. Counts are Python ints, so every tensor shape follows
from the config alone.
"""

from __future__ import annotations

import dataclasses
import enum


class SimFlags(enum.IntFlag):
    """Bit-compatible with the reference enum (src/sim_flags.hpp:7-13)."""

    Default = 0
    UseFixedWorld = 1 << 0
    IgnoreEpisodeLength = 1 << 1
    RandomFlipTeams = 1 << 2
    ZeroAgentVelocity = 1 << 3


# World capacity constants (reference: src/sim.hpp:39-41). The CUDA
# kernels are compiled for these maxima and take the live counts at run
# time, so one build serves every capacity up to them.
MAX_BOXES = 9
MAX_RAMPS = 2
MAX_AGENTS = 6
# Wall grammar bound: 4 seed walls + 6 connect ops x 4 + 6 door ops x 1
# = 34 live segments at most, rounded up.
MAX_WALLS = 36
# Ground planes: the floor and up to 2 side planes of the debug levels.
MAX_PLANES = 3
# Episode constants (reference: src/sim.cpp:14-17).
DT = 1.0 / 30.0
NUM_PHYSICS_SUBSTEPS = 4
NUM_PREP_STEPS = 96
EPISODE_LEN = 240

# Levels are scaled into [-ARENA_HALF, ARENA_HALF]^2.
ARENA_HALF = 18.0

# Lidar (reference: src/sim.cpp:712-759).
NUM_LIDAR_SAMPLES = 30
LIDAR_MAX_RANGE = 200.0

# Visibility cone: 135 degree field of view (reference: src/sim.cpp:582).
VIS_FOV_DEGREES = 135.0

# Grab / lock interaction ray length (reference: src/sim.cpp:288-289).
INTERACT_RAY_LEN = 2.5

# Out-of-bounds penalty (reference: src/sim.cpp:834-838).
OOB_LIMIT = 18.0
OOB_PENALTY = 10.0

# Each agent's rendered view when EnvConfig.render_frames is set: the
# batch renderer's 64x64 RGBD (scripts/benchmark.py), fov 90 degrees,
# depth scaled by its 200-unit range (ops/rgbd.py), under this key.
FRAME_KEY = "rgbd"
FRAME_SIZE = 64
FRAME_FOV = 90.0
FRAME_MAX_DEPTH = 200.0


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (reference: src/mgr.hpp:16-32)."""

    num_worlds: int = 2
    min_hiders: int = 2
    max_hiders: int = 2
    min_seekers: int = 2
    max_seekers: int = 2
    sim_flags: SimFlags = SimFlags.Default
    rand_seed: int = 5
    num_pbt_policies: int = 0

    max_boxes: int = MAX_BOXES
    max_ramps: int = MAX_RAMPS
    max_walls: int = MAX_WALLS

    # Staggered-reset budget: when 0 < budget < num_worlds and at most
    # `budget` worlds reset on a step, only those worlds are regenerated
    # and merged back; larger bursts regenerate the whole batch.
    reset_budget: int = 256

    episode_len: int = EPISODE_LEN
    num_prep_steps: int = NUM_PREP_STEPS
    dt: float = DT
    num_physics_substeps: int = NUM_PHYSICS_SUBSTEPS

    # Contact restitution coefficient (0 = perfectly inelastic).
    restitution: float = 0.0

    # Render every agent's view after each step and at init (K5's frames
    # mode) into the observations, under FRAME_KEY: [W, A, 4, 64, 64].
    render_frames: bool = False

    def __post_init__(self):
        max_agents = self.max_hiders + self.max_seekers
        if not (0 < max_agents <= MAX_AGENTS):
            raise ValueError(
                f"max_hiders + max_seekers must be in (0, {MAX_AGENTS}]; "
                f"got {max_agents}")
        if self.min_hiders > self.max_hiders:
            raise ValueError("min_hiders > max_hiders")
        if self.min_seekers > self.max_seekers:
            raise ValueError("min_seekers > max_seekers")
        if self.reset_budget >= 128 and self.reset_budget % 128 != 0:
            raise ValueError(
                f"reset_budget must be a multiple of 128 when >= 128; "
                f"got {self.reset_budget}")
        if not (0 <= self.max_boxes <= MAX_BOXES and
                0 <= self.max_ramps <= MAX_RAMPS):
            raise ValueError(
                f"max_boxes <= {MAX_BOXES} and max_ramps <= {MAX_RAMPS} "
                f"(the kernels' compile-time capacity)")
        if self.max_walls != MAX_WALLS:
            raise ValueError(f"max_walls must be {MAX_WALLS}")

    @property
    def max_agents(self) -> int:
        return self.max_hiders + self.max_seekers

    @property
    def num_dyn_bodies(self) -> int:
        """Dynamic rigid bodies per world: boxes + ramps + agents."""
        return self.max_boxes + self.max_ramps + self.max_agents

    @property
    def use_fixed_world(self) -> bool:
        return bool(self.sim_flags & SimFlags.UseFixedWorld)

    @property
    def ignore_episode_length(self) -> bool:
        return bool(self.sim_flags & SimFlags.IgnoreEpisodeLength)

    @property
    def random_flip_teams(self) -> bool:
        return bool(self.sim_flags & SimFlags.RandomFlipTeams)

    @property
    def zero_agent_velocity(self) -> bool:
        return bool(self.sim_flags & SimFlags.ZeroAgentVelocity)

    def replace(self, **kwargs) -> "EnvConfig":
        return dataclasses.replace(self, **kwargs)

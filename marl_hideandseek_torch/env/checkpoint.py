"""Sim-state checkpoints: save / load / pack per world.

Port of ``marl_hideandseek_tpu/env/checkpoint.py`` (reference: the
Checkpoint singleton src/sim.hpp:283-313, save/load task graphs
src/sim.cpp:956-1137). A checkpoint holds a world's dynamic state and its
level and episode keys; loading regenerates the level from the keys with
a *levelgen* (``env/episode.py``: by default the port's level
generator, which draws JAX's level from the keys, so a JAX checkpoint
loads as it is) and then overwrites the dynamic state.
``pack_checkpoints`` / ``unpack_checkpoints`` give the flat ``[W, nbytes]`` u8 records of the JAX package, byte for
byte (field order, little-endian values, bools as one byte);
``record_frame`` is that record of packed state, a frame of the record
log (``utils/ckptlog.py``).

Checkpoints are world-major (world axis first), like the classic env's
state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.types import (
    EnvState,
    GrabState,
    _Tree,
    on_bits,
    unpack_state,
)


def _checkpoint(state: EnvState, leaf) -> "Checkpoint":
    """The Checkpoint of ``state``'s leaves, each passed through ``leaf``."""
    b, g = state.bodies, state.grab
    ckpt = Checkpoint(
        ep_key=state.ep_key, level_key=state.level_key, step=state.step,
        running_scores=state.running_scores,
        finished_scores=state.finished_scores,
        seekers_first=state.seekers_first, num_hiders=state.num_hiders,
        num_seekers=state.num_seekers, pos=b.pos, quat=b.quat, vel=b.vel,
        omega=b.omega, locked=b.locked, owner=b.owner,
        grab_target=g.target, grab_r2=g.r2, grab_rel_q=g.rel_q,
        grab_sep=g.sep)
    return ckpt.map(on_bits(leaf))


@dataclasses.dataclass
class Checkpoint(_Tree):
    """Per-world dynamic snapshot, world axis first."""

    ep_key: torch.Tensor           # [W, 2] u32
    level_key: torch.Tensor        # [W, 2] u32
    step: torch.Tensor             # [W] i32
    running_scores: torch.Tensor   # [W, 2] i32
    finished_scores: torch.Tensor  # [W, 2] f32
    seekers_first: torch.Tensor    # [W] bool
    num_hiders: torch.Tensor       # [W] i32
    num_seekers: torch.Tensor      # [W] i32

    pos: torch.Tensor              # [W, B, 3]
    quat: torch.Tensor             # [W, B, 4]
    vel: torch.Tensor              # [W, B, 3]
    omega: torch.Tensor            # [W, B, 3]
    locked: torch.Tensor           # [W, B] bool
    owner: torch.Tensor            # [W, B] i32

    grab_target: torch.Tensor      # [W, A] i32
    grab_r2: torch.Tensor          # [W, A, 3]
    grab_rel_q: torch.Tensor       # [W, A, 4]
    grab_sep: torch.Tensor         # [W, A]


def checkpoint_layout(cfg: EnvConfig):
    """(field, per-world shape, dtype) of every Checkpoint leaf, in order."""
    nb, na = cfg.num_dyn_bodies, cfg.max_agents
    f32, i32, u32 = torch.float32, torch.int32, torch.uint32
    return [
        ("ep_key", (2,), u32), ("level_key", (2,), u32), ("step", (), i32),
        ("running_scores", (2,), i32), ("finished_scores", (2,), f32),
        ("seekers_first", (), torch.bool), ("num_hiders", (), i32),
        ("num_seekers", (), i32), ("pos", (nb, 3), f32),
        ("quat", (nb, 4), f32), ("vel", (nb, 3), f32),
        ("omega", (nb, 3), f32), ("locked", (nb,), torch.bool),
        ("owner", (nb,), i32), ("grab_target", (na,), i32),
        ("grab_r2", (na, 3), f32), ("grab_rel_q", (na, 4), f32),
        ("grab_sep", (na,), f32),
    ]


def save_checkpoints(cfg: EnvConfig, state: EnvState) -> Checkpoint:
    """Snapshot every world of world-major ``state`` (copies)."""
    return _checkpoint(state, lambda x: x.clone())


def load_checkpoints(cfg: EnvConfig, state: EnvState, ckpt: Checkpoint,
                     should_load: torch.Tensor, levelgen) -> EnvState:
    """Restore the worlds of world-major ``state`` where ``should_load !=
    0``: the level regenerated from the saved keys by ``levelgen`` (level
    1, the saved team sizes and flip), then the saved dynamic state. The
    episode counter keeps running, as in the reference (loadCheckpoint-
    System src/sim.cpp:956-1044)."""
    w = ckpt.step.shape[0]
    level_ids = torch.ones(w, dtype=torch.long, device=ckpt.step.device)
    keys = lambda k: k.view(torch.int32).T.contiguous().view(torch.uint32)
    new = unpack_state(levelgen(keys(ckpt.level_key), keys(ckpt.ep_key),
                                level_ids, ckpt.num_hiders,
                                ckpt.num_seekers, ckpt.seekers_first))
    loaded = new.replace(
        bodies=new.bodies.replace(pos=ckpt.pos, quat=ckpt.quat,
                                  vel=ckpt.vel, omega=ckpt.omega,
                                  locked=ckpt.locked, owner=ckpt.owner),
        grab=GrabState(target=ckpt.grab_target, r2=ckpt.grab_r2,
                       rel_q=ckpt.grab_rel_q, sep=ckpt.grab_sep),
        step=ckpt.step, running_scores=ckpt.running_scores,
        finished_scores=ckpt.finished_scores,
        episode_counter=state.episode_counter)
    mask = should_load != 0

    def pick(new_x, old_x):
        m = mask.reshape((-1,) + (1,) * (new_x.dim() - 1))
        return torch.where(m, new_x, old_x)

    return loaded.map2(state, on_bits(pick))


def pack_checkpoints(ckpt: Checkpoint) -> torch.Tensor:
    """[W, nbytes] u8 record of a checkpoint: each leaf's per-world
    values as bytes, in field order (bools as one byte)."""
    parts = []
    for leaf in ckpt.leaves():
        flat = leaf.reshape(leaf.shape[0], -1)
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        elif flat.dtype == torch.uint32:
            flat = flat.view(torch.int32)
        parts.append(flat.contiguous().view(torch.uint8))
    return torch.cat(parts, dim=-1)


def record_frame(cfg: EnvConfig, ps: EnvState) -> torch.Tensor:
    """``pack_checkpoints(save_checkpoints(cfg, unpack_state(ps)))`` of
    packed state ``ps``: the ``[W, nbytes]`` u8 record of every world,
    moving only the checkpoint's leaves to world-major (one copy each)."""
    return pack_checkpoints(_checkpoint(
        ps, lambda x: torch.movedim(x, -1, 0).contiguous()))


def unpack_checkpoints(cfg: EnvConfig, packed: torch.Tensor) -> Checkpoint:
    """Inverse of ``pack_checkpoints``."""
    w = packed.shape[0]
    layout = [(name, shape, dtype,
               {torch.bool: torch.uint8,
                torch.uint32: torch.int32}.get(dtype, dtype))
              for name, shape, dtype in checkpoint_layout(cfg)]
    want = sum(math.prod(shape) * store.itemsize
               for _, shape, _, store in layout)
    if packed.shape[1] != want:
        raise ValueError(f"checkpoint record of {packed.shape[1]} bytes, "
                         f"expected {want} for {cfg.max_hiders} hiders, "
                         f"{cfg.max_seekers} seekers, {cfg.max_boxes} boxes "
                         f"and {cfg.max_ramps} ramps")
    out = {}
    off = 0
    for name, shape, dtype, store in layout:
        nbytes = math.prod(shape) * store.itemsize
        chunk = packed[:, off:off + nbytes].contiguous().view(store)
        off += nbytes
        vals = chunk.reshape((w,) + shape)
        if dtype == torch.bool:
            vals = vals != 0
        elif dtype == torch.uint32:
            vals = vals.view(torch.uint32)
        out[name] = vals
    return Checkpoint(**out)

"""numpy <-> torch bridge for states, checkpoints and RGBD tensors.

A state crosses between the JAX package and the port as a nested mapping
of numpy arrays keyed by the dataclass field names (``{"bodies": {"pos":
...}, ..., "step": ...}``): the JAX side produces one with ``np.asarray``
on its leaves, and this module builds the port's ``EnvState`` from it, or
turns an ``EnvState`` back into one. The layout (world axis first for the
classic env, last for the packed one) is whatever the arrays carry;
dtypes are kept, including the u32 key leaves. A ``Checkpoint`` crosses
as a flat mapping of its fields, the RGBD tensors as a pair of arrays. No
JAX object is accepted here.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from marl_hideandseek_torch.env.checkpoint import Checkpoint
from marl_hideandseek_torch.types import (
    EnvState,
    GrabState,
    RigidBodies,
    StaticGeom,
)

_SUBTREES = {"bodies": RigidBodies, "statics": StaticGeom, "grab": GrabState}


def _to_tensor(x, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a.copy()).to(device)


def state_from_numpy(tree: Mapping, device="cpu") -> EnvState:
    """Nested mapping of numpy arrays -> ``EnvState`` on ``device``."""
    kwargs = {}
    for f in dataclasses.fields(EnvState):
        v = tree[f.name]
        if f.name in _SUBTREES:
            cls = _SUBTREES[f.name]
            kwargs[f.name] = cls(**{
                g.name: _to_tensor(v[g.name], device)
                for g in dataclasses.fields(cls)})
        else:
            kwargs[f.name] = _to_tensor(v, device)
    return EnvState(**kwargs)


def state_to_numpy(state: EnvState) -> dict:
    """``EnvState`` -> nested dict of numpy arrays (host copies)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, (RigidBodies, StaticGeom, GrabState)):
            out[f.name] = {g.name: getattr(v, g.name).cpu().numpy()
                           for g in dataclasses.fields(v)}
        else:
            out[f.name] = v.cpu().numpy()
    return out


def checkpoint_from_numpy(tree: Mapping, device="cpu") -> Checkpoint:
    """Mapping of numpy arrays keyed by the Checkpoint fields ->
    ``Checkpoint`` on ``device``."""
    return Checkpoint(**{f.name: _to_tensor(tree[f.name], device)
                         for f in dataclasses.fields(Checkpoint)})


def checkpoint_to_numpy(ckpt: Checkpoint) -> dict:
    """``Checkpoint`` -> dict of numpy arrays (host copies)."""
    return {f.name: getattr(ckpt, f.name).cpu().numpy()
            for f in dataclasses.fields(ckpt)}


def rgbd_from_numpy(rgb, depth, device="cpu"):
    """(rgb ``[W, A, H, W, 4]`` u8, depth ``[W, A, H, W, 1]`` f32) numpy
    arrays -> tensors on ``device``."""
    rgb, depth = np.asarray(rgb), np.asarray(depth)
    if rgb.dtype != np.uint8 or rgb.ndim != 5 or rgb.shape[-1] != 4:
        raise ValueError(f"rgb: {rgb.dtype} {rgb.shape}, expected u8 "
                         f"[W, A, H, W, 4]")
    if depth.dtype != np.float32 or depth.shape != rgb.shape[:4] + (1,):
        raise ValueError(f"depth: {depth.dtype} {depth.shape}, expected f32 "
                         f"{rgb.shape[:4] + (1,)}")
    return _to_tensor(rgb, device), _to_tensor(depth, device)


def rgbd_to_numpy(rgb: torch.Tensor, depth: torch.Tensor):
    """RGBD tensors -> (rgb, depth) numpy arrays (host copies)."""
    return rgb.cpu().numpy(), depth.cpu().numpy()

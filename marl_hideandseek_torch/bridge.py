"""numpy <-> torch state bridge.

A state crosses between the JAX package and the port as a nested mapping
of numpy arrays keyed by the dataclass field names (``{"bodies": {"pos":
...}, ..., "step": ...}``): the JAX side produces one with ``np.asarray``
on its leaves, and this module builds the port's ``EnvState`` from it, or
turns an ``EnvState`` back into one. The layout (world axis first or last)
is whatever the arrays carry; dtypes are kept, including the u32 key
leaves. No JAX object is accepted here.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

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

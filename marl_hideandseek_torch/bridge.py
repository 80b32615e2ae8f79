"""numpy <-> torch bridge for states, checkpoints and RGBD tensors.

A state crosses between the JAX package and the port as a nested mapping
of numpy arrays keyed by the dataclass field names (``{"bodies": {"pos":
...}, ..., "step": ...}``): the JAX side produces one with ``np.asarray``
on its leaves, and this module builds the port's ``EnvState`` from it, or
turns an ``EnvState`` back into one. The layout (world axis first for the
classic env, last for the packed one) is whatever the arrays carry;
dtypes are kept, including the u32 key leaves. A ``Checkpoint`` crosses
as a flat mapping of its fields, the RGBD tensors as a pair of arrays.

Policy weights cross as the flax parameter tree, nested dicts of numpy
arrays (``policy_params_from_numpy``), and the normalizer statistics as
``{"mean": {...}, "var": {...}, "count": ...}``
(``normalizer_state_from_numpy``). The port's policy checkpoint is a
``torch.save`` file of a dict - ``params`` and ``past_params`` (flat
parameter dicts with the leading policy axis), ``obs_stats`` and ``elo``
(``save_policy_checkpoint`` / ``load_policy_checkpoint``). The port's
training checkpoint is a ``torch.save`` file of the whole training state
as a nested dict (``save_training_checkpoint`` /
``load_training_checkpoint``); ``training_state_from_numpy`` builds one
from a JAX training state. Reading an orbax checkpoint stays on the JAX
side (README.md). No JAX object is accepted here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.env.checkpoint import Checkpoint
from marl_hideandseek_torch.models import Policy
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.models.normalizer import NormalizerState
from marl_hideandseek_torch.types import (
    EnvState,
    GrabState,
    RigidBodies,
    StaticGeom,
)

_SUBTREES = {"bodies": RigidBodies, "statics": StaticGeom, "grab": GrabState}


def _to_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a.copy()).to(device)


def state_from_numpy(tree: Mapping, device="cpu") -> EnvState:
    """Nested mapping of numpy arrays (or tensors) -> ``EnvState`` on
    ``device``."""
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


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested mapping -> ``{"a.b.c": leaf}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def check_policy_params(params: Mapping[str, torch.Tensor],
                        policy: Policy) -> int:
    """Raise unless ``params`` (flat, leading policy axis) names exactly
    the policy's parameters with their per-policy shapes and one policy
    count; return that count."""
    expected = {k: tuple(v.shape[1:]) for k, v in
                policy.actor_critic.named_parameters()}
    missing = sorted(set(expected) - set(params))
    extra = sorted(set(params) - set(expected))
    if missing or extra:
        raise ValueError(f"policy parameters: missing {missing}, "
                         f"extra {extra}")
    counts = set()
    for k, v in params.items():
        if tuple(v.shape[1:]) != expected[k]:
            raise ValueError(f"policy parameter {k}: shape {tuple(v.shape)},"
                             f" expected [P, {expected[k]}]")
        counts.add(v.shape[0])
    if len(counts) != 1:
        raise ValueError(f"policy parameters disagree on the policy count: "
                         f"{sorted(counts)}")
    return counts.pop()


def policy_params_from_numpy(tree: Mapping, policy: Policy,
                             device="cpu") -> Dict[str, torch.Tensor]:
    """The flax parameter tree (``{"params": {...}}`` or the bare tree;
    nested dicts of numpy arrays, every leaf with or without a leading
    policy axis P) -> the port's flat parameter dict ``{"backbone.
    actor_encoder.net.MLP_0.Dense_0.kernel": [P, ...], ...}`` on
    ``device``, loaded into ``policy.actor_critic`` as well. Raises on a
    missing, extra or mis-shaped leaf. Dense kernels keep flax's ``[in,
    out]`` layout."""
    params = _flat_policy_tree(tree, policy, device)
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(policy.actor_critic.get_submodule(owner), leaf,
                torch.nn.Parameter(t, requires_grad=False))
    return params


def _flat_policy_tree(tree: Mapping, policy: Policy,
                      device) -> Dict[str, torch.Tensor]:
    """``policy_params_from_numpy`` without loading the module: any tree
    laid out as the parameters (the parameters, or Adam's moments)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = {k: np.asarray(v) for k, v in flatten_tree(tree).items()}
    module = dict(policy.actor_critic.named_parameters())
    has_p = [v.ndim == module[k].ndim for k, v in flat.items()
             if k in module]
    stacked = all(has_p)
    if not stacked and any(has_p):
        raise ValueError("flax tree: some leaves have the policy axis and "
                         "some do not")
    params = {}
    for k, v in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(v).copy())
        params[k] = t if stacked else t.unsqueeze(0)
    check_policy_params(params, policy)
    return {k: v.to(device=device, dtype=module[k].dtype)
            for k, v in params.items()}


def normalizer_state_from_numpy(tree: Mapping,
                                device="cpu") -> NormalizerState:
    """``{"mean": {key: [F]}, "var": {key: [F]}, "count": scalar}`` of
    numpy arrays -> ``NormalizerState`` on ``device``."""
    if set(tree) != {"mean", "var", "count"}:
        raise ValueError(f"normalizer state keys {sorted(tree)}, expected "
                         f"count, mean, var")
    if set(tree["mean"]) != set(tree["var"]):
        raise ValueError("normalizer state: mean and var keys differ")
    return NormalizerState(
        mean={k: _to_tensor(v, device) for k, v in tree["mean"].items()},
        var={k: _to_tensor(v, device) for k, v in tree["var"].items()},
        count=_to_tensor(tree["count"], device))


def save_policy_checkpoint(path, params: Mapping[str, torch.Tensor],
                           obs_stats: NormalizerState, elo,
                           past_params: Optional[Mapping] = None) -> None:
    """Write the port's policy checkpoint: ``params`` and ``past_params``
    (flat dicts, leading policy axis; ``past_params`` may be empty), the
    normalizer statistics and one ELO per train policy, then per past
    policy."""
    def cpu(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    torch.save({
        "params": cpu(params),
        "past_params": cpu(past_params or {}),
        "obs_stats": {"mean": cpu(obs_stats.mean), "var": cpu(obs_stats.var),
                      "count": obs_stats.count.detach().cpu()},
        "elo": torch.tensor(np.asarray(elo, dtype=np.float32)),
    }, path)


def load_policy_checkpoint(path, device="cpu") -> dict:
    """Read a file of ``save_policy_checkpoint`` onto ``device``: a dict
    with ``params``, ``past_params``, ``obs_stats`` (a
    ``NormalizerState``) and ``elo``."""
    raw = torch.load(path, map_location=device, weights_only=True)
    st = raw["obs_stats"]
    return {"params": raw["params"], "past_params": raw["past_params"],
            "obs_stats": NormalizerState(mean=st["mean"], var=st["var"],
                                         count=st["count"]),
            "elo": raw["elo"]}


def state_to_tree(state: EnvState) -> dict:
    """``EnvState`` -> nested dict of its tensors (the layout
    ``state_from_numpy`` reads), without copies."""
    return {f.name: (state_to_tree(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else getattr(state, f.name))
            for f in dataclasses.fields(state)}


def save_training_checkpoint(path, tree: Mapping) -> None:
    """Write the port's training checkpoint: a nested dict of tensors and
    ints (``TrainingManager.state_tree``, or ``training_state_from_numpy``
    of a JAX one) as one ``torch.save`` file of host copies."""
    torch.save(tree_map(lambda x: x.detach().cpu()
                        if isinstance(x, torch.Tensor) else x, dict(tree)),
               path)


def load_training_checkpoint(path, device="cpu") -> dict:
    """Read a file of ``save_training_checkpoint`` onto ``device``."""
    return torch.load(path, map_location=device, weights_only=True)


def training_state_from_numpy(tree: Mapping, policy: Policy,
                              device="cpu") -> dict:
    """A JAX ``TrainingState`` tree read without a target from orbax (nested
    dicts and lists of numpy arrays) -> the training checkpoint's tree on
    ``device``: the parameters and past parameters, optax's Adam state
    (``opt_states[1]``: ``count`` ``[P]``, ``mu`` and ``nu`` under
    ``params/...`` with flax names), the normalizer statistics, the
    return statistics, the hyperparameters, ELOs, update count, metric
    ring and the state's key, and the rollout - the packed env state,
    the prepped observations (float32: a bf16 run's are widened), the
    LSTM state, the matchups and the rollout's key - every value
    unchanged. The port's keys are JAX's (``prng.py``), so the run
    resumes with JAX's worlds and draws."""
    def tensors(d):
        return {k: _to_tensor(v, device) for k, v in d.items()}

    def obs_tensor(v):
        a = np.asarray(v)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return _to_tensor(a, device)

    def tuples(x):
        if isinstance(x, (list, tuple)):
            return tuple(tuples(v) for v in x)
        return _to_tensor(x, device)

    adam = tree["opt_states"][1]
    ro = tree["rollout"]
    past = tree.get("past_params") or {}
    stats = tree["obs_stats"]
    return {
        "params": _flat_policy_tree(tree["params"], policy, device),
        "past_params": (_flat_policy_tree(past, policy, device)
                        if flatten_tree(past) else {}),
        "opt_states": {"mu": _flat_policy_tree(adam["mu"], policy, device),
                       "nu": _flat_policy_tree(adam["nu"], policy, device),
                       "count": _to_tensor(adam["count"], device)},
        "obs_stats": {"mean": tensors(stats["mean"]),
                      "var": tensors(stats["var"]),
                      "count": _to_tensor(stats["count"], device)},
        "value_stats": tensors(tree["value_stats"]),
        "hyper_params": tensors(tree["hyper_params"]),
        "elo": _to_tensor(tree["elo"], device),
        "update_idx": int(np.asarray(tree["update_idx"])),
        "metrics": tensors(tree["metrics"]),
        "key": prng.as_key(tree["key"], device),
        "rollout": {
            "env_state": state_to_tree(state_from_numpy(ro["env_state"],
                                                        device)),
            "obs": {k: obs_tensor(v) for k, v in ro["obs"].items()},
            "rnn_states": tuples(ro["rnn_states"]),
            "assignments": _to_tensor(ro["assignments"], device),
            "key": prng.as_key(ro["key"], device)},
    }

# Frozen copy of marl_hideandseek_torch/parallel/mesh.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Data parallelism over ranks: the 'data' axis, the world-axis rule of
packed state, the sharded packed step, and the rollout's shards.

Port of ``marl_hideandseek_tpu/parallel/mesh.py``. JAX shards the worlds
over a ``('data', 'model')`` mesh of devices and runs one global program,
into which XLA inserts the collectives (``training_state_shardings``,
``shard_training_manager``, ``make_sharded_update``). Here one process
per card (``torchrun``) holds a contiguous slice of the worlds: rank r of
R holds global worlds ``r * W / R`` to ``(r + 1) * W / R``, and the agents
of those worlds, and a ``TrainingManager`` with a ``Mesh`` is the sharded
manager. Parameters, optimizer state, normalizer and return statistics,
ELO, hyperparameters and keys are replicated. Every reduction over worlds
or agents in training is a local sum, one all-reduce, and a division by
the global count (``train/rollout.py``, ``train/ppo.py``,
``models/normalizer.py``, ``train/elo.py``); every draw over worlds or
agents is the rank's slice of the global draw. So R ranks with W / R
worlds each compute what one process computes with W worlds, up to the
order of the sums. JAX reserves the 'model' axis unused (mesh.py:7-9), so
``make_mesh`` takes ``model_parallel=1`` only.

Under gloo, collectives on card tensors go through host memory: the mesh
copies the operand to the host, runs the collective there and copies the
result back (gloo implements few collectives on CUDA tensors). NCCL runs
them on the card. Nothing switches backends on failure.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from portbench.reference.frozen.types import EnvState, on_bits


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 'data' axis: this rank, the number of ranks and their group.
    ``group`` None is one process, where every collective is the identity
    and costs nothing."""

    rank: int = 0
    size: int = 1
    group: Any = None
    backend: Optional[str] = None

    # -- the rank's slice ----------------------------------------------------

    def world_range(self, num_worlds: int) -> Tuple[int, int]:
        """This rank's global worlds ``[lo, hi)`` of ``num_worlds``."""
        if num_worlds % self.size != 0:
            raise ValueError(f"{num_worlds} worlds do not divide over "
                             f"{self.size} ranks")
        w = num_worlds // self.size
        return self.rank * w, (self.rank + 1) * w

    def world_ids(self, local_worlds: int, device) -> torch.Tensor:
        """The global ids of this rank's ``local_worlds`` worlds."""
        lo = self.rank * local_worlds
        return torch.arange(lo, lo + local_worlds, device=device)

    # -- collectives -----------------------------------------------------------

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` on the host for gloo with a card tensor, else as is."""
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    def _flat(self, xs: Sequence[torch.Tensor],
              op: Callable[[torch.Tensor], None]) -> List[torch.Tensor]:
        """``op`` (in place) over the tensors joined into one new buffer
        per dtype: one collective per dtype, whatever their number."""
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, x in enumerate(xs):
            by_dtype.setdefault(x.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = self._staged(torch.cat([_wire(xs[i]).reshape(-1)
                                           for i in idx]))
            op(flat)
            flat = flat.to(xs[idx[0]].device)
            for i, part in zip(idx, flat.split([xs[i].numel()
                                                for i in idx])):
                out[i] = _unwire(part.reshape(xs[i].shape), xs[i].dtype)
        return out

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (a new tensor; ``x`` itself in one
        process)."""
        return self.all_sum_many([x])[0]

    def all_sum_many(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor summed over the ranks, in one all-reduce per
        dtype."""
        if self.group is None:
            return list(xs)
        return self._flat(xs, lambda t: dist.all_reduce(t, group=self.group))

    def broadcast_many(self, xs: Sequence[torch.Tensor],
                       src: int = 0) -> List[torch.Tensor]:
        """Rank ``src``'s values of the tensors on every rank."""
        if self.group is None:
            return list(xs)
        return self._flat(xs, lambda t: dist.broadcast(t, src,
                                                       group=self.group))

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim`` in rank order (equal
        shapes on every rank); ``x`` itself in one process."""
        if self.group is None:
            return x
        y = self._staged(_wire(x).contiguous())
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        return _unwire(torch.cat(parts, dim).to(x.device), x.dtype)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a collective moves it: u32 as its i32 bits, bool as u8
    (neither backend has those types)."""
    x = x.detach()
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _unwire(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return y.view(torch.uint32)
    if dtype == torch.bool:
        return y != 0
    return y


LOCAL = Mesh()


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """The 'data' axis over every rank of the default process group
    (``utils/runtime.init_distributed``), or ``LOCAL`` when there is none.
    ``n_devices``, if given, must be the group's size: a rank drives one
    card, and the mesh spans them all."""
    if model_parallel != 1:
        raise ValueError("model_parallel must be 1: the 'model' axis is "
                         "reserved and unused, as in the JAX package")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh(n_devices={n_devices}) without a "
                             f"process group")
        return LOCAL
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh(n_devices={n_devices}) over a group of "
                         f"{size} ranks")
    return Mesh(rank=dist.get_rank(), size=size, group=dist.group.WORLD,
                backend=dist.get_backend())


# -- packed env state ----------------------------------------------------------

def packed_env_specs(ps: EnvState) -> EnvState:
    """The rule of packed state (mesh.py:82-87): every leaf's worlds axis
    is its LAST and shards over 'data'; a scalar leaf replicates. Each
    leaf becomes JAX's PartitionSpec as a tuple: ``(None, ..., 'data')``
    or ``()``."""
    return ps.map(lambda x: (None,) * (x.dim() - 1) + ("data",)
                  if x.dim() else ())


def _data_axis(spec: tuple):
    return spec.index("data") if "data" in spec else None


def shard_packed_state(ps: EnvState, mesh: Mesh) -> EnvState:
    """This rank's worlds of a packed state of all the worlds, each leaf
    cut on its 'data' axis (``packed_env_specs``)."""
    lo, hi = mesh.world_range(ps.step.shape[-1])

    def cut(x, spec):
        axis = _data_axis(spec)
        return x if axis is None else _slice(x, axis, lo, hi)

    return ps.map2(packed_env_specs(ps), cut)


def gather_packed_state(ps: EnvState, mesh: Mesh) -> EnvState:
    """Every rank's worlds of a sharded packed state, in global order."""
    def join(x, spec):
        axis = _data_axis(spec)
        return x if axis is None else mesh.all_gather(x, axis)

    return ps.map2(packed_env_specs(ps), join)


def sharded_packed_init(env, mesh: Mesh, key: Optional[torch.Tensor] = None):
    """``env.init(key)`` for this rank's worlds only: the slice of the
    global init (a world's draws depend on its global id alone)."""
    lo, hi = mesh.world_range(env.cfg.num_worlds)
    return env.init(key, world_ids=torch.arange(lo, hi, device=env.device))


def make_sharded_packed_step(env, mesh: Mesh):
    """``env.step`` over this rank's slab of worlds (mesh.py:96-146): the
    global world ids go to the level generator, so each world draws the
    episodes it draws in one process; no collective runs. As in JAX, the
    compact-reset budget applies per shard. ``env`` is configured for all
    the worlds; the step takes the local slab ``ps`` and actions ``[A, 5,
    W / R]``."""
    def step(ps: EnvState, actions: torch.Tensor,
             resets: Optional[torch.Tensor] = None,
             base_key: Optional[torch.Tensor] = None):
        ids = mesh.world_ids(ps.step.shape[0], ps.step.device)
        return env.step(ps, actions, resets, base_key, world_ids=ids)

    return step


# -- the training state --------------------------------------------------------

def _slice(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    return on_bits(lambda t: t.narrow(dim, lo, hi - lo).contiguous())(x)


def shard_rollout(ro, mesh: Mesh):
    """This rank's slice of a ``RolloutState`` of all the worlds (the rule
    of mesh.py:39-61): the packed env state on its last axis, the
    observations and matchups on their agent axis 0, the LSTM states
    ``[L, N, H]`` on axis 1; the key replicates."""
    from portbench.reference.frozen.models.actor_critic import tree_map

    w = ro.env_state.step.shape[-1]
    a = ro.assignments.shape[0] // w
    lo, hi = mesh.world_range(w)
    return ro.replace(
        env_state=shard_packed_state(ro.env_state, mesh),
        obs={k: _slice(v, 0, lo * a, hi * a) for k, v in ro.obs.items()},
        rnn_states=tree_map(lambda x: _slice(x, 1, lo * a, hi * a),
                            ro.rnn_states),
        assignments=_slice(ro.assignments, 0, lo * a, hi * a))


def gather_rollout(ro, mesh: Mesh):
    """Inverse of ``shard_rollout``: every rank's slice joined."""
    from portbench.reference.frozen.models.actor_critic import tree_map

    if mesh.group is None:
        return ro
    return ro.replace(
        env_state=gather_packed_state(ro.env_state, mesh),
        obs={k: mesh.all_gather(v, 0) for k, v in ro.obs.items()},
        rnn_states=tree_map(lambda x: mesh.all_gather(x, 1), ro.rnn_states),
        assignments=mesh.all_gather(ro.assignments, 0))

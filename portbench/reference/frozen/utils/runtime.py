# Frozen copy of marl_hideandseek_torch/utils/runtime.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Runtime helpers: NaN guards for training, and for runs of several
processes the process-group bring-up, a barrier, the primary-rank test and
a metric mean across ranks.

Port of ``marl_hideandseek_tpu/utils/runtime.py:61-112``, on
``torch.distributed``: one process per card (``torchrun``), where JAX runs
one process per host. ``enable_compilation_cache`` configures XLA and has
no counterpart here.

NaN guards (``enable_nan_guards``, or ``MHS_NAN_GUARDS=1`` in the
environment, as JAX's ``aot_compile`` reads it): while they are on, each
``update_iter`` and ``eval_elo`` of the training manager checks its
incoming and its new state's floating leaves, and the rollout's rewards,
in one device reduction each (``check_finite``) and raises naming the
first non-finite leaf and the update; the PPO update's backward runs
under autograd's anomaly detection (``anomaly_mode``), which raises at
the first backward op that returns a NaN, with the forward op that made
it. Off (the default) they add no op and no sync. JAX's
``checkify.float_checks`` also flag each division by zero inside the
program; these guards see only the state, the rewards and the gradients.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Collection, Mapping, Optional

import torch
import torch.distributed as dist

_NAN_GUARDS: Optional[bool] = None


def enable_nan_guards(enable: bool = True) -> None:
    """Turn the training NaN guards on or off for this process (over
    ``MHS_NAN_GUARDS``). Costly: a sync per check and anomaly detection in
    the backward; for debugging."""
    global _NAN_GUARDS
    _NAN_GUARDS = bool(enable)


def nan_guards_on() -> bool:
    """Whether the NaN guards are on: ``enable_nan_guards``'s setting, else
    ``MHS_NAN_GUARDS`` set to anything but empty or 0."""
    if _NAN_GUARDS is not None:
        return _NAN_GUARDS
    return os.environ.get("MHS_NAN_GUARDS", "") not in ("", "0")


def anomaly_mode():
    """autograd's anomaly detection (NaN checks on every backward op's
    outputs) while the guards are on; else a context that does nothing."""
    if nan_guards_on():
        return torch.autograd.set_detect_anomaly(True, check_nan=True)
    return contextlib.nullcontext()


def check_finite(leaves: Mapping[str, torch.Tensor], where: str,
                 plus_inf: Collection[str] = ()) -> None:
    """Raise ``FloatingPointError`` naming the first leaf (in the order of
    ``leaves``) with a NaN or an infinity; the leaves named in
    ``plus_inf`` may hold +inf by design (a ray's miss) but no NaN and no
    -inf. One reduction per leaf and one copy to the host for all."""
    names, ok = [], []
    for name, x in leaves.items():
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            continue
        good = torch.isfinite(x)
        if name in plus_inf:
            good = good | (x == math.inf)
        names.append(name)
        ok.append(good.all())
    if not ok:
        return
    flags = torch.stack([f.to(ok[0].device) for f in ok]).cpu()
    if not bool(flags.all()):
        first = names[int((~flags).nonzero()[0, 0])]
        raise FloatingPointError(f"NaN guard: non-finite values in {first} "
                                 f"{where}")

# A rank that raises leaves the others waiting in a collective; they give
# up after this long instead of hanging.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> torch.device:
    """Start ``torch.distributed``'s default process group; returns this
    rank's device.

    With no address, the group comes from torchrun's variables
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). With
    ``coordinator_address`` (``"host:port"``, JAX's spelling) it is
    ``tcp://host:port`` with ``num_processes`` ranks, this one
    ``process_id``. The device is ``cuda:LOCAL_RANK`` (torchrun's
    variable, else the rank) unless ``device`` names another, ``"cpu"``
    included. The backend is ``nccl`` on the card and ``gloo`` on the CPU
    unless ``backend`` names one; gloo on the card moves every collective
    through host memory (``parallel/mesh.py``). A failed init raises."""
    if coordinator_address is None:
        init_method = "env://"
        world_size = rank = -1
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: an address needs "
                             "num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        world_size, rank = num_processes, process_id
        local = int(os.environ.get("LOCAL_RANK", process_id))
    dev = torch.device(device if device is not None else f"cuda:{local}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"init_distributed: device {dev} but "
                               f"torch.cuda.is_available() is False")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("init_distributed: nccl needs a CUDA device")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return dev


def sync_hosts(name: str = "sync") -> None:
    """Barrier across ranks (the control-plane sync before and after a
    checkpoint write); ``name`` labels the sync point, as in JAX. Nothing
    to wait for in one process."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def is_primary_host() -> bool:
    """True on the rank that performs IO (logs, checkpoints): rank 0, or
    the only process when no group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_metric_mean(value) -> float:
    """The mean of a rank-local scalar over all ranks; the identity in one
    process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return float(value)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return float(t) / dist.get_world_size()

"""EMA observation normalizer.

Port of ``marl_hideandseek_tpu/models/normalizer.py``: per-key prep
functions first, then per-feature EMA mean and variance statistics, with
a skip set that passes masks and flags through unnormalized. The
statistics are explicit state, updated during rollouts and frozen during
inference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Mapping

import torch

from marl_hideandseek_torch.parallel.mesh import LOCAL, Mesh


@dataclasses.dataclass
class NormalizerState:
    mean: Dict[str, torch.Tensor]
    var: Dict[str, torch.Tensor]
    count: torch.Tensor  # scalar update counter

    def to(self, device) -> "NormalizerState":
        return NormalizerState(
            mean={k: v.to(device) for k, v in self.mean.items()},
            var={k: v.to(device) for k, v in self.var.items()},
            count=self.count.to(device))


@dataclasses.dataclass(frozen=True)
class ObservationsEMANormalizer:
    """Per-key EMA mean/variance normalization of observation dicts.

    ``entity_rows`` maps a key of entity rows to its features per entity
    (``{"box_data": 17, ...}``): a row that is all zero before
    normalization (a slot the env left empty) stays all zero after it, so
    the policy can tell empty slots from entities. The statistics are
    taken over every row alike."""

    decay: float = 0.99999
    dtype: torch.dtype = torch.float32
    prep_fns: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    skip_normalization: FrozenSet[str] = frozenset()
    eps: float = 1e-5
    entity_rows: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(decay, dtype, prep_fns=None, skip_normalization=(),
               entity_rows=None):
        return ObservationsEMANormalizer(
            decay=decay, dtype=dtype, prep_fns=dict(prep_fns or {}),
            skip_normalization=frozenset(skip_normalization),
            entity_rows=dict(entity_rows or {}))

    def prep(self, obs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply per-key preprocessing casts, then the compute dtype."""
        return {k: self.prep_fns[k](v) if k in self.prep_fns
                else v.to(self.dtype) for k, v in obs.items()}

    def init_state(self, obs: Mapping[str, torch.Tensor]) -> NormalizerState:
        mean, var = {}, {}
        for k, v in obs.items():
            if k in self.skip_normalization:
                continue
            mean[k] = torch.zeros(v.shape[-1], device=v.device)
            var[k] = torch.ones(v.shape[-1], device=v.device)
        dev = next(iter(obs.values())).device
        return NormalizerState(mean=mean, var=var,
                               count=torch.zeros((), device=dev))

    def update_state(self, state: NormalizerState,
                     obs: Mapping[str, torch.Tensor],
                     mesh: Mesh = LOCAL) -> NormalizerState:
        """EMA update over all leading axes of each normalized key: the
        batch mean, then the mean square about it. Over ``mesh``, ``obs``
        is this rank's share of the batch and both are the whole batch's,
        each one all-reduce of every key's sums."""
        d = self.decay
        keys = list(state.mean)
        vs = [obs[k].to(torch.float32).flatten(0, -2) for k in keys]
        # Every rank holds the same number of rows.
        count = float(vs[0].shape[0] * mesh.size) if vs else 1.0
        means = [s / count for s in mesh.all_sum_many([v.sum(0) for v in vs])]
        sqs = [s / count for s in mesh.all_sum_many(
            [torch.square(v - m).sum(0) for v, m in zip(vs, means)])]
        new_mean, new_var = {}, {}
        for k, m, sq in zip(keys, means, sqs):
            new_mean[k] = d * state.mean[k] + (1.0 - d) * m
            new_var[k] = d * state.var[k] + (1.0 - d) * sq
        return NormalizerState(mean=new_mean, var=new_var,
                               count=state.count + 1.0)

    def normalize(self, state: NormalizerState,
                  obs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in obs.items():
            if k in state.mean:
                inv_std = torch.rsqrt(state.var[k] + self.eps)
                normed = ((v.to(torch.float32) - state.mean[k]) * inv_std
                          ).to(self.dtype)
                if k in self.entity_rows:
                    rows = v.shape[:-1] + (-1, self.entity_rows[k])
                    filled = (v.reshape(rows) != 0).any(-1, keepdim=True)
                    normed = torch.where(filled, normed.reshape(rows),
                                         0.0).reshape(v.shape)
                v = normed
            out[k] = v
        return out

    def prep_and_normalize(self, state, obs):
        return self.normalize(state, self.prep(obs))


@dataclasses.dataclass(frozen=True)
class ObservationsCaster:
    """Cast-only observation preprocessor with no statistics: a drop-in
    alternative to the EMA normalizer (normalizer.py:97-131)."""

    dtype: torch.dtype = torch.float32
    prep_fns: Mapping[str, Callable] = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(dtype, prep_fns=None):
        return ObservationsCaster(dtype=dtype, prep_fns=dict(prep_fns or {}))

    def prep(self, obs):
        return {k: self.prep_fns[k](v) if k in self.prep_fns
                else v.to(self.dtype) for k, v in obs.items()}

    def init_state(self, obs) -> NormalizerState:
        dev = next(iter(obs.values())).device
        return NormalizerState(mean={}, var={},
                               count=torch.zeros((), device=dev))

    def update_state(self, state, obs):
        return dataclasses.replace(state, count=state.count + 1.0)

    def normalize(self, state, obs):
        return obs

    def prep_and_normalize(self, state, obs):
        return self.prep(obs)

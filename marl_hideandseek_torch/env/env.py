"""The classic world-major environment: ``HideAndSeekEnv``.

Port of ``marl_hideandseek_tpu/env/env.py:343-605``. State is world-major
(every leaf's world axis FIRST), the layout of the JAX package's classic
env, its checkpoints and its tools. The env is a front over the packed
core, ``PackedEnv`` (``env/packed.py``):

1. at entry, ``init``, ``step`` and ``load_checkpoints`` pack the state
   and the actions once (``pack_state``, ``pack_actions``);
2. in between they run the packed core: its step composition, resets
   (trigger, full or compact branch, slot choice, merge), sweep and
   observation assembly;
3. at exit they unpack once (``unpack_state``; the observations in the
   classic ``[W, A, ...]`` shapes, ``reference_obs``; rewards and dones
   ``[W, A, 1]``).

The core differs from ``PackedEnv`` in two places only: its step before
resets runs the packed step systems around K3 (``ops/fused.py``) or, with
``fused=False``, the JAX env's unfused branch, K2 (``ops/physics.py``)
then the standalone sweep (K1); and its compact merge scatters
regenerated values unchanged, as the JAX classic env does
(env.py:470-474), where ``PackedEnv`` applies ``canon_float``.

CPU tensors take each kernel's plain version. Random draws follow JAX's
keys (``prng.py``): ``init(key)`` draws the first episodes from ``key``,
resets from ``base_key`` (default ``PRNGKey(cfg.rand_seed)``), as JAX's
``init`` and ``step`` do. World generation is injectable as in
``PackedEnv`` (``worldgen``), and so is the level generator that
``load_checkpoints`` regenerates a saved level with (``levelgen``, see
``env/episode.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.env import checkpoint as ckpt_mod
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env import packed as P
from marl_hideandseek_torch.env.episode import (
    LevelGen,
    WorldGen,
    default_levelgen,
    levelgen_worldgen,
)
from marl_hideandseek_torch.ops import fused as ops_fused
from marl_hideandseek_torch.ops import physics as ops_physics
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.ops import step as ops_step
from marl_hideandseek_torch.types import (
    EnvState,
    StepResult,
    pack_actions,
    pack_state,
    unpack_state,
)


def _unfused_phase(cfg: EnvConfig, ps: EnvState, ext_force, ext_torque):
    """K2, then the standalone sweep on the moved bodies."""
    bodies = ops_physics.physics_packed(cfg, ps.bodies, ps.statics, ps.grab,
                                        ext_force, ext_torque)
    return bodies, P.standalone_sweep_packed(cfg, ps.replace(bodies=bodies))


class _ClassicCore(P.PackedEnv):
    """``PackedEnv`` with the classic env's step before resets and its
    compact merge."""

    def __init__(self, cfg: EnvConfig, device, worldgen: WorldGen,
                 fused: bool):
        super().__init__(cfg, device, worldgen)
        self.phase = ops_fused.fused_step_packed if fused else _unfused_phase

    def _megastep(self, ps, actions):
        return ops_step.megastep_plain(self.cfg, ps, actions,
                                       phase=self.phase)

    @staticmethod
    def _merge_floats(x):
        return x


class HideAndSeekEnv:
    """Hide-and-seek over world-major state; PyTorch port of the JAX
    ``HideAndSeekEnv``.

    ``device`` defaults to ``"cuda"`` and must exist: asking for CUDA
    without a card raises rather than running on the CPU. ``worldgen``
    replaces the world generator and ``levelgen`` the level generator of
    checkpoint loads (``env/episode.py``); the defaults are JAX's: each
    episode's draws keyed by (base key, world id, episode counter) and
    each level drawn from its level key. ``fused=False`` takes the JAX env's
    unfused branch (K2, then the standalone sweep) instead of K3.
    """

    def __init__(self, cfg: EnvConfig, device="cuda",
                 worldgen: Optional[WorldGen] = None,
                 levelgen: Optional[LevelGen] = None, fused: bool = True):
        self.levelgen = levelgen or default_levelgen(cfg)
        self._core = _ClassicCore(
            cfg, device, worldgen or levelgen_worldgen(cfg, self.levelgen),
            fused)
        self.cfg, self.device, self.fused = cfg, self._core.device, fused
        # Reset branches taken by step(), for runs that must show them.
        self.reset_counts = self._core.reset_counts

    @property
    def worldgen(self) -> WorldGen:
        return self._core.worldgen

    @worldgen.setter
    def worldgen(self, fn: WorldGen):
        self._core.worldgen = fn

    def _front(self, ps: EnvState, res) -> Tuple[EnvState, StepResult]:
        """The packed core's state and result in the classic layout."""
        state = unpack_state(ps)
        return state, StepResult(
            obs=obs_mod.reference_obs(self.cfg, res.obs),
            rewards=res.rewards.T[..., None].contiguous(),
            dones=res.dones.T[..., None].contiguous(),
            episode_results=state.finished_scores)

    def init(self, key: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, StepResult]:
        """Fresh level-1 worlds drawn from ``key`` (default
        ``PRNGKey(cfg.rand_seed)``), swept, with zero rewards."""
        return self._front(*self._core.init(key))

    def step(self, state: EnvState, actions: torch.Tensor,
             resets: Optional[torch.Tensor] = None,
             base_key: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, StepResult]:
        """One step of every world. actions [W, A, 5] int (x, y, r, g, l
        buckets); resets [W] int level ids (0 = no external reset);
        base_key the key of the reset worlds' episode draws (default
        ``PRNGKey(cfg.rand_seed)``)."""
        return self._front(*self._core.step(
            pack_state(state), pack_actions(actions.to(torch.int32)), resets,
            base_key))

    def rgbd(self, state: EnvState, img_h: int = 64, img_w: int = 64,
             fov_deg: float = 90.0, max_depth: float = 200.0):
        """Per-agent RGBD (the reference's rgb / depth tensors,
        src/mgr.cpp:1329-1335): (rgb ``[W, A, H, W, 4]`` u8, depth ``[W,
        A, H, W, 1]`` f32). The K5 kernel on CUDA tensors, the plain
        renderer on CPU ones."""
        packed, depth = ops_rgbd.render_rgbd_packed_fast(
            self.cfg, pack_state(state), img_h, img_w, fov_deg, max_depth)
        return ops_rgbd.to_reference_layout(self.cfg, packed, depth, img_h,
                                            img_w)

    # -- debug / tooling ------------------------------------------------------

    def global_positions(self, state: EnvState) -> torch.Tensor:
        """[W, 17, 2] xy positions (reference: src/mgr.cpp:1229-1239)."""
        return obs_mod.global_debug_positions(self.cfg, state)

    def seeds(self, state: EnvState) -> torch.Tensor:
        """[W, A, 2] i32 per-agent episode seed: the episode key words,
        reinterpreted as i32 (reference: src/mgr.cpp:1198-1206)."""
        seed = state.ep_key.view(torch.int32)
        return seed[:, None, :].expand(seed.shape[0], self.cfg.max_agents,
                                       2).contiguous()

    # -- sim-state checkpoints ----------------------------------------------

    def save_checkpoints(self, state: EnvState) -> ckpt_mod.Checkpoint:
        """Per-world checkpoint of ``state`` (env/checkpoint.py)."""
        return ckpt_mod.save_checkpoints(self.cfg, state)

    def load_checkpoints(self, state: EnvState, ckpt: ckpt_mod.Checkpoint,
                         should_load: torch.Tensor
                         ) -> Tuple[EnvState, StepResult]:
        """Restore the worlds where ``should_load != 0`` (their levels
        regenerated by ``self.levelgen``), re-swept."""
        return self._front(*self._core._swept(pack_state(
            ckpt_mod.load_checkpoints(self.cfg, state, ckpt, should_load,
                                      self.levelgen))))

"""The classic world-major environment: ``HideAndSeekEnv``.

Port of ``marl_hideandseek_tpu/env/env.py:343-605``. State is world-major
(every leaf's world axis FIRST), the layout of the JAX package's classic
env, its checkpoints and its tools. A step is:

1. movement and grab/lock: the packed step systems (``env/packed.py``)
   on packed views of the same tensors, one copy of each system for both
   layouts;
2. physics and the post-physics sweep (``_physics_and_sweep``): the fused
   kernel K3 (``ops/fused.py``) on every step, or with ``fused=False`` the
   JAX env's unfused branch, the physics kernel K2 (``ops/physics.py``)
   then the standalone sweep;
3. agent zero-velocity, rewards, dones and episode scores (packed
   systems again);
4. resets - the full or the compact branch, as in ``PackedEnv`` - with
   the regenerated worlds re-swept by the raycast kernel K1
   (``_standalone_sweep``, ``ops/rays.py::raycast_batch``);
5. observations in the classic ``[W, A, ...]`` shapes.

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

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.env import checkpoint as ckpt_mod
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env import packed as P
from marl_hideandseek_torch.env.episode import (
    LevelGen,
    WorldGen,
    default_levelgen,
    fresh_world,
    levelgen_worldgen,
    regen_world,
)
from marl_hideandseek_torch.ops import fused as ops_fused
from marl_hideandseek_torch.ops import physics as ops_physics
from marl_hideandseek_torch.ops import rays as ops_rays
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.types import (
    EnvState,
    StepResult,
    SweepResults,
    on_bits,
    pack_actions,
    pack_state,
    unpack_state,
)
from marl_hideandseek_torch.utils import tracing


def _contiguous(state: EnvState) -> EnvState:
    return state.map(lambda x: x.contiguous())


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
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "HideAndSeekEnv(device='cuda') but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        self.cfg = cfg
        self.device = device
        self.fused = fused
        self.levelgen = levelgen or default_levelgen(cfg)
        self.worldgen = worldgen or levelgen_worldgen(cfg, self.levelgen)
        # Reset branches taken by step(), for runs that must show them.
        self.reset_counts = {"full": 0, "compact": 0}

    # -- construction -------------------------------------------------------

    def init(self, key: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, StepResult]:
        """Fresh level-1 worlds drawn from ``key`` (default
        ``PRNGKey(cfg.rand_seed)``), swept, with zero rewards."""
        w = self.cfg.num_worlds
        ids = torch.arange(w, device=self.device)
        ps = fresh_world(self.worldgen, self._key(key), ids,
                         torch.ones(w, dtype=torch.long, device=self.device))
        return self._finish(unpack_state(ps))

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

    # -- stepping -----------------------------------------------------------

    def _key(self, key: Optional[torch.Tensor]) -> torch.Tensor:
        if key is None:
            return prng.key(self.cfg.rand_seed, self.device)
        return prng.as_key(key, self.device)

    def step(self, state: EnvState, actions: torch.Tensor,
             resets: Optional[torch.Tensor] = None,
             base_key: Optional[torch.Tensor] = None
             ) -> Tuple[EnvState, StepResult]:
        """One step of every world. actions [W, A, 5] int (x, y, r, g, l
        buckets); resets [W] int level ids (0 = no external reset);
        base_key the key of the reset worlds' episode draws (default
        ``PRNGKey(cfg.rand_seed)``)."""
        cfg = self.cfg
        w = state.step.shape[0]
        if resets is None:
            resets = torch.zeros(w, dtype=torch.int32, device=state.step.device)
        acts = pack_actions(actions.to(torch.int32))

        # 1. Movement + grab/lock on the carried interaction-ray hits.
        ps = obs_mod.world_last(state)
        ext_force, ext_torque = P.movement_packed(cfg, ps, acts)
        ps = P.action_system_packed(cfg, ps, acts, ps.act_hit_t,
                                    ps.act_hit_id)
        # 2. Physics + the post-physics sweep.
        state, sweep = self._physics_and_sweep(
            obs_mod.world_first(ps), torch.movedim(ext_force, -1, 0),
            torch.movedim(ext_torque, -1, 0))
        # 3. Zero-velocity, rewards, dones, episode results.
        ps = obs_mod.world_last(state)
        if cfg.zero_agent_velocity:
            ps = P.zero_agent_velocities_packed(cfg, ps)
        team_r = torch.where(sweep.rew_seen, -1.0, 1.0)
        ps = ps.replace(hider_team_reward=team_r)
        rewards, dones = P.rewards_dones_packed(cfg, ps, team_r)
        state = obs_mod.world_first(P.episode_results_packed(cfg, ps, team_r))
        # 4. Resets.
        trigger = resets != 0
        if not cfg.ignore_episode_length:
            trigger = trigger | (state.step == cfg.episode_len - 1)
        state, sweep = self._apply_resets(state, sweep, trigger, resets,
                                          base_key)
        state = _contiguous(state.replace(act_hit_t=sweep.act_t,
                                          act_hit_id=sweep.act_id))
        return state, self._assemble(state, sweep,
                                     rewards.T[..., None].contiguous(),
                                     dones.T[..., None].contiguous())

    def _apply_resets(self, state: EnvState, sweep: SweepResults, trigger,
                      resets, base_key=None):
        """Advance the step counter and regenerate the triggered worlds:
        every world at once (full branch) or, when at most
        ``reset_budget`` trigger, only those (compact branch). Returns
        (state, sweep) describing the post-reset worlds."""
        cfg = self.cfg
        w = trigger.shape[0]
        adv = state.replace(step=state.step + 1)
        with tracing.span("host_read.reset_trigger"):
            n_trig = int(trigger.sum())
        if n_trig == 0:
            return adv, sweep
        level_ids = torch.where(resets != 0, resets, 1).long()
        world_ids = torch.arange(w, device=trigger.device)
        base_key = self._key(base_key)
        if 0 < cfg.reset_budget < w and n_trig <= cfg.reset_budget:
            self.reset_counts["compact"] += 1
            return self._compact_resets(state, adv, sweep, trigger, level_ids,
                                        world_ids, base_key)
        self.reset_counts["full"] += 1
        regen = self._regen(base_key, world_ids, state, level_ids)
        new = regen.map2(adv, on_bits(lambda n, o: torch.where(
            trigger.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)))
        return new, self._standalone_sweep(new)

    def _compact_resets(self, state, adv, sweep, trigger, level_ids,
                        world_ids, base_key):
        """Regenerate only the triggered worlds (at most reset_budget).

        The k = reset_budget slots hold the triggered worlds in ascending
        order, padded with the first one; only the first occurrence of a
        world writes back. Regenerated values are scattered unchanged, as
        the JAX classic env does (env.py:470-474); only ``PackedEnv``'s
        merge applies the finite-or-+inf contract."""
        k = self.cfg.reset_budget
        w = trigger.shape[0]
        dev = trigger.device
        w_idx = torch.arange(w, device=dev)
        score = torch.where(trigger, w - w_idx, 0)
        top_score, idx = torch.topk(score, k, sorted=True)
        idx = torch.where(top_score > 0, idx, idx[0])
        first = (torch.argmax((idx[:, None] == idx[None, :]).to(torch.int8),
                              dim=1) == torch.arange(k, device=dev))

        sub = state.map(on_bits(lambda x: x[idx]))
        regen = self._regen(base_key, world_ids[idx], sub, level_ids[idx])
        sub_sweep = self._standalone_sweep(regen)
        with tracing.span("host_read.compact_cols"):
            cols = idx[first]

        @on_bits
        def merge(old, new):
            out = old.clone()
            with tracing.span("host_read.compact_merge"):
                picked = new[first]
            out[cols] = picked.to(old.dtype)
            return out

        new_sweep = SweepResults(*(merge(o, n) for o, n in
                                   zip(sweep, sub_sweep)))
        return adv.map2(regen, merge), new_sweep

    def _regen(self, base_key, world_ids, state: EnvState,
               level_ids) -> EnvState:
        """Fresh episodes for the worlds of world-major ``state``."""
        return obs_mod.world_first(regen_world(
            self.worldgen, base_key, world_ids, obs_mod.world_last(state),
            level_ids))

    # -- sweep machinery ----------------------------------------------------

    def _physics_and_sweep(self, state: EnvState, ext_force, ext_torque):
        """Physics + the post-physics ray sweep: K3 (or, unfused, K2 and
        the standalone sweep). ext_force / ext_torque [W, B, 3]."""
        cfg = self.cfg
        if self.fused:
            bodies, sweep = ops_fused.fused_step(cfg, state, ext_force,
                                                 ext_torque)
            return state.replace(bodies=bodies), sweep
        bodies = ops_physics.physics_step_batch(
            cfg, state.bodies, state.statics, state.grab, ext_force,
            ext_torque)
        state = state.replace(bodies=bodies)
        return state, self._standalone_sweep(state)

    def _standalone_sweep(self, state: EnvState) -> SweepResults:
        """The per-step ray sweep as two raycast launches (K1): init,
        reset steps, checkpoint loads and the unfused branch."""
        cfg = self.cfg
        o, d, m, e = obs_mod.obs_ray_queries(cfg, state)
        obs_t, obs_id = ops_rays.raycast_batch(cfg, state, o, d, m, e)
        vis_seen, lidar = obs_mod.consume_obs_sweep(cfg, state, obs_id,
                                                    obs_t)
        o, d, m, e = obs_mod.action_ray_queries(cfg, state)
        act_t, act_id = ops_rays.raycast_batch(cfg, state, o, d, m, e)
        rew_seen = obs_mod.reward_flag_from_vis(cfg, state, vis_seen)
        return SweepResults(vis_seen=vis_seen, lidar=lidar, act_t=act_t,
                            act_id=act_id, rew_seen=rew_seen)

    def _finish(self, state: EnvState, rewards=None, dones=None):
        """Sweep a freshly generated or loaded state and assemble."""
        state = _contiguous(state)
        sweep = self._standalone_sweep(state)
        state = state.replace(act_hit_t=sweep.act_t, act_hit_id=sweep.act_id)
        return state, self._assemble(state, sweep, rewards, dones)

    def _assemble(self, state: EnvState, sweep: SweepResults, rewards=None,
                  dones=None) -> StepResult:
        cfg = self.cfg
        w = state.step.shape[0]
        dev = state.step.device
        obs = obs_mod.build_observations(cfg, state, sweep.vis_seen,
                                         sweep.lidar)
        if rewards is None:
            rewards = torch.zeros((w, cfg.max_agents, 1), device=dev)
        if dones is None:
            dones = torch.zeros((w, cfg.max_agents, 1), dtype=torch.int32,
                                device=dev)
        return StepResult(obs=obs, rewards=rewards, dones=dones,
                          episode_results=state.finished_scores)

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
        return self._finish(ckpt_mod.load_checkpoints(
            self.cfg, state, ckpt, should_load, self.levelgen))

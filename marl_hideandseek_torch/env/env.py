"""Episode draws and world regeneration (env/env.py:257-313 of the JAX
package), batched over worlds.

A *worldgen* callable makes fresh worlds: ``worldgen(world_ids,
episode_counter, level_ids) -> packed EnvState`` of ``k`` worlds. The
default (``levelgen_worldgen``) draws each world's team sizes, team flip
and key words from the env's ``torch.Generator`` and runs the batched
level generator. ``regen_world`` and ``fresh_world`` wrap a worldgen with
the episode bookkeeping of ``_regen_world`` / ``_fresh_world``.

Bit parity with JAX's threefry stream is out of scope: the same draws
are made with the same distributions from another generator. The
``ep_key`` / ``level_key`` leaves keep their shape and u32 dtype and are
filled from the generator (zeros for the level key under
``UseFixedWorld``, as in JAX).
"""

from __future__ import annotations

import torch

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.types import EnvState

# Movement constants (reference: src/sim.cpp:202-254). Default variant:
# 11 buckets, F_max 60, tau_max 15; ZeroAgentVelocity: 5, 800, 240.
DEFAULT_BUCKETS = 11
DEFAULT_F_MAX = 60.0
DEFAULT_T_MAX = 15.0
INSTANT_BUCKETS = 5
INSTANT_F_MAX = 800.0
INSTANT_T_MAX = 240.0


def randint(gen: torch.Generator, lo, hi, shape, device) -> torch.Tensor:
    """Uniform integers in [lo, hi) with per-element tensor bounds (i64)."""
    lo = torch.as_tensor(lo, device=device, dtype=torch.long)
    hi = torch.as_tensor(hi, device=device, dtype=torch.long)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    span = torch.clamp(hi - lo, min=1)
    return lo + torch.minimum(torch.floor(u * span).long(), span - 1)


def random_u32(gen: torch.Generator, shape, device) -> torch.Tensor:
    x = torch.randint(0, 2 ** 32, shape, generator=gen, device=device,
                      dtype=torch.long)
    return x.to(torch.uint32)


def draw_episode(cfg: EnvConfig, gen: torch.Generator, k: int, device):
    """Per-episode draws for k worlds (reference: initEpisodeRNG
    src/sim.cpp:105-114, team sizes :187-190, flip level_gen.cpp:232-242).
    Returns (ep_key [2, k] u32, level_key [2, k] u32, num_hiders [k],
    num_seekers [k], seekers_first [k] bool)."""
    num_hiders = randint(gen, cfg.min_hiders, cfg.max_hiders + 1, (k,),
                         device)
    num_seekers = randint(gen, cfg.min_seekers, cfg.max_seekers + 1, (k,),
                          device)
    if cfg.random_flip_teams:
        seekers_first = randint(gen, 0, 2, (k,), device) == 1
    else:
        seekers_first = torch.zeros(k, dtype=torch.bool, device=device)
    if cfg.use_fixed_world:
        level_key = torch.zeros((2, k), dtype=torch.uint32, device=device)
    else:
        level_key = random_u32(gen, (2, k), device)
    ep_key = random_u32(gen, (2, k), device)
    return ep_key, level_key, num_hiders, num_seekers, seekers_first


def levelgen_worldgen(cfg: EnvConfig, gen: torch.Generator):
    """The default worldgen: episode draws + batched level generation."""
    from marl_hideandseek_torch.env import levelgen

    def worldgen(world_ids, episode_counter, level_ids) -> EnvState:
        k = world_ids.shape[0]
        dev = world_ids.device
        ep_key, level_key, n_h, n_s, flip = draw_episode(cfg, gen, k, dev)
        return levelgen.generate_world(cfg, gen, level_key, ep_key,
                                       level_ids, n_h, n_s, flip)

    return worldgen


def _inc_u32(x: torch.Tensor) -> torch.Tensor:
    return ((x.long() + 1) & 0xFFFFFFFF).to(torch.uint32)


def regen_world(worldgen, world_ids, ps: EnvState, level_ids) -> EnvState:
    """A fresh episode for each world of ``ps`` (``_regen_world``): the
    episode counter advances, the step restarts at 0, and the episode
    scores carry over (they are cleared at step 0 of the next step)."""
    counter = _inc_u32(ps.episode_counter)
    new = worldgen(world_ids, counter.long(), level_ids)
    return new.replace(
        episode_counter=counter,
        step=torch.zeros_like(new.step),
        finished_scores=ps.finished_scores.clone(),
        running_scores=ps.running_scores.clone())


def fresh_world(worldgen, world_ids, level_ids) -> EnvState:
    """The first episode of each world (``_fresh_world``): counter 0."""
    counter = torch.zeros(world_ids.shape[0], dtype=torch.long,
                          device=world_ids.device)
    new = worldgen(world_ids, counter, level_ids)
    return new.replace(episode_counter=counter.to(torch.uint32),
                       step=torch.zeros_like(new.step))

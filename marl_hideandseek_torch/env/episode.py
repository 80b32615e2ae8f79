"""Episode draws and world regeneration (env/env.py:257-313 of the JAX
package), batched over worlds.

A *worldgen* callable makes fresh worlds: ``worldgen(world_ids,
episode_counter, level_ids) -> packed EnvState`` of ``k`` worlds. The
default (``levelgen_worldgen``) draws each world's team sizes, team flip
and key words from its own stream keyed by (``cfg.rand_seed``, world id,
episode counter) (``rng.episode_rng``), as JAX keys each episode by
``fold_in(fold_in(base_key, world_id), episode_counter)``: a world's
episode depends on its seed, id and counter alone, whatever batch or
reset branch draws it. Then it runs a *levelgen*:
``levelgen(level_key, ep_key, level_ids, num_hiders, num_seekers,
seekers_first) -> packed EnvState``. The default levelgen
(``keyed_levelgen``) draws from each world's level key alone
(``rng.KeyedRNG``), so a checkpoint's level key regenerates its level.
``regen_world`` and ``fresh_world`` wrap a worldgen with the episode
bookkeeping of ``_regen_world`` / ``_fresh_world``.

Bit parity with JAX's threefry stream is out of scope: the same draws
are made with the same distributions from other generators. The
``ep_key`` / ``level_key`` leaves keep their shape and u32 dtype (zeros
for the level key under ``UseFixedWorld``, as in JAX).
"""

from __future__ import annotations

from typing import Callable

import torch

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.env import levelgen
from marl_hideandseek_torch.env.rng import (
    KeyedRNG,
    episode_rng,
    randint,
    random_u32,
)
from marl_hideandseek_torch.types import EnvState

# worldgen(world_ids [k] i64, episode_counter [k] i64, level_ids [k] i64)
#   -> packed EnvState of k fresh worlds (episode draws + level
#   generation; step, counter and scores are set by the caller).
WorldGen = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], EnvState]
# levelgen(level_key [2, k] u32, ep_key [2, k] u32, level_ids [k],
#   num_hiders [k], num_seekers [k], seekers_first [k] bool)
#   -> packed EnvState of k worlds.
LevelGen = Callable[..., EnvState]


def draw_episode(cfg: EnvConfig, gen, k: int, device):
    """Per-episode draws for k worlds (reference: initEpisodeRNG
    src/sim.cpp:105-114, team sizes :187-190, flip level_gen.cpp:232-242)
    from ``gen``, a ``KeyedRNG`` of k worlds or a ``torch.Generator``.
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
        level_key = _key_words(gen, k, device)
    ep_key = _key_words(gen, k, device)
    return ep_key, level_key, num_hiders, num_seekers, seekers_first


def _key_words(gen, k: int, device) -> torch.Tensor:
    """[2, k] u32 key words; a KeyedRNG draws them world-first."""
    if isinstance(gen, KeyedRNG):
        return random_u32(gen, (k, 2), device).T.contiguous()
    return random_u32(gen, (2, k), device)


def keyed_levelgen(cfg: EnvConfig) -> LevelGen:
    """The default levelgen: the batched level generator drawing from each
    world's level key."""

    def levelgen_fn(level_key, ep_key, level_ids, num_hiders, num_seekers,
                    seekers_first) -> EnvState:
        return levelgen.generate_world(cfg, KeyedRNG(level_key), level_key,
                                       ep_key, level_ids, num_hiders,
                                       num_seekers, seekers_first)

    return levelgen_fn


def levelgen_worldgen(cfg: EnvConfig,
                      levelgen_fn: LevelGen = None) -> WorldGen:
    """The default worldgen: episode draws keyed by (``cfg.rand_seed``,
    world id, episode counter), then ``levelgen_fn`` (default
    ``keyed_levelgen``)."""
    levelgen_fn = levelgen_fn or keyed_levelgen(cfg)

    def worldgen(world_ids, episode_counter, level_ids) -> EnvState:
        k = world_ids.shape[0]
        dev = world_ids.device
        rng = episode_rng(cfg.rand_seed, world_ids, episode_counter)
        ep_key, level_key, n_h, n_s, flip = draw_episode(cfg, rng, k, dev)
        return levelgen_fn(level_key, ep_key, level_ids, n_h, n_s, flip)

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

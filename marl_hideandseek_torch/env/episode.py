"""Episode draws and world regeneration (env/env.py:257-313 of the JAX
package), batched over worlds.

A *worldgen* callable makes fresh worlds: ``worldgen(base_key, world_ids,
episode_counter, level_ids) -> packed EnvState`` of ``k`` worlds. The
default (``levelgen_worldgen``) follows JAX's ``_draw_episode``: each
world's episode key is ``fold_in(fold_in(base_key, world_id),
episode_counter)`` (``rng.episode_keys``), split four ways into the team
sizes', the level's and the team flip's keys; then it runs a *levelgen*:
``levelgen(level_key, ep_key, level_ids, num_hiders, num_seekers,
seekers_first) -> packed EnvState``, by default the level generator,
which draws from each world's level key alone. Both use JAX's threefry
(``prng.py``), so a world equals JAX's for the same base key, id and
counter, and a checkpoint's level key regenerates JAX's level.
``regen_world`` and ``fresh_world`` wrap a worldgen with the episode
bookkeeping of ``_regen_world`` / ``_fresh_world``.

The ``ep_key`` / ``level_key`` leaves are the key words (zeros for the
level key under ``UseFixedWorld``, as in JAX).
"""

from __future__ import annotations

from typing import Callable

import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.env import levelgen
from marl_hideandseek_torch.env.rng import episode_keys
from marl_hideandseek_torch.types import EnvState
from marl_hideandseek_torch.utils import tracing

# worldgen(base_key [2] u32, world_ids [k] i64, episode_counter [k] i64,
#   level_ids [k] i64) -> packed EnvState of k fresh worlds (episode
#   draws + level generation; step, counter and scores are set by the
#   caller).
WorldGen = Callable[..., EnvState]
# levelgen(level_key [2, k] u32, ep_key [2, k] u32, level_ids [k],
#   num_hiders [k], num_seekers [k], seekers_first [k] bool)
#   -> packed EnvState of k worlds.
LevelGen = Callable[..., EnvState]


def draw_episode(cfg: EnvConfig, ep_key: torch.Tensor):
    """Per-episode draws from episode keys ``[k, 2]`` (JAX env.py:257-279;
    reference: initEpisodeRNG src/sim.cpp:105-114, team sizes :187-190,
    flip level_gen.cpp:232-242): ``k_h, k_s, k_lvl, k_flip =
    split(ep_key, 4)``; the flip is drawn only under RandomFlipTeams.
    Returns (ep_key [2, k] u32, level_key [2, k] u32, num_hiders [k],
    num_seekers [k], seekers_first [k] bool)."""
    k, dev = ep_key.shape[0], ep_key.device
    ks = prng.split(ep_key, 4)                       # [k, 4, 2]
    # The team sizes' and the flip's randints in one launch pair: keys
    # 0, 1 and 3 (k_lvl's slot 2 drawn too, unused).
    hi, lo = prng.randint_bits(ks)
    num_hiders = prng.randint_from_bits(hi[:, 0], lo[:, 0], cfg.min_hiders,
                                        cfg.max_hiders + 1)
    num_seekers = prng.randint_from_bits(hi[:, 1], lo[:, 1], cfg.min_seekers,
                                         cfg.max_seekers + 1)
    if cfg.random_flip_teams:
        seekers_first = prng.randint_from_bits(hi[:, 3], lo[:, 3], 0, 2) == 1
    else:
        seekers_first = torch.zeros(k, dtype=torch.bool, device=dev)
    def word_major(keys):
        return prng.u32(prng.i32(keys).T.contiguous())

    if cfg.use_fixed_world:
        level_key = torch.zeros((2, k), dtype=torch.uint32, device=dev)
    else:
        level_key = word_major(ks[:, 2])
    return (word_major(ep_key), level_key, num_hiders, num_seekers,
            seekers_first)


def default_levelgen(cfg: EnvConfig) -> LevelGen:
    """The default levelgen: the batched level generator drawing from
    each world's level key."""

    def levelgen_fn(level_key, ep_key, level_ids, num_hiders, num_seekers,
                    seekers_first) -> EnvState:
        return levelgen.generate_world(cfg, level_key, ep_key, level_ids,
                                       num_hiders, num_seekers,
                                       seekers_first)

    return levelgen_fn


def levelgen_worldgen(cfg: EnvConfig,
                      levelgen_fn: LevelGen = None) -> WorldGen:
    """The default worldgen: JAX's episode draws from (base key, world
    id, episode counter), then ``levelgen_fn`` (default
    ``default_levelgen``)."""
    levelgen_fn = levelgen_fn or default_levelgen(cfg)

    def worldgen(base_key, world_ids, episode_counter, level_ids) -> EnvState:
        ep_key = episode_keys(base_key, world_ids, episode_counter)
        ep_key, level_key, n_h, n_s, flip = draw_episode(cfg, ep_key)
        return levelgen_fn(level_key, ep_key, level_ids, n_h, n_s, flip)

    return worldgen


def _words(x: torch.Tensor) -> torch.Tensor:
    """u32 words as int64 in [0, 2**32)."""
    return x.view(torch.int32).long() & 0xFFFFFFFF


def _inc_u32(x: torch.Tensor) -> torch.Tensor:
    return ((_words(x) + 1) & 0xFFFFFFFF).to(torch.uint32)


def regen_world(worldgen, base_key, world_ids, ps: EnvState,
                level_ids) -> EnvState:
    """A fresh episode for each world of ``ps`` (``_regen_world``): the
    episode counter advances, the step restarts at 0, and the episode
    scores carry over (they are cleared at step 0 of the next step)."""
    counter = _inc_u32(ps.episode_counter)
    with tracing.span("env.levelgen"):
        new = worldgen(base_key, world_ids, _words(counter), level_ids)
    return new.replace(
        episode_counter=counter,
        step=torch.zeros_like(new.step),
        finished_scores=ps.finished_scores.clone(),
        running_scores=ps.running_scores.clone())


def fresh_world(worldgen, base_key, world_ids, level_ids) -> EnvState:
    """The first episode of each world (``_fresh_world``): counter 0."""
    counter = torch.zeros(world_ids.shape[0], dtype=torch.long,
                          device=world_ids.device)
    with tracing.span("env.levelgen"):
        new = worldgen(base_key, world_ids, counter, level_ids)
    return new.replace(episode_counter=counter.to(torch.uint32),
                       step=torch.zeros_like(new.step))

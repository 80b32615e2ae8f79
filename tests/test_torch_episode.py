"""PyTorch port: episode draws keyed by (base key, world id, episode
counter) (env/episode.py, env/rng.py::episode_keys), as the JAX package
keys each episode by fold_in(fold_in(base_key, world_id), counter), with
the base key PRNGKey(rand_seed) on resets. A
world's episode must not depend on the batch or reset branch that draws
it, and ``world_ids`` must reach the draws."""

import pytest
import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import packed as tp
from marl_hideandseek_torch.env.episode import levelgen_worldgen

W = 8
CFG = EnvConfig(num_worlds=W, min_hiders=1, max_hiders=3, min_seekers=1,
                max_seekers=3, max_boxes=3, max_ramps=1, reset_budget=4,
                sim_flags=SimFlags.ZeroAgentVelocity |
                SimFlags.RandomFlipTeams, rand_seed=11)
A = CFG.max_agents


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def _world(ps, w):
    """Every leaf of packed ``ps`` at world ``w``."""
    return [_bits(x)[..., w] for x in ps.leaves()]


def _assert_same_world(a, wa, b, wb):
    for x, y in zip(_world(a, wa), _world(b, wb)):
        assert torch.equal(x, y)


def _draw(ids, counters, cfg=CFG):
    ids = torch.as_tensor(ids, dtype=torch.long)
    counters = torch.as_tensor(counters, dtype=torch.long)
    return levelgen_worldgen(cfg)(prng.key(cfg.rand_seed), ids, counters,
                                  torch.ones_like(ids))


def test_world_drawn_alone_equals_world_in_batch():
    """The same (id, counter) gives the same world alone or in any
    batch, in any position."""
    batch = _draw(range(W), [3] * W)
    for w in (0, 5, 7):
        _assert_same_world(_draw([w], [3]), 0, batch, w)
    other = _draw([6, 40, 5, 2], [3, 0, 3, 3])
    for slot, w in ((0, 6), (2, 5), (3, 2)):
        _assert_same_world(other, slot, batch, w)


def test_different_ids_and_counters_draw_different_episodes():
    ps = _draw(list(range(W)) + [0], [0] * W + [1])
    keys = {tuple(_bits(ps.level_key[:, w]).tolist()) for w in range(W + 1)}
    eps = {tuple(_bits(ps.ep_key[:, w]).tolist()) for w in range(W + 1)}
    assert len(keys) == W + 1 and len(eps) == W + 1
    # Team sizes and flips vary across worlds (min 1, max 3 per team).
    assert len(set(ps.num_hiders.tolist())) > 1
    assert len(set(ps.num_seekers.tolist())) > 1
    assert len(set(ps.seekers_first.tolist())) == 2


def _stepped(env, ps, resets, world_ids=None):
    acts = torch.zeros((A, 5, W), dtype=torch.int32)
    return env.step(ps, acts, torch.as_tensor(resets, dtype=torch.int32),
                    world_ids=world_ids)[0]


def test_full_and_compact_branches_draw_the_same_world():
    """Worlds 2 and 5 regenerated through the compact branch (2 resets
    under a budget of 4) equal the same worlds regenerated through the
    full branch (every world resets), and equal a fresh draw of their
    (id, counter)."""
    env = tp.PackedEnv(CFG, device="cpu")
    ps, _ = env.init()
    ps = ps.replace(step=torch.full_like(ps.step, 50))
    compact = [0, 0, 1, 0, 0, 1, 0, 0]
    a = _stepped(env, ps, compact)
    b = _stepped(env, ps, [1] * W)
    assert env.reset_counts == {"full": 1, "compact": 1}
    fresh = _draw([2, 5], [1, 1])
    for w, slot in ((2, 0), (5, 1)):
        _assert_same_world(a, w, b, w)
        for name in ("level_key", "ep_key"):
            assert torch.equal(_bits(getattr(a, name))[:, w],
                               _bits(getattr(fresh, name))[:, slot])
        assert torch.equal(a.statics.wall_pos[..., w],
                           fresh.statics.wall_pos[..., slot])
        assert torch.equal(a.bodies.pos[..., w], fresh.bodies.pos[..., slot])


@pytest.mark.parametrize("branch", ["compact", "full"])
def test_step_world_ids_reach_the_draws(branch):
    """``PackedEnv.step(world_ids=...)`` keys the regenerated worlds by
    the given ids, in both reset branches."""
    env = tp.PackedEnv(CFG, device="cpu")
    ps, _ = env.init()
    resets = [0, 1, 0, 0, 0, 0, 1, 0] if branch == "compact" else [1] * W
    hit = [i for i, r in enumerate(resets) if r]
    ids = torch.arange(W) + 1000
    a = _stepped(env, ps, resets)
    b = _stepped(env, ps, resets, world_ids=ids)
    assert env.reset_counts[branch] == 2
    fresh = _draw(ids[hit], [1] * len(hit))
    for slot, w in enumerate(hit):
        assert not torch.equal(_bits(a.level_key)[:, w],
                               _bits(b.level_key)[:, w])
        assert torch.equal(_bits(b.level_key)[:, w],
                           _bits(fresh.level_key)[:, slot])
        assert torch.equal(b.statics.wall_pos[..., w],
                           fresh.statics.wall_pos[..., slot])


def test_two_shards_with_one_seed_draw_different_episodes():
    """Two envs with the same rand_seed (two shards of one run) over
    disjoint world ids draw different episodes; the same ids draw the
    same ones."""
    e1 = tp.PackedEnv(CFG, device="cpu")
    e2 = tp.PackedEnv(CFG, device="cpu")
    ps, _ = e1.init()
    ones = [1] * W
    s1 = _stepped(e1, ps, ones, world_ids=torch.arange(W))
    s2 = _stepped(e2, ps, ones, world_ids=torch.arange(W, 2 * W))
    s3 = _stepped(e2, ps, ones, world_ids=torch.arange(W))
    for w in range(W):
        assert not torch.equal(_bits(s1.level_key)[:, w],
                               _bits(s2.level_key)[:, w])
        assert not torch.equal(_bits(s1.ep_key)[:, w],
                               _bits(s2.ep_key)[:, w])
        _assert_same_world(s1, w, s3, w)
    assert not torch.equal(s1.statics.wall_pos, s2.statics.wall_pos)


def test_seed_changes_the_draws():
    a = _draw(range(W), [0] * W)
    b = _draw(range(W), [0] * W, CFG.replace(rand_seed=12))
    assert not bool((_bits(a.level_key) == _bits(b.level_key)).any())

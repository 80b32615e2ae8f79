"""PyTorch port: the batched level generator (env/geometry.py,
env/levelgen.py) held world by world to the JAX package's
``generate_world`` from the same threefry keys (``prng.py``), and
distributionally to the numpy transliteration of the reference generator
in tests/test_levelgen_oracle.py, with that file's
implementation-neutral statistics, over 256 seeds per side (the oracle
draws from another random stream); the structural invariants are
checked world by world."""

import numpy as np
import pytest
import torch

import test_levelgen_oracle as oracle
from marl_hideandseek_torch import bridge, prng
from marl_hideandseek_torch.config import MAX_WALLS, EnvConfig, SimFlags
from marl_hideandseek_torch.env import geometry, levelgen
from marl_hideandseek_torch.env.episode import (
    default_levelgen,
    draw_episode,
    levelgen_worldgen,
)
from marl_hideandseek_torch.env.rng import episode_keys
from marl_hideandseek_torch.types import AGENT_HIDER, body_slot_ranges

N_SEEDS = 256
CFG = EnvConfig(num_worlds=N_SEEDS, min_hiders=2, max_hiders=2,
                min_seekers=2, max_seekers=2,
                sim_flags=SimFlags.RandomFlipTeams)


def _episodes(seed):
    """Episode draws of N_SEEDS worlds at counter 0 from PRNGKey(seed)."""
    ids = torch.arange(N_SEEDS)
    return draw_episode(CFG, episode_keys(prng.key(seed), ids,
                                          torch.zeros_like(ids)))


@pytest.fixture(scope="module")
def worlds():
    ep, lk, nh, ns, flip = _episodes(100)
    lvl = torch.ones(N_SEEDS, dtype=torch.long)
    ps = levelgen.generate_world(CFG, lk, ep, lvl, nh, ns, flip)
    return ps


def _torch_stats(ps):
    wp = ps.statics.wall_pos.movedim(-1, 0).numpy()
    wh = ps.statics.wall_half_ext.movedim(-1, 0).numpy()
    wa = ps.statics.wall_active.movedim(-1, 0).numpy()
    nb = ps.num_active_boxes.numpy()
    he = ps.bodies.half_ext.movedim(-1, 0).numpy()
    act = ps.bodies.active.movedim(-1, 0).numpy()
    pos = ps.bodies.pos.movedim(-1, 0).numpy()
    quat = ps.bodies.quat.movedim(-1, 0).numpy()
    (_, _), (rl, rh), _ = body_slot_ranges(CFG)
    stats = {k: [] for k in ("wall_n", "wall_len", "door_n", "door_w",
                             "boxes", "elong", "over")}
    for w in range(N_SEEDS):
        rects = np.array([(wp[w, i, 0], wp[w, i, 1], wh[w, i, 0],
                           wh[w, i, 1]) for i in range(MAX_WALLS)
                          if wa[w, i]])
        stats["wall_n"].append(len(rects))
        stats["wall_len"].append(sum(2 * max(r[2], r[3]) for r in rects))
        g = oracle.door_gaps(rects)
        stats["door_n"].append(len(g))
        stats["door_w"].extend(g)
        stats["boxes"].append(int(nb[w]))
        stats["elong"].append(int(np.sum((he[w, :rl, 0] > 3.0) &
                                         act[w, :rl])))
        cs = [(r[0], r[1]) for r in rects]
        halves = [(r[2], r[3]) for r in rects]
        for slot in range(pos.shape[1]):
            if not act[w, slot]:
                continue
            off = (np.asarray(levelgen.RAMP_CENTER_OFF)[:2]
                   if rl <= slot < rh else np.zeros(2))
            theta = 2.0 * np.arctan2(quat[w, slot, 3], quat[w, slot, 0])
            c, h = oracle._world_aabb2(he[w, slot], off, pos[w, slot, :2],
                                       theta)
            cs.append((c[0], c[1]))
            halves.append((h[0], h[1]))
        flags = oracle.overlap_accept_fraction(cs, halves, len(rects))
        stats["over"].append(np.mean(flags) if flags else 0.0)
    return {k: np.array(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def oracle_stats():
    return oracle._oracle_stats(N_SEEDS)


@pytest.fixture(scope="module")
def keyed():
    """(level key, episode draws, worlds) from the default levelgen."""
    ep, lk, nh, ns, flip = _episodes(101)
    lvl = torch.ones(N_SEEDS, dtype=torch.long)
    draws = (lk, ep, lvl, nh, ns, flip)
    return draws, default_levelgen(CFG)(*draws)


def test_levelgen_distribution_matches_oracle(worlds, oracle_stats):
    """The oracle file's statistics and tolerances (wall count mean/std,
    total wall length, door count/width, box and elongated counts, the
    overlap-accept rate), 256 seeds per side."""
    _assert_stats_close(oracle_stats, _torch_stats(worlds))


def test_keyed_levelgen_distribution_matches_oracle(keyed, oracle_stats):
    """The default levelgen (draws keyed per world by the level key)
    meets the same statistics."""
    _assert_stats_close(oracle_stats, _torch_stats(keyed[1]))


def test_keyed_levelgen_depends_on_the_key_alone(keyed):
    """A world regenerated alone, or in another batch, from its level key
    equals the world of the full batch: what a checkpoint load needs."""
    draws, ps = keyed
    sel = torch.tensor([5, 100, 17])
    sub = default_levelgen(CFG)(*(d[..., sel] for d in draws))
    for a, b in zip(ps.leaves(), sub.leaves()):
        a = a.view(torch.int32) if a.dtype == torch.uint32 else a
        b = b.view(torch.int32) if b.dtype == torch.uint32 else b
        assert torch.equal(a[..., sel], b)
    assert not torch.equal(ps.statics.wall_pos[..., 5],
                           ps.statics.wall_pos[..., 100])


def _assert_stats_close(o, t):
    """The oracle file's tolerances on each statistic."""

    def close(name, a, b, tol):
        assert abs(a - b) < tol, (name, float(a), float(b))

    close("wall count mean", o["wall_n"].mean(), t["wall_n"].mean(), 0.8)
    close("wall count std", o["wall_n"].std(), t["wall_n"].std(), 0.8)
    close("total wall length", o["wall_len"].mean(), t["wall_len"].mean(),
          8.0)
    close("door count mean", o["door_n"].mean(), t["door_n"].mean(), 0.8)
    close("door width mean", o["door_w"].mean(), t["door_w"].mean(), 0.5)
    close("box total mean", o["boxes"].mean(), t["boxes"].mean(), 0.3)
    close("elongated mean", o["elong"].mean(), t["elong"].mean(), 0.3)
    close("overlap-accept rate", o["over"].mean(), t["over"].mean(), 0.06)


def test_levelgen_structure(worlds):
    """Per-world invariants: densely packed walls inside the arena, 3-9
    boxes with the elongated ones first, 2 ramps, the agent teams, owner
    and mass encodings, unit quaternions, resting height."""
    ps = worlds
    wa = ps.statics.wall_active
    n_w = wa.sum(0)
    assert bool((wa == (torch.arange(MAX_WALLS)[:, None] < n_w)).all())
    assert int(n_w.min()) >= 4 and int(n_w.max()) <= 34
    assert float(ps.statics.wall_pos[:, :2].abs().max()) <= 18.0 + 1e-4
    nb = ps.num_active_boxes
    assert int(nb.min()) >= 3 and int(nb.max()) <= 9
    (bl, bh), (rl, rh), (al, ah) = body_slot_ranges(CFG)
    act = ps.bodies.active
    assert bool((act[bl:bh] == (torch.arange(9)[:, None] < nb)).all())
    assert bool(act[rl:rh].all()) and bool(act[al:ah].all())
    elong = ps.bodies.half_ext[bl:bh, 0] > 3.0
    n_el = (elong & act[bl:bh]).sum(0)
    assert int(n_el.min()) >= 3
    assert bool((elong == (torch.arange(9)[:, None] < n_el)).all())
    q = ps.bodies.quat
    assert torch.allclose((q * q).sum(1), torch.ones(()), atol=1e-5)
    assert bool((ps.bodies.pos[:, 2] == 1.0).all())
    hiders = (ps.agent_type == AGENT_HIDER).sum(0)
    assert bool((hiders == 2).all())
    assert bool((ps.num_hiders == 2).all()) and bool((ps.num_seekers == 2).all())
    first_is_hider = ps.agent_type[0] == AGENT_HIDER
    assert bool((first_is_hider == ~ps.seekers_first).all())
    assert 0 < int(ps.seekers_first.sum()) < N_SEEDS
    assert bool((ps.bodies.owner[al:ah] == 3).all())
    assert bool((ps.bodies.inv_inertia[al:ah, :2] == 0).all())
    assert ps.ep_key.dtype == torch.uint32 and ps.ep_key.shape == (2, N_SEEDS)


def test_wall_grammar_unit_square():
    """The grammar alone: endpoints sorted, inside the unit square, wall
    lengths non-negative, counts within the op budget."""
    ws = geometry.make_walls(prng.split(prng.key(7), 64))
    act = geometry.wall_active(ws)
    p1, p2 = ws.p1[act], ws.p2[act]
    assert bool((p1 <= p2 + 1e-6).all())
    assert float(p1.min()) >= -1e-6 and float(p2.max()) <= 1 + 1e-6
    assert bool((geometry.wall_length(ws)[act] >= -1e-6).all())
    assert int(ws.n.min()) >= 4 and int(ws.n.max()) <= 34


@pytest.mark.parametrize("level", [2, 3, 4, 5, 6, 7, 8])
def test_debug_levels_match_jax(level):
    """Debug fixtures 2-8 against the JAX package's, field by field."""
    import dataclasses
    from marl_hideandseek_tpu.config import EnvConfig as JCfg
    from marl_hideandseek_tpu.env import levelgen as jlevelgen

    jcfg = JCfg(num_worlds=1)
    tcfg = EnvConfig(num_worlds=1)
    fn = getattr(jlevelgen, f"_level{level}")
    js = fn(jcfg)
    ts = levelgen.debug_level(tcfg, level)

    def flat(x, prefix=""):
        if dataclasses.is_dataclass(x):
            out = {}
            for f in dataclasses.fields(x):
                out.update(flat(getattr(x, f.name), prefix + f.name + "."))
            return out
        return {prefix[:-1]: x}

    jf, tf = flat(js), flat(ts)
    assert jf.keys() == tf.keys()
    for k in jf:
        a = np.asarray(jf[k])
        b = tf[k][0].numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# Reduced capacity (tests/test_pallas_kernels.py:20-26) at W = 128, and a
# few worlds at full capacity.
JAX_CASES = {
    "reduced": dict(num_worlds=128, min_hiders=1, max_hiders=1,
                    min_seekers=1, max_seekers=1, max_boxes=3, max_ramps=1),
    "full": dict(num_worlds=6, min_hiders=1, max_hiders=3, min_seekers=1,
                 max_seekers=3),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_generated_worlds_match_jax(case):
    """The default worldgen (episode draws, then the level generator)
    against JAX's ``_draw_episode`` + ``generate_world`` vmapped over the
    same worlds, base key and counters: every integer and boolean leaf
    equal (key words, team sizes and flips, box counts, wall counts and
    activity, rejection winners through the positions they pick), floats
    within 1e-5. No float near-tie flipped a rejection or a wall test on
    these draws, so no share of worlds is excused."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from marl_hideandseek_tpu.config import EnvConfig as JCfg
    from marl_hideandseek_tpu.config import SimFlags as JFlags
    from marl_hideandseek_tpu.env import env as jenv
    from marl_hideandseek_tpu.env import levelgen as jlevelgen

    kw = JAX_CASES[case]
    w = kw["num_worlds"]
    jcfg = JCfg(**kw, sim_flags=JFlags.RandomFlipTeams)
    tcfg = EnvConfig(**kw, sim_flags=SimFlags.RandomFlipTeams)
    base = jax.random.PRNGKey(23)

    def one(wid, counter):
        ep, lk, n_h, n_s, flip = jenv._draw_episode(jcfg, base, wid, counter)
        return jlevelgen.generate_world(jcfg, lk, ep, 1, n_h, n_s, flip)

    ids = np.arange(w, dtype=np.uint32)
    counters = (ids * 7 % 5).astype(np.uint32)
    js = jax.jit(jax.vmap(one, out_axes=-1))(jnp.asarray(ids),
                                             jnp.asarray(counters))
    ts = levelgen_worldgen(tcfg)(prng.key(23), torch.from_numpy(
        ids.astype(np.int64)), torch.from_numpy(counters.astype(np.int64)),
        torch.ones(w, dtype=torch.long))

    def flat(x, prefix=""):
        if dataclasses.is_dataclass(x):
            out = {}
            for f in dataclasses.fields(x):
                out.update(flat(getattr(x, f.name), prefix + f.name + "."))
            return out
        return {prefix[:-1]: np.asarray(x)}

    jf = flat(js)
    tf = bridge.flatten_tree(bridge.state_to_numpy(ts))
    assert jf.keys() == tf.keys()
    for k, a in jf.items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(tf[k], a, rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tf[k], a, err_msg=k)
    # The draws vary across worlds: wall counts and team sizes.
    assert len(np.unique(jf["statics.wall_active"].sum(0))) > 1
    assert case == "reduced" or len(np.unique(jf["num_hiders"])) > 1

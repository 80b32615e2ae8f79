"""PyTorch port on the card: each CUDA kernel (K1 raycast, K2 physics, K3
fused physics + sweep, K4 megastep, K5 RGBD, K6 observation assembly,
K7 level generation, and the threefry kernel of every random draw)
against its plain PyTorch version on CUDA tensors, the packed env's main
path through K1, K4, K6 and K7 (the classic env's resets through K7 too), the classic env through K3, K2 and K1, the flagship policy ensemble's forward against the CPU's and its routed forward against the naive one,
the ``openai_hns`` policy's forward against its plain reference at 1,024
3v3 worlds (K4 with the default force movement beside it), K5's frames
mode against its packed mode at 16,384 worlds and the routed
``impala_cnn`` forward against the unrouted one, the inference
loop through K4 and K1, and a PPO update at train.sh's
configuration against the CPU's at the update's rounding bars
(``marl_hideandseek_torch/testing.py``), which each planted Adam fault
must fail; the record path at infer.sh's 16 worlds through K4 and K1, and
the viewer at one world through K3, K1 and K5.

Marked ``gpu``; every test skips here without a card (decided in the
``cuda`` fixture). On a machine with one:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest`` leaves out tests/conftest.py's JAX setup, which these
tests do not need and which a machine without JAX cannot import.)
"""

import pytest
import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import levelgen
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env import packed as tp
from marl_hideandseek_torch.env.env import HideAndSeekEnv
from marl_hideandseek_torch.env.episode import draw_episode
from marl_hideandseek_torch.env.rng import episode_keys
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.infer import run_inference
from marl_hideandseek_torch.ops import common as ops_common
from marl_hideandseek_torch.ops import fused as ops_fused
from marl_hideandseek_torch.ops import levelgen as ops_levelgen
from marl_hideandseek_torch.ops import physics as ops_physics
from marl_hideandseek_torch.ops import rays as ops_rays
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.ops import step as ops_step
from marl_hideandseek_torch.ops import threefry as ops_threefry
from marl_hideandseek_torch.policy import make_policy
from marl_hideandseek_torch.testing import observation_case
from marl_hideandseek_torch.train.rollout import apply_ensemble
from marl_hideandseek_torch.types import on_bits, pack_state, unpack_state
from marl_hideandseek_torch.utils import tracing
from marl_hideandseek_torch.viz import rgbd as plain_rgbd

pytestmark = pytest.mark.gpu

FLAGS = SimFlags.ZeroAgentVelocity | SimFlags.RandomFlipTeams
REDUCED = dict(min_hiders=1, max_hiders=1, min_seekers=1, max_seekers=1,
               max_boxes=3, max_ramps=1)
FULL = dict(min_hiders=2, max_hiders=2, min_seekers=2, max_seekers=2)
# scripts/headless.py's teams: R = 5 x (T + 30) = 230 rays a world.
CLASSIC = dict(min_hiders=3, max_hiders=3, min_seekers=2, max_seekers=2)
# The JAX kernels' bars against their own oracles
# (tests/test_pallas_kernels.py:59-110): value bar, fraction within it.
KERNEL = dict(pos=(5e-3, 0.995), quat=(5e-3, 0.995), vel=(0.5, 0.995),
              omega=(0.5, 0.995))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _state(cuda, kw, w, step):
    cfg = EnvConfig(num_worlds=w, **kw, sim_flags=FLAGS, rand_seed=3)
    ps, _ = PackedEnv(cfg, device=cuda).init()
    return cfg, ps.replace(step=torch.full_like(ps.step, step))


@pytest.mark.parametrize("k,n", [(4096, 1000), (13, 37), (1, 4099)])
def test_threefry_kernel_matches_plain(cuda, k, n):
    """Every mode, with per-key, shared and no counters: the kernel's
    words equal the plain version's, one launch a call; the card's keys
    split and draw as on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(k)

    def u32(*shape):
        return torch.randint(0, 2 ** 32, shape, generator=g, device=cuda,
                             dtype=torch.long).to(torch.uint32)

    keys = u32(k, 2)
    words = lambda x: x.view(torch.int32)
    for ctr in (u32(k, n, 2), u32(1, n, 2), None):
        for mode in (ops_threefry.PAIRS, ops_threefry.BITS,
                     ops_threefry.UNIFORM):
            n0 = ops_threefry.THREEFRY.launches
            got = ops_threefry.threefry(keys, ctr, n, mode)
            assert ops_threefry.THREEFRY.launches == n0 + 1
            want = ops_threefry.threefry_plain(keys, ctr, n, mode)
            assert torch.equal(words(got), words(want))
    key = prng.key(k, cuda)
    for a, b in ((prng.split(key, 5), prng.split(key.cpu(), 5)),
                 (prng.uniform(key, (n,)), prng.uniform(key.cpu(), (n,))),
                 (prng.randint(key, (n,), 0, 7),
                  prng.randint(key.cpu(), (n,), 0, 7))):
        assert torch.equal(words(a.cpu()) if a.dtype != torch.long
                           else a.cpu(), words(b) if b.dtype != torch.long
                           else b)


@pytest.mark.parametrize("w", [1000, 4096])
def test_raycast_kernel_matches_plain(cuda, w):
    """Ragged and lane-aligned world counts; ids >= 99.9 % equal, t within
    1e-4 on equal hits (the JAX kernel's bars)."""
    cfg, ps = _state(cuda, FULL, w, 0)
    st = obs_mod.world_first(ps)
    q = [torch.movedim(x, 0, -1).contiguous()
         for x in obs_mod.obs_ray_queries(cfg, st)]
    n0 = ops_rays.RAYCAST.launches
    t_k, id_k = ops_rays.raycast_batch_packed(cfg, ps, *q)
    t_p, id_p = ops_rays.raycast_packed_plain(cfg, ps, *q)
    torch.cuda.synchronize()
    assert ops_rays.RAYCAST.launches == n0 + 1
    eq = id_k == id_p
    assert eq.float().mean().item() >= 0.999
    hit = eq & (id_k >= 0)
    torch.testing.assert_close(t_k[hit], t_p[hit], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
@pytest.mark.parametrize("w", [200, 1001, 2048])
def test_megastep_kernel_matches_plain(cuda, kw, w):
    """Three chained launches at the JAX kernels' bars; 1001 worlds leave
    a ragged last block (4 worlds per block)."""
    cfg, ps = _state(cuda, kw, w, 100)
    _chained_megastep(cuda, cfg, ps, 5)


@pytest.mark.parametrize("w", [1001, 1024])
def test_megastep_kernel_default_movement_matches_plain(cuda, w):
    """K4 with the env's default movement (no ZeroAgentVelocity: 11 force
    and torque buckets, F_max 60), 3v3 at full capacity, the ``openai_hns``
    configuration's env: three chained launches at the JAX kernels'
    bars."""
    cfg = EnvConfig(num_worlds=w, min_hiders=3, max_hiders=3,
                    min_seekers=3, max_seekers=3,
                    sim_flags=SimFlags.RandomFlipTeams, rand_seed=3)
    assert not cfg.zero_agent_velocity
    ps, _ = PackedEnv(cfg, device=cuda).init()
    _chained_megastep(cuda, cfg, ps.replace(step=torch.full_like(ps.step,
                                                                 100)), 11)


def _chained_megastep(cuda, cfg, ps, buckets):
    w = ps.step.shape[0]
    g = torch.Generator(device=cuda).manual_seed(0)
    na = cfg.max_agents
    for _ in range(3):
        acts = torch.cat([
            torch.randint(0, buckets, (na, 3, w), generator=g, device=cuda),
            torch.randint(0, 2, (na, 2, w), generator=g, device=cuda)],
            1).to(torch.int32)
        rk = ops_step.megastep_packed(cfg, ps, acts)
        rp = ops_step.megastep_plain(cfg, ps, acts)
        torch.cuda.synchronize()
        for name, (tol, need) in KERNEL.items():
            a, b = getattr(rk[0].bodies, name), getattr(rp[0].bodies, name)
            assert ((a - b).abs() < tol).float().mean().item() >= need, name
        assert (rk[1].vis_seen == rp[1].vis_seen).float().mean() >= 0.999
        assert (rk[1].act_id == rp[1].act_id).float().mean() >= 0.999
        lid = ((rk[1].lidar - rp[1].lidar).abs() < 1e-3).float().mean()
        assert lid >= 0.999
        assert torch.equal(rk[2], rp[2]) and torch.equal(rk[3], rp[3])
        ps = rk[0].replace(step=rk[0].step + 1, act_hit_t=rk[1].act_t,
                           act_hit_id=rk[1].act_id)


def _check_raycast(cfg, ps):
    """K1 on ``ps``'s visibility + lidar and grab/lock queries against
    the plain version at the JAX kernel's bars; one launch each."""
    st = obs_mod.world_first(ps)
    for queries in (obs_mod.obs_ray_queries(cfg, st),
                    obs_mod.action_ray_queries(cfg, st)):
        q = [torch.movedim(x, 0, -1).contiguous() for x in queries]
        n0 = ops_rays.RAYCAST.launches
        t_k, id_k = ops_rays.raycast_batch_packed(cfg, ps, *q)
        t_p, id_p = ops_rays.raycast_packed_plain(cfg, ps, *q)
        torch.cuda.synchronize()
        assert ops_rays.RAYCAST.launches == n0 + 1
        eq = id_k == id_p
        assert eq.float().mean().item() >= 0.999
        hit = eq & (id_k >= 0)
        torch.testing.assert_close(t_k[hit], t_p[hit], atol=1e-4, rtol=1e-4)


def _check_rgbd(cfg, state, img):
    """K5 on packed ``state`` into ``rgbd_buffers`` through ``out=``,
    against the plain renderer at the JAX kernel's bar; one launch."""
    w = state.step.shape[-1]
    out = ops_rgbd.rgbd_buffers(cfg, w, img, img, state.step.device)
    n0 = ops_rgbd.RGBD.launches
    rgba, depth = ops_rgbd.render_rgbd_packed_fast(cfg, state, img, img,
                                                   out=out)
    assert ops_rgbd.RGBD.launches == n0 + 1
    assert rgba.data_ptr() == out[0].data_ptr()
    assert depth.data_ptr() == out[1].data_ptr()
    rgb_k, d_k = ops_rgbd.to_reference_layout(cfg, rgba, depth, img, img)
    rgb_p, d_p = plain_rgbd.render_rgbd_packed(cfg, state, img, img)
    torch.cuda.synchronize()
    torch.testing.assert_close(d_k, d_p, atol=1e-3, rtol=1e-4)
    same = (rgb_k == rgb_p).all(-1)
    assert same.float().mean().item() >= 0.995
    sky = d_p[..., 0] == 0
    assert bool((same | ~sky).all())


@pytest.mark.parametrize("kw", [FULL, CLASSIC], ids=["2v2", "3v2"])
def test_raycast_and_rgbd_kernels_ragged(cuda, kw):
    """K1 and K5 at 1,001 worlds (a ragged last block of 8 worlds), at
    bench.py's 2v2 (R = 184 rays a world) and headless.py's 3v2
    (R = 230), on an init state and after a level-8 reset (a ramp,
    locked boxes)."""
    cfg, ps = _state(cuda, kw, 1001, 100)
    env = PackedEnv(cfg, device=cuda)
    ps8, _ = env.step(ps, torch.zeros((cfg.max_agents, 5, 1001),
                                      dtype=torch.int32, device=cuda),
                      torch.full((1001,), 8, dtype=torch.int32, device=cuda))
    for state in (ps, ps8):
        _check_raycast(cfg, state)
        _check_rgbd(cfg, state, 32)


def test_raycast_and_rgbd_kernels_without_walls(cuda):
    """A batch whose wall bound is 0: K5's wall loop and K1's wall list
    are empty."""
    cfg, ps = _state(cuda, FULL, 300, 100)
    s = ps.statics
    ps = ps.replace(statics=s.replace(
        wall_active=torch.zeros_like(s.wall_active)))
    assert int(ops_common.wall_bound(ps.statics.wall_active)) == 0
    _check_raycast(cfg, ps)
    _check_rgbd(cfg, ps, 32)


def test_raycast_and_rgbd_occupancy(cuda):
    """K1 runs 4 worlds a block and K5 8, with several blocks per SM."""
    for name, per_block in (("raycast", 4), ("rgbd", 8)):
        occ = ops_common.block_occupancy(name)
        assert occ["worlds_per_block"] == per_block
        assert occ["worlds_per_sm"] >= 16, (name, occ)


def test_megastep_occupancy(cuda):
    """The warp-per-world kernels launch with several worlds resident per
    SM."""
    occ = ops_step.megastep_occupancy()
    assert occ["worlds_per_block"] == 4
    for name in ("megastep", "physics", "fused"):
        assert occ[f"{name}_worlds_per_sm"] >= 8, occ


def test_wrappers_check_inputs(cuda):
    cfg, ps = _state(cuda, REDUCED, 128, 0)
    st = obs_mod.world_first(ps)
    o, d, m, e = [torch.movedim(x, 0, -1).contiguous()
                  for x in obs_mod.action_ray_queries(cfg, st)]
    with pytest.raises(ValueError, match="dtype"):
        ops_rays.raycast_batch_packed(cfg, ps, o, d, m, e.long())
    with pytest.raises(ValueError, match="contiguous"):
        ops_rays.raycast_batch_packed(cfg, ps, o, d.transpose(0, 1)
                                      .contiguous().transpose(0, 1), m, e)
    acts = torch.zeros((cfg.max_agents, 5, 128), dtype=torch.int64,
                       device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ops_step.megastep_packed(cfg, ps, acts)


def test_env_main_path_uses_both_kernels(cuda):
    """init, a full reset at the episode end and a compact reset, all
    finite, through both kernels."""
    cfg = EnvConfig(num_worlds=512, **FULL, sim_flags=FLAGS,
                    reset_budget=128)
    env = PackedEnv(cfg, device=cuda)
    r0, m0 = ops_rays.RAYCAST.launches, ops_step.MEGASTEP.launches
    ps, res = env.init()
    ps = ps.replace(step=torch.full_like(ps.step, 237))
    g = torch.Generator(device=cuda).manual_seed(1)
    na = cfg.max_agents
    for i in range(5):
        acts = torch.cat([
            torch.randint(0, 5, (na, 3, 512), generator=g, device=cuda),
            torch.randint(0, 2, (na, 2, 512), generator=g, device=cuda)], 1)
        resets = torch.zeros(512, dtype=torch.int32, device=cuda)
        if i == 4:
            resets[::64] = 1
        ps, res = env.step(ps, acts, resets)
    torch.cuda.synchronize()
    assert env.reset_counts == {"full": 1, "compact": 1}
    assert ops_step.MEGASTEP.launches == m0 + 5
    assert ops_rays.RAYCAST.launches == r0 + 6
    for t in ps.leaves():
        if t.is_floating_point():
            assert bool((torch.isfinite(t) | (t == float("inf"))).all())
    for v in res.obs.values():
        assert bool(torch.isfinite(v.float()).all())


# K6 against the plain assembly on the card: every float within 1e-5
# absolute plus 1e-5 relative; integers and masks equal.
OBS_TOL = 1e-5
OBS_TEAMS = {"1v1": REDUCED, "2v2": FULL,
             "3v3": dict(min_hiders=3, max_hiders=3, min_seekers=3,
                         max_seekers=3)}


def _check_obs(got: dict, want: dict) -> float:
    """Leaf by leaf: names, dtypes, shapes; the largest float error."""
    assert list(got) == list(want)
    worst = 0.0
    for name, p in want.items():
        k = got[name]
        assert k.dtype == p.dtype and k.shape == p.shape, name
        if p.dtype != torch.float32 or "mask" in name:
            assert torch.equal(k, p), name
            continue
        torch.testing.assert_close(k, p, atol=OBS_TOL, rtol=OBS_TOL,
                                   msg=name)
        worst = max(worst, (k - p).abs().max().item() if p.numel() else 0.0)
    return worst


def _k6(cfg, ps, vis, lidar) -> dict:
    n0 = obs_mod.OBSERVATIONS.launches
    out = obs_mod.build_observations_packed(cfg, ps, vis, lidar)
    assert obs_mod.OBSERVATIONS.launches == n0 + 1
    return out


@pytest.mark.parametrize("w", [1, 33, 4097, 16384])
def test_observations_kernel_matches_plain(cuda, w):
    """bench_2v2 at full capacity, on the init state and after 3 steps of
    random actions."""
    cfg = EnvConfig(num_worlds=w, **FULL, sim_flags=FLAGS, rand_seed=w)
    env = PackedEnv(cfg, device=cuda)
    ps, _ = env.init()
    g = torch.Generator(device=cuda).manual_seed(w)
    worst = 0.0
    for i in range(4):
        sw = tp.standalone_sweep_packed(cfg, ps)
        got = _k6(cfg, ps, sw.vis_seen, sw.lidar)
        want = obs_mod.build_observations_plain(cfg, ps, sw.vis_seen,
                                                sw.lidar)
        worst = max(worst, _check_obs(got, want))
        acts = torch.cat([
            torch.randint(0, 5, (cfg.max_agents, 3, w), generator=g,
                          device=cuda),
            torch.randint(0, 2, (cfg.max_agents, 2, w), generator=g,
                          device=cuda)], 1)
        ps, _ = env.step(ps, acts)
    print(f"K6 vs plain at {w} worlds: max abs err {worst:.3g}")


@pytest.mark.parametrize("teams", list(OBS_TEAMS))
def test_observations_kernel_drawn_cases(cuda, teams):
    """Drawn inputs (testing.observation_case): inactive and grabbing
    agents, boxes and ramps locked by each team, fewer active boxes and
    ramps than the slots, a gimbal-locked world; 1v1 with 3 boxes and a
    ramp, 2v2 and 3v3 at full capacity; a ragged 1,001 worlds."""
    cfg, ps = _state(cuda, OBS_TEAMS[teams], 1001, 0)
    ps, vis, lidar = observation_case(cfg, ps, 11)
    worst = _check_obs(_k6(cfg, ps, vis, lidar),
                       obs_mod.build_observations_plain(cfg, ps, vis, lidar))
    print(f"K6 vs plain, drawn {teams}: max abs err {worst:.3g}")


def test_observations_kernel_reads_world_major_views(cuda):
    """World-major state and sweep as ``world_last`` views through
    ``build_observations_packed``: K6 reads the views through their
    strides."""
    cfg = EnvConfig(num_worlds=300, **CLASSIC, rand_seed=3)
    st, _ = HideAndSeekEnv(cfg, device=cuda).init()
    st, vis, lidar = observation_case(cfg, obs_mod.world_last(st), 12)
    st = unpack_state(st)
    vis, lidar = (torch.movedim(x, -1, 0).contiguous() for x in (vis, lidar))
    views = (obs_mod.world_last(st), torch.movedim(vis, 0, -1),
             torch.movedim(lidar, 0, -1))
    n0 = obs_mod.OBSERVATIONS.launches
    got = obs_mod.build_observations_packed(cfg, *views)
    assert obs_mod.OBSERVATIONS.launches == n0 + 1
    _check_obs(got, obs_mod.build_observations_plain(cfg, *views))


def test_observations_wrapper_checks_inputs(cuda):
    cfg, ps = _state(cuda, FULL, 64, 0)
    sw = tp.standalone_sweep_packed(cfg, ps)
    n0 = obs_mod.OBSERVATIONS.launches
    with pytest.raises(ValueError, match="on cpu"):
        obs_mod.build_observations_packed(cfg, ps, sw.vis_seen.cpu(),
                                          sw.lidar)
    with pytest.raises(ValueError, match="dtype"):
        obs_mod.build_observations_packed(cfg, ps, sw.vis_seen,
                                          sw.lidar.double())
    with pytest.raises(ValueError, match="shape"):
        obs_mod.build_observations_packed(cfg, ps, sw.vis_seen[:, 1:],
                                          sw.lidar)
    assert obs_mod.OBSERVATIONS.launches == n0


def test_env_step_assembles_through_k6(cuda):
    """One K6 launch a PackedEnv.step, the reset step's included, and no
    host read of index tables while assembling."""
    cfg = EnvConfig(num_worlds=256, **FULL, sim_flags=FLAGS)
    env = PackedEnv(cfg, device=cuda)
    ps, _ = env.init()
    ps = ps.replace(step=torch.full_like(ps.step, 237))
    acts = torch.zeros((cfg.max_agents, 5, 256), dtype=torch.int32,
                       device=cuda)
    n0 = obs_mod.OBSERVATIONS.launches
    with tracing.recording() as rec:
        for _ in range(4):
            ps, res = env.step(ps, acts)
    assert obs_mod.OBSERVATIONS.launches == n0 + 4
    assert env.reset_counts["full"] == 1
    names = [s.name for s in rec.take().spans]
    assert names.count("env.observations") == 4
    assert "host_read.obs_consts" not in names
    assert names.count("host_read.reset_trigger") == 4
    for v in res.obs.values():
        assert bool(torch.isfinite(v.float()).all())


# K7 against the plain generator on the card: every leaf equal bit for
# bit (floats compared as their words).
LEVEL_TEAMS = {"2v2": FULL, "3v3": dict(min_hiders=1, max_hiders=3,
                                        min_seekers=1, max_seekers=3)}


def _episodes(cfg, w, seed, cuda):
    ids = torch.arange(w, device=cuda)
    return draw_episode(cfg, episode_keys(prng.key(seed, cuda), ids,
                                          torch.zeros_like(ids)))


def _words(t):
    return t.view(torch.int32) if t.dtype in (torch.float32,
                                              torch.uint32) else t


def _assert_same_bits(got, want):
    for g, p in zip(got.leaves(), want.leaves()):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.equal(_words(g), _words(p))


@pytest.mark.parametrize("teams", list(LEVEL_TEAMS))
@pytest.mark.parametrize("w", [1, 256, 16384])
def test_levelgen_kernel_matches_plain(cuda, teams, w):
    """K7's packed level 1 equals the plain generator's on every leaf,
    bit for bit, with per-world keys and (at 256 worlds) under
    UseFixedWorld; one launch a call, counting its worlds."""
    for fixed in (False, True) if w == 256 else (False,):
        flags = FLAGS | (SimFlags.UseFixedWorld if fixed else SimFlags(0))
        cfg = EnvConfig(num_worlds=w, **LEVEL_TEAMS[teams], sim_flags=flags)
        ep, lk, nh, ns, flip = _episodes(cfg, w, 5 + w, cuda)
        n0, w0 = ops_levelgen.LEVELGEN.launches, ops_levelgen.LEVELGEN.worlds
        got = levelgen.training_world_packed(cfg, lk, ep, nh, ns, flip)
        assert ops_levelgen.LEVELGEN.launches == n0 + 1
        assert ops_levelgen.LEVELGEN.worlds == w0 + w
        want = pack_state(levelgen.generate_training_world(
            cfg, lk, ep, nh, ns, flip))
        _assert_same_bits(got, want)


def test_levelgen_kernel_with_debug_levels(cuda):
    """A batch mixing level ids 0-9 (0 and 1 the arena, 2-8 the debug
    fixtures, 9 clipped to 8): K7's generate_world equals the plain one
    bit for bit."""
    cfg = EnvConfig(num_worlds=300, **FULL, sim_flags=FLAGS)
    ep, lk, nh, ns, flip = _episodes(cfg, 300, 6, cuda)
    lvl = torch.arange(300, device=cuda) % 10
    got = levelgen.generate_world(cfg, lk, ep, lvl, nh, ns, flip)
    _assert_same_bits(got, _plain_world(cfg, lk, ep, lvl, nh, ns, flip))
    assert int(got.agent_active[:, 5].sum()) == 1          # level 5


# The leaves a reset writes from the generator (the sweep's hits, the
# episode counter and the carried scores aside).
FRESH = ("bodies", "statics", "grab", "agent_type", "agent_active",
         "num_hiders", "num_seekers", "num_active_boxes", "num_active_ramps",
         "step", "ep_key", "level_key", "seekers_first")


def _plain_world(cfg, lk, ep, lvl, nh, ns, flip):
    """``levelgen.generate_world`` through the plain generator."""
    return levelgen.with_debug_levels(cfg, pack_state(
        levelgen.generate_training_world(cfg, lk, ep, nh, ns, flip)), lvl)


def _assert_fresh_levels(cfg, ps, worlds):
    """Packed worlds ``worlds`` of ``ps`` hold level 1 as the plain
    generator makes it from their keys and team draws."""
    sub = ps.map(on_bits(lambda x: x[..., worlds].contiguous()))
    want = _plain_world(cfg, sub.level_key, sub.ep_key,
                        torch.ones_like(worlds), sub.num_hiders,
                        sub.num_seekers, sub.seekers_first)
    for name in FRESH:
        g, p = getattr(sub, name), getattr(want, name)
        if hasattr(g, "leaves"):
            _assert_same_bits(g, p)
        else:
            assert torch.equal(_words(g), _words(p)), name


def test_env_resets_generate_through_k7(cuda):
    """init, a compact reset and a full reset through PackedEnv.step: one
    K7 launch each, over the worlds each generates; the reset worlds
    hold the plain generator's level for their keys; no host read of
    level generation's constants (a wait inside ``env.levelgen`` other
    than the two for the level ids)."""
    cfg = EnvConfig(num_worlds=512, **FULL, sim_flags=FLAGS,
                    reset_budget=128)
    env = PackedEnv(cfg, device=cuda)
    n0, w0 = ops_levelgen.LEVELGEN.launches, ops_levelgen.LEVELGEN.worlds
    ps, _ = env.init()
    acts = torch.zeros((cfg.max_agents, 5, 512), dtype=torch.int32,
                       device=cuda)
    resets = torch.zeros(512, dtype=torch.int32, device=cuda)
    resets[::64] = 1
    with tracing.recording() as rec:
        compact, _ = env.step(ps, acts, resets)
        ps = compact.replace(
            step=torch.full_like(ps.step, cfg.episode_len - 1))
        ps, res = env.step(ps, acts)
    spans = rec.take().spans
    names = [s.name for s in spans]
    assert env.reset_counts == {"full": 1, "compact": 1}
    assert ops_levelgen.LEVELGEN.launches == n0 + 3
    assert ops_levelgen.LEVELGEN.worlds == w0 + 512 + 128 + 512
    _assert_fresh_levels(cfg, compact, torch.arange(0, 512, 64, device=cuda))
    _assert_fresh_levels(cfg, ps, torch.arange(512, device=cuda))
    assert names.count("env.levelgen") == 2
    assert "host_read.levelgen_consts" not in names
    # Inside level generation the host waits only for the level ids.
    assert sorted(s.name for s in spans if s.parent == "env.levelgen" and
                  s.name.startswith("host_read.")) == ["host_read.levels"] * 4
    for v in res.obs.values():
        assert bool(torch.isfinite(v.float()).all())


def test_classic_env_compact_reset_through_k7(cuda):
    """The classic env's compact reset regenerates its worlds through one
    K7 launch, and they hold the plain generator's level."""
    cfg = EnvConfig(num_worlds=512, **CLASSIC, reset_budget=128)
    env = HideAndSeekEnv(cfg, device=cuda)
    st, _ = env.init()
    n0 = ops_levelgen.LEVELGEN.launches
    acts = torch.zeros((512, cfg.max_agents, 5), dtype=torch.int32,
                       device=cuda)
    resets = torch.zeros(512, dtype=torch.int32, device=cuda)
    resets[3::64] = 1
    st, _ = env.step(st, acts, resets)
    assert env.reset_counts == {"full": 0, "compact": 1}
    assert ops_levelgen.LEVELGEN.launches == n0 + 1
    _assert_fresh_levels(cfg, obs_mod.world_last(st),
                         torch.arange(3, 512, 64, device=cuda))


def _pre_physics(cfg, ps, g):
    na, w = cfg.max_agents, ps.step.shape[0]
    dev = ps.step.device
    acts = torch.cat([torch.randint(0, 5, (na, 3, w), generator=g, device=dev),
                      torch.randint(0, 2, (na, 2, w), generator=g,
                                    device=dev)], 1).to(torch.int32)
    ext_f, ext_t = tp.movement_packed(cfg, ps, acts)
    ps = tp.action_system_packed(cfg, ps, acts, ps.act_hit_t, ps.act_hit_id)
    return ps, ext_f, ext_t


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
@pytest.mark.parametrize("entry", ["physics", "fused"])
@pytest.mark.parametrize("w", [1000, 1001])
def test_physics_and_fused_kernels_match_plain(cuda, kw, entry, w):
    """K2 and K3, three chained launches each from the kernel's previous
    output, at the JAX kernels' bars; 1001 worlds leave a ragged last
    block."""
    cfg, ps = _state(cuda, kw, w, 100)
    g = torch.Generator(device=cuda).manual_seed(2)
    counter = ops_physics.PHYSICS if entry == "physics" else ops_fused.FUSED
    n0 = counter.launches
    for _ in range(3):
        ps, ext_f, ext_t = _pre_physics(cfg, ps, g)
        if entry == "physics":
            bk = ops_physics.physics_packed(cfg, ps.bodies, ps.statics,
                                            ps.grab, ext_f, ext_t)
            bp = ops_physics.physics_plain(cfg, ps.bodies, ps.statics,
                                           ps.grab, ext_f, ext_t)
        else:
            bk, sk = ops_fused.fused_step_packed(cfg, ps, ext_f, ext_t)
            bp, sp = ops_fused.fused_step_plain(cfg, ps, ext_f, ext_t)
            assert (sk.vis_seen == sp.vis_seen).float().mean() >= 0.999
            assert (sk.act_id == sp.act_id).float().mean() >= 0.999
            lid = ((sk.lidar - sp.lidar).abs() < 1e-3).float().mean()
            assert lid >= 0.999
        torch.cuda.synchronize()
        for name, (tol, need) in KERNEL.items():
            a, b = getattr(bk, name), getattr(bp, name)
            assert ((a - b).abs() < tol).float().mean().item() >= need, name
        ps = ps.replace(bodies=bk)
    assert counter.launches == n0 + 3


def test_rgbd_kernel_matches_plain(cuda):
    """K5 against the plain renderer at the JAX kernel's bar, on level-1
    worlds and on debug level 8 (locked boxes, a ramp)."""
    cfg, ps = _state(cuda, FULL, 300, 100)
    env = PackedEnv(cfg, device=cuda)
    ps8, _ = env.step(ps, torch.zeros((cfg.max_agents, 5, 300),
                                      dtype=torch.int32, device=cuda),
                      torch.full((300,), 8, dtype=torch.int32, device=cuda))
    for state in (ps, ps8):
        n0 = ops_rgbd.RGBD.launches
        rgba, depth = ops_rgbd.render_rgbd_packed_fast(cfg, state, 32, 32)
        assert ops_rgbd.RGBD.launches == n0 + 1
        rgb_k, d_k = ops_rgbd.to_reference_layout(cfg, rgba, depth, 32, 32)
        rgb_p, d_p = plain_rgbd.render_rgbd_packed(cfg, state, 32, 32)
        torch.cuda.synchronize()
        torch.testing.assert_close(d_k, d_p, atol=1e-3, rtol=1e-4)
        same = (rgb_k == rgb_p).all(-1)
        assert same.float().mean().item() >= 0.995
        sky = d_p[..., 0] == 0
        assert bool((same | ~sky).all())


def test_rgbd_frames_mode_matches_packed_mode_at_16k(cuda):
    """K5's frames mode (``[W, A, 4, 64, 64]`` float32 in one launch)
    against its packed mode's output on the same state, unpacked and
    scaled in plain PyTorch (``ops.rgbd.to_frames`` of
    ``to_reference_layout``), bit for bit, at 16,384 2v2 worlds after 10
    steps of random actions; and the env with ``render_frames`` renders
    into one buffer, once a step."""
    w = 16384
    cfg = EnvConfig(num_worlds=w, **FULL, sim_flags=FLAGS, rand_seed=3,
                    render_frames=True)
    env = PackedEnv(cfg, device=cuda)
    ps, res = env.init()
    g = torch.Generator(device=cuda).manual_seed(1)
    n0 = ops_rgbd.RGBD_FRAMES.launches
    for _ in range(10):
        acts = torch.cat([
            torch.randint(0, 5, (4, 3, w), generator=g, device=cuda),
            torch.randint(0, 2, (4, 2, w), generator=g, device=cuda)], 1)
        ps, res = env.step(ps, acts.to(torch.int32))
    assert ops_rgbd.RGBD_FRAMES.launches == n0 + 10
    frames = res.obs["rgbd"]
    assert frames is env._frames and frames.shape == (w, 4, 4, 64, 64)
    rgba, depth = ops_rgbd.render_rgbd_packed_fast(cfg, ps)
    for lo in range(0, w, 2048):
        cut = slice(lo, lo + 2048)
        want = ops_rgbd.to_frames(*ops_rgbd.to_reference_layout(
            cfg, rgba[..., cut].contiguous(), depth[..., cut].contiguous()))
        assert torch.equal(frames[cut].view(torch.int32),
                           want.view(torch.int32))
    assert bool((frames[:, :, 3] > 0).any()) and float(frames.max()) <= 1.0


def test_classic_env_uses_fused_and_raycast(cuda):
    """The classic env at 512 worlds: init, the full reset at the episode
    end and a compact reset, through K3 and K1; the unfused env through
    K2; rgbd through K5."""
    cfg = EnvConfig(num_worlds=512, min_hiders=3, max_hiders=3,
                    min_seekers=2, max_seekers=2, reset_budget=128)
    g = torch.Generator(device=cuda).manual_seed(4)
    for fused in (True, False):
        env = HideAndSeekEnv(cfg, device=cuda, fused=fused)
        counts = (ops_fused.FUSED.launches, ops_physics.PHYSICS.launches,
                  ops_rays.RAYCAST.launches)
        st, res = env.init()
        st = st.replace(step=torch.full_like(st.step, 237))
        for i in range(4):
            acts = torch.cat([
                torch.randint(0, 11, (512, 5, 3), generator=g, device=cuda),
                torch.randint(0, 2, (512, 5, 2), generator=g, device=cuda)],
                -1)
            resets = torch.zeros(512, dtype=torch.int32, device=cuda)
            if i == 3:
                resets[::64] = 5
            st, res = env.step(st, acts, resets)
        torch.cuda.synchronize()
        assert env.reset_counts == {"full": 1, "compact": 1}
        fused_n = ops_fused.FUSED.launches - counts[0]
        phys_n = ops_physics.PHYSICS.launches - counts[1]
        assert (fused_n, phys_n) == ((4, 0) if fused else (0, 4))
        ray_n = ops_rays.RAYCAST.launches - counts[2]
        assert ray_n == (6 if fused else 14)
        for t in st.leaves():
            if t.is_floating_point():
                assert bool((torch.isfinite(t) | (t == float("inf"))).all())
        for v in res.obs.values():
            assert bool(torch.isfinite(v.float()).all())
    n0 = ops_rgbd.RGBD.launches
    rgb, depth = env.rgbd(st, 16, 16)
    assert ops_rgbd.RGBD.launches == n0 + 1
    assert rgb.shape == (512, 5, 16, 16, 4) and depth.shape[-1] == 1


def _policy_inputs(cuda, w):
    """A 4-policy flagship ensemble on the card with seeded weights and
    statistics, and the packed env's observations of ``w`` 2v2 worlds."""
    gen = torch.Generator().manual_seed(0)
    pol = make_policy(num_policies=4, device=cuda, key=prng.key(0))
    params = dict(pol.actor_critic.named_parameters())
    with torch.no_grad():
        for p in params.values():
            p.add_(0.02 * torch.randn(p.shape, generator=gen).to(cuda))
    cfg = EnvConfig(num_worlds=w, **FULL, rand_seed=3,
                    sim_flags=SimFlags.UseFixedWorld |
                    SimFlags.ZeroAgentVelocity)
    norm = pol.obs_preprocess
    obs = {k: v.flatten(0, 1) for k, v in
           norm.prep(PackedEnv(cfg, device=cuda).init()[1].obs).items()}
    stats = norm.init_state(obs)
    for k in stats.mean:
        stats.mean[k] += 0.1
    return cfg, pol, params, obs, stats


def test_ensemble_forward_matches_cpu(cuda):
    """4 policies, 1,024 agents: logits, values and LSTM states on the
    card within 1e-4 of the same modules on the CPU, float32 without
    TF32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, pol, params, obs, stats = _policy_inputs(cuda, 256)
    n = obs["self_data"].shape[0]
    g = torch.Generator().manual_seed(1)
    rnn = tuple(tuple(0.5 * torch.randn(1, n, 256, generator=g)
                      for _ in range(2)) for _ in range(2))
    assign = torch.randint(0, 4, (n,), generator=g)
    norm = pol.obs_preprocess
    with torch.no_grad():
        card = apply_ensemble(
            pol, params, tuple(tuple(x.to(cuda) for x in e) for e in rnn),
            norm.normalize(stats, obs), assign.to(cuda), 4)
        cpu_pol = make_policy(num_policies=4, device="cpu")
        cpu = apply_ensemble(
            cpu_pol, {k: v.cpu() for k, v in params.items()}, rnn,
            norm.normalize(stats.to("cpu"),
                           {k: v.cpu() for k, v in obs.items()}),
            assign, 4)
    torch.testing.assert_close(card[0].cpu(), cpu[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(card[1].cpu(), cpu[1], atol=1e-4, rtol=0)
    for a, b in zip([x for e in card[2] for x in e],
                    [x for e in cpu[2] for x in e]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("w,num_train", [(16384, None), (4096, 2)],
                         ids=["serve_w16k", "train_w4k"])
def test_routed_ensemble_matches_naive(cuda, w, num_train):
    """The flagship's 4 policies on the packed env's 2v2 observations:
    ``infer.py``'s round robin at 16,384 worlds (65,536 agents), and the
    rollout's 2 + 2 split at 4,096 worlds (each world's train side one of
    policies 0-1 by a fair coin, the other side one of 2-3, hiders or
    seekers by a coin). The routed forward equals the naive one (every
    policy on every agent, then the pick) within 1e-5 of its largest
    magnitude, with one ``host_read.route`` a call, no more peak memory,
    and at most 6 % of its rows padding."""
    from marl_hideandseek_torch.testing import naive_ensemble
    from marl_hideandseek_torch.train.rollout import ROUTE

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, pol, params, obs, stats = _policy_inputs(cuda, w)
    n = obs["self_data"].shape[0]
    g = torch.Generator(device=cuda).manual_seed(1)
    rnn = tuple(tuple(0.5 * torch.randn(1, n, 256, generator=g, device=cuda)
                      for _ in range(2)) for _ in range(2))
    is_h = torch.arange(4, device=cuda) < 2
    if num_train is None:
        wi = torch.arange(w, device=cuda)
        t0, t1 = wi % 4, (wi + 1 + wi // 4) % 4
    else:
        coin = lambda lo: lo + torch.randint(0, 2, (w,), generator=g,
                                             device=cuda)
        train, past = coin(0), coin(2)
        flip = torch.randint(0, 2, (w,), generator=g, device=cuda).bool()
        t0, t1 = torch.where(flip, train, past), torch.where(flip, past, train)
    assign = torch.where(is_h, t0[:, None], t1[:, None]).reshape(-1).to(
        torch.int32)
    nobs = pol.obs_preprocess.normalize(stats, obs)
    args = (pol, params, rnn, nobs, assign, 4, num_train)
    peak = {}
    with torch.no_grad():
        for name, fn in (("naive", naive_ensemble),
                         ("routed", apply_ensemble)):
            fn(*args)                                    # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = ROUTE.read()
            with tracing.recording() as rec:
                out = fn(*args)
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() - base
            reads = [s for s in rec.take().spans
                     if s.name == "host_read.route"]
            if name == "naive":
                want = out
                assert not reads
            else:
                got = out
                calls, needed, run = (a - b for a, b in
                                      zip(ROUTE.read(), before))
                assert len(reads) == 1 and (calls, needed) == (1, n)
                assert n <= run <= 1.06 * n
    assert peak["routed"] <= peak["naive"]

    def rel(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    assert rel(got[0], want[0]) <= 1e-5 and rel(got[1], want[1]) <= 1e-5
    for a, b in zip([x for e in got[2] for x in e],
                    [x for e in want[2] for x in e]):
        assert rel(a, b) <= 1e-5


def test_routed_impala_cnn_forward_matches_unrouted(cuda, monkeypatch):
    """The ``impala_cnn`` policy's 4 policies (2 train + 2 past, the
    rollout's split) on 256 2v2 worlds' rendered frames after 20 steps:
    the routed forward (each policy's ~256 agents through its own torso)
    against the naive one (every policy's torso on all 1,024 frames,
    then the pick) within 1e-5 of the largest magnitude: float32 without
    TF32, where cuDNN may pick other algorithms for the two batch sizes.
    cuDNN is allowed TF32 here, PyTorch's default: the torso's
    convolutions turn it off themselves."""
    from marl_hideandseek_torch.testing import naive_ensemble

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    from marl_hideandseek_torch.train.rollout import initial_core_inputs

    w = 256
    cfg = EnvConfig(num_worlds=w, **FULL, sim_flags=FLAGS, rand_seed=3,
                    render_frames=True)
    env = PackedEnv(cfg, device=cuda)
    ps, res = env.init()
    g = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(20):
        acts = torch.cat([
            torch.randint(0, 5, (4, 3, w), generator=g, device=cuda),
            torch.randint(0, 2, (4, 2, w), generator=g, device=cuda)], 1)
        ps, res = env.step(ps, acts.to(torch.int32))
    pol = make_policy(backbone="impala_cnn", num_policies=4, device=cuda,
                      key=prng.key(3))
    params = dict(pol.actor_critic.named_parameters())
    norm = pol.obs_preprocess
    obs = {k: v.flatten(0, 1) for k, v in norm.prep(res.obs).items()}
    n = obs["self_data"].shape[0]
    obs.update(initial_core_inputs(n, (5, 5, 5, 2, 2), cuda))
    obs["prev_reward"] += 0.5
    stats = norm.update_state(norm.init_state(obs), obs)
    nobs = norm.normalize(stats, obs)
    assert torch.equal(nobs["rgbd"], obs["rgbd"])
    rnn = ((0.5 * torch.randn(1, n, 256, generator=g, device=cuda),
            0.5 * torch.randn(1, n, 256, generator=g, device=cuda)),)
    coin = lambda lo: lo + torch.randint(0, 2, (w,), generator=g,
                                         device=cuda)
    train, past = coin(0), coin(2)
    flip = torch.randint(0, 2, (w,), generator=g, device=cuda).bool()
    t0, t1 = torch.where(flip, train, past), torch.where(flip, past, train)
    is_h = torch.arange(4, device=cuda) < 2
    assign = torch.where(is_h, t0[:, None], t1[:, None]).reshape(-1).to(
        torch.int32)
    with torch.no_grad():
        want = naive_ensemble(pol, params, rnn, nobs, assign, 4, 2)
        got = apply_ensemble(pol, params, rnn, nobs, assign, 4, 2)

    def rel(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    assert rel(got[0], want[0]) <= 1e-5 and rel(got[1], want[1]) <= 1e-5
    for a, b in zip([x for e in got[2] for x in e],
                    [x for e in want[2] for x in e]):
        assert rel(a, b) <= 1e-5


def test_openai_hns_forward_matches_plain_reference(cuda):
    """The ``openai_hns`` policy (2 policies, seeded weights with every
    constant leaf moved) on 1,024 3v3 worlds of the packed env, after 20
    steps of random force actions: logits, values and LSTM states within
    1e-5 (relative to the largest, at least 1) of the plain reference
    (``plainref/openai_hns.py``) on the same card, float32 without TF32
    (the two sum their products in other orders; TF32 moves them ~1e-3)."""
    from torch.func import functional_call

    from plainref import openai_hns as ref

    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(0)
    pol = make_policy(backbone="openai_hns", num_policies=2, device=cuda,
                      key=prng.key(3))
    params = dict(pol.actor_critic.named_parameters())
    with torch.no_grad():
        for p in params.values():
            if bool((p == 0).all()) or bool((p == 1).all()):
                p.add_(0.05 * torch.randn(p.shape, generator=gen).to(cuda))
    cfg = EnvConfig(num_worlds=1024, min_hiders=3, max_hiders=3,
                    min_seekers=3, max_seekers=3,
                    sim_flags=SimFlags.RandomFlipTeams, rand_seed=3)
    env = PackedEnv(cfg, device=cuda)
    ps, res = env.init()
    g = torch.Generator(device=cuda).manual_seed(1)
    for _ in range(20):
        acts = torch.cat([
            torch.randint(0, 11, (6, 3, 1024), generator=g, device=cuda),
            torch.randint(0, 2, (6, 2, 1024), generator=g, device=cuda)], 1)
        ps, res = env.step(ps, acts.to(torch.int32))
    norm = pol.obs_preprocess
    obs = {k: v.flatten(0, 1) for k, v in norm.prep(res.obs).items()}
    stats = norm.update_state(norm.init_state(obs), obs)
    nobs = norm.normalize(stats, obs)
    vis = torch.cat([nobs[k] for k in ("vis_agents_mask", "vis_boxes_mask",
                                       "vis_ramps_mask")], -1)
    assert bool((vis.sum(-1) == 0).any()) and bool((vis == 0).any())
    n = nobs["self_data"].shape[0]
    rnn = tuple(tuple(0.5 * torch.randn(1, n, 256, generator=gen).to(cuda)
                      for _ in range(2)) for _ in range(2))
    with torch.no_grad():
        got = pol.actor_critic(rnn, nobs)
        want = functional_call(ref.ActorCritic(2, cuda), params, (rnn, nobs),
                               strict=True)

    def rel(a, b):
        return float((a - b).abs().max() / max(1.0, float(b.abs().max())))

    assert rel(got[0].logits, want[0].logits) <= 1e-5
    assert rel(got[1]["value"], want[1]["value"]) <= 1e-5
    for a, b in zip([x for e in got[2] for x in e],
                    [x for e in want[2] for x in e]):
        assert rel(a, b) <= 1e-5


def test_inference_loop_uses_megastep_and_raycast(cuda):
    """``run_inference`` at 512 worlds over a 20-step episode and 5 more
    steps: K4 on every step, K1 on the reset, finite outputs, every
    world's episode finished and its agents' LSTM state cleared."""
    cfg, pol, params, _, stats = _policy_inputs(cuda, 512)
    env = PackedEnv(cfg.replace(episode_len=20), device=cuda)
    k4, k1 = ops_step.MEGASTEP.launches, ops_rays.RAYCAST.launches
    seen = []

    def on_step(d):
        if d["step"] == 19:
            seen.append([x.abs().max().item() for e in d["rnn_next"]
                         for x in e])
        assert bool(torch.isfinite(d["logits"]).all())

    out = run_inference(env, pol, params, stats, 25, iter_cb=on_step,
                        timing=True)
    assert ops_step.MEGASTEP.launches - k4 == 25
    assert ops_rays.RAYCAST.launches - k1 >= 4        # init + the reset
    assert out["episodes_finished"] == 512
    assert seen == [[0.0] * 4]
    assert out["forward_ms"] > 0 and out["env_ms"] > 0


def test_record_path_at_16_worlds(cuda, tmp_path):
    """infer.sh's 16 worlds recorded (``infer.RecordLog``) over an
    episode end: K4 every step, K1 on the init and the reset, each frame
    the checkpoint record of its step's state, and K4 and K1 on the last
    state against their plain versions."""
    from marl_hideandseek_torch.env.checkpoint import (
        pack_checkpoints,
        save_checkpoints,
    )
    from marl_hideandseek_torch.infer import RecordLog
    from marl_hideandseek_torch.utils.ckptlog import CkptLogReader

    cfg, pol, params, _, stats = _policy_inputs(cuda, 16)
    env = PackedEnv(cfg.replace(episode_len=20), device=cuda)
    log = RecordLog(env.cfg, str(tmp_path / "record.bin"))
    states = []

    def cb(i, ps):
        log(i, ps)
        states.append(ps)

    k4, k1 = ops_step.MEGASTEP.launches, ops_rays.RAYCAST.launches
    run_inference(env, pol, params, stats, 25, state_cb=cb)
    log.close()
    assert ops_step.MEGASTEP.launches - k4 == 25
    assert ops_rays.RAYCAST.launches - k1 >= 4        # init + the reset
    with CkptLogReader(str(tmp_path / "record.bin")) as r:
        assert (r.num_frames, r.num_worlds, r.frame_bytes) == (25, 16, 1044)
        for i, ps in enumerate(states):
            want = pack_checkpoints(save_checkpoints(env.cfg,
                                                     unpack_state(ps)))
            assert (r.read(i) == want.cpu().numpy()).all(), i
    ps = states[-1]
    _check_raycast(env.cfg, ps)
    g = torch.Generator(device=cuda).manual_seed(4)
    acts = torch.cat([torch.randint(0, 5, (4, 3, 16), generator=g,
                                    device=cuda),
                      torch.randint(0, 2, (4, 2, 16), generator=g,
                                    device=cuda)], 1).to(torch.int32)
    rk = ops_step.megastep_packed(env.cfg, ps, acts)
    rp = ops_step.megastep_plain(env.cfg, ps, acts)
    for name, (tol, need) in KERNEL.items():
        a, b = getattr(rk[0].bodies, name), getattr(rp[0].bodies, name)
        assert ((a - b).abs() < tol).float().mean().item() >= need, name
    assert torch.equal(rk[2], rp[2]) and torch.equal(rk[3], rp[3])


def test_viewer_at_one_world(cuda, tmp_path):
    """The viewer's command script with the follow camera at one world:
    K3 every step, K1 on the init, the load and the resets, K5 every
    frame; then K3, K1 and K5 on its state against their plain
    versions."""
    from marl_hideandseek_torch import viewer
    from marl_hideandseek_torch.types import pack_state

    n0 = (ops_fused.FUSED.launches, ops_rays.RAYCAST.launches,
          ops_rgbd.RGBD.launches)
    v = viewer.Viewer(str(tmp_path), follow=True, device=cuda)
    v.run("w w g l m d d n f q 3 r x".split())
    n = (ops_fused.FUSED.launches - n0[0], ops_rays.RAYCAST.launches - n0[1],
         ops_rgbd.RGBD.launches - n0[2])
    assert n[0] == 9 and n[1] >= 2 * 4 and n[2] == 8
    assert len(v.written) == 12
    ps = pack_state(v.state)
    _check_raycast(v.cfg, ps)
    _check_rgbd(v.cfg, ps, 64)
    g = torch.Generator(device=cuda).manual_seed(5)
    ps, ext_f, ext_t = _pre_physics(v.cfg, ps, g)
    bk, sk = ops_fused.fused_step_packed(v.cfg, ps, ext_f, ext_t)
    bp, sp = ops_fused.fused_step_plain(v.cfg, ps, ext_f, ext_t)
    assert torch.equal(sk.vis_seen, sp.vis_seen)
    assert torch.equal(sk.act_id, sp.act_id)
    for name, (tol, need) in KERNEL.items():
        a, b = getattr(bk, name), getattr(bp, name)
        assert ((a - b).abs() < tol).float().mean().item() >= need, name


@pytest.fixture(scope="module")
def ppo_setup(cuda):
    """The first update's ``ppo_update`` at train.sh's configuration (PBT
    2 + 2, grouped, the flagship policy at full width) on 64 worlds, from
    a rollout on the card, float32 without TF32: ``run(dev, cfg, obs)``
    runs it on either side, and the CPU's result with its rounding bars
    (``testing.rounding_bars``), and the CPU's gradient norms of each
    step."""
    from marl_hideandseek_torch import testing
    from marl_hideandseek_torch.models.actor_critic import tree_map
    from marl_hideandseek_torch.train import __main__ as cli
    from marl_hideandseek_torch.train import init_training, ppo
    from marl_hideandseek_torch.train.rollout import collect_rollout

    assert not torch.backends.cuda.matmul.allow_tf32
    env, cfg, pol = cli.build(cli.parse_args([
        "--ckpt-dir", "-", "--tb-dir", "-", "--run-name", "-",
        "--num-worlds", "64", "--num-updates", "1",
        "--pbt-ensemble-size", "2", "--pbt-past-policies", "2",
        "--num-hiders", "2", "--num-seekers", "2", "--device", "cuda"]))
    mgr = init_training(cuda, cfg, env, pol)
    st = mgr.state
    _, buf, _ = collect_rollout(cfg, env, pol, mgr.all_params(),
                                st.obs_stats, st.rollout, st.value_stats)
    stats = pol.obs_preprocess.update_state(st.obs_stats, {
        k: v.flatten(0, 2) for k, v in buf.obs.items()})
    cpu_pol = make_policy(device="cpu")

    def run(dev, cfg, obs=None):
        to = lambda x: x.to(dev)
        opt = ppo.AdamState(mu=tree_map(to, st.opt_states.mu),
                            nu=tree_map(to, st.opt_states.nu),
                            count=to(st.opt_states.count))
        fields = {**vars(buf), **({} if obs is None else {"obs": obs})}
        b = type(buf)(**{k: tree_map(to, v) for k, v in fields.items()})
        return ppo.ppo_update(cfg, pol if dev.type == "cuda" else cpu_pol,
                              tree_map(to, st.params), opt, stats.to(dev),
                              tree_map(to, st.value_stats),
                              tree_map(to, st.hyper_params), b,
                              st.key.to(dev))

    cpu = torch.device("cpu")
    obs = {k: v.cpu() for k, v in buf.obs.items()}
    norms = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ppo, "clipped_adam",
                   lambda *a: testing.grad_norms(*a, seen=norms))
        want, bars = testing.rounding_bars(lambda o: run(cpu, cfg, o), obs)
    return dict(run=run, cfg=cfg, obs=obs, want=want, bars=bars,
                norms=norms[:cfg.algo.num_epochs], start=st.params,
                lr=float(st.hyper_params["lr"].max()))


def _compare(setup, got, want=None, bars=None):
    from marl_hideandseek_torch import testing

    return testing.compare_updates(
        got, want or setup["want"], setup["start"], bars or setup["bars"],
        setup["lr"], setup["cfg"].algo.num_epochs)


def test_ppo_update_matches_cpu(cuda, ppo_setup):
    """The card's update against the CPU's at the update's rounding bars
    (``testing.rounding_bars``: per moment leaf, max(1e-4 for mu or 2e-4
    for nu, 4 x the CPU's own spread under one-ulp moves of the
    observations), a share of the leaf's largest moment); parameters
    within 1e-6 on all but 0.1 % of each leaf and within 2 x lr x epochs
    on all; losses within 1e-5 relative; counts and dropped fractions
    equal."""
    s = ppo_setup
    cmp = _compare(s, s["run"](cuda, s["cfg"]))
    widened = {k: v for k, v in s["bars"].items()
               if k[0] in ("mu", "nu") and v > {"mu": 1e-4, "nu": 2e-4}[k[0]]}
    print(f"worst over bar {cmp['worst']}; {len(widened)} moment leaves "
          f"with a bar over the fixed one, largest "
          f"{max(widened.values(), default=0.0):.4g}; gradient norms "
          f"{[n.tolist() for n in s['norms']]}")
    assert cmp["violations"] == [], cmp


@pytest.mark.parametrize("fault", ["bias_correction", "clip", "zero_leaf"])
def test_ppo_update_bars_catch_planted_faults(cuda, ppo_setup, fault,
                                              monkeypatch):
    """The same comparison fails when the card's Adam carries a planted
    fault: the bias correction dropped; the gradient clip skipped (where
    the recipe's clip at 5 does not bite, the clip is planted at half the
    smallest gradient norm of the update on both sides, with the CPU's
    result and bars recomputed); the update of the leaf with the most
    lenient mu bar zeroed."""
    import dataclasses

    from marl_hideandseek_torch import testing
    from marl_hideandseek_torch.train import ppo

    s = ppo_setup
    cfg, want, bars = s["cfg"], None, None
    norm = float(torch.stack(s["norms"]).min())
    if fault == "clip" and norm < cfg.algo.max_grad_norm:
        cfg = dataclasses.replace(cfg, algo=dataclasses.replace(
            cfg.algo, max_grad_norm=0.5 * norm))
        want, bars = testing.rounding_bars(
            lambda o: s["run"](torch.device("cpu"), cfg, o), s["obs"])
    leaf = max(s["want"][1].mu, key=lambda k: s["bars"][("mu", k)])
    monkeypatch.setattr(ppo, "clipped_adam",
                        testing.planted_fault(fault, leaf))
    cmp = _compare(s, s["run"](cuda, cfg), want, bars)
    print(f"{fault} (clip at {cfg.algo.max_grad_norm:.4g}, zeroed {leaf}): "
          f"{len(cmp['violations'])} violations, worst over bar "
          f"{cmp['worst']}")
    assert cmp["violations"], cmp

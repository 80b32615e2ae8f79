"""PyTorch port: the CUDA kernels' sources (csrc/raycast.cu,
csrc/megastep.cu with its megastep, physics and fused entries,
csrc/rgbd.cu, csrc/threefry.cu, csrc/observations.cu, csrc/levelgen.cu)
compiled as plain host C++
(-DMHS_HOST_BUILD, the same per-ray / per-world / per-pixel functions in
a loop) and held to the plain PyTorch versions on CPU tensors. This
checks the kernels' arithmetic and their argument layout without a card;
the launch itself is checked on the card (tests/test_torch_gpu.py,
chip_smoke.py). Needs a host C++ compiler.

Four sources run a warp per world (rgbd.cu: per world and agent), and
observations.cu a block per tile of worlds; as host C++ their lane
helpers (csrc/lanes.cuh) run the lanes of each phase, the block's load,
compute and store items and the block's warps one after another. Each source is built twice, in forward and in reverse order
(-DMHS_LANES_REVERSE): a phase that reads what another lane writes in the
same phase - a missing barrier - gives different results in the two
orders. The cases also run at a world count that is not a multiple of
the worlds per block (the ragged last block). csrc/threefry.cu is held
bit for bit to JAX's own threefry2x32."""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch import prng
from marl_hideandseek_torch.env import levelgen
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env.episode import draw_episode
from marl_hideandseek_torch.env.rng import episode_keys
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.env import packed as tp
from marl_hideandseek_torch.ops import build, rays as ops_rays
from marl_hideandseek_torch.ops import fused as ops_fused
from marl_hideandseek_torch.ops import levelgen as ops_levelgen
from marl_hideandseek_torch.ops import physics as ops_physics
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.ops import common as ops_common
from marl_hideandseek_torch.ops import step as ops_step
from marl_hideandseek_torch.ops import threefry as ops_threefry
from marl_hideandseek_torch.testing import observation_case
from marl_hideandseek_torch.types import (
    body_slot_ranges,
    pack_state,
    unpack_state,
)

REDUCED = dict(num_worlds=96, min_hiders=1, max_hiders=1, min_seekers=1,
               max_seekers=1, max_boxes=3, max_ramps=1)
FULL = dict(num_worlds=24, min_hiders=2, max_hiders=2, min_seekers=2,
            max_seekers=2)
FLAGS = SimFlags.ZeroAgentVelocity | SimFlags.RandomFlipTeams
# Same op order on both sides; what is left is the order of a few sums
# (the one-hot contractions) and of libm's sqrt/rsqrt: a few ulp.
TIGHT = dict(pos=1e-5, quat=1e-5, vel=1e-3, omega=2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One PyTorch thread for this file's small CPU tensors: the suite
    runs it on one of several busy workers, where PyTorch's intra-op
    threads would spin against the others' (each case takes 10-50x its
    time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' sources")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for key, name, defs in [
            (f"{name}{suffix}", name, defs)
            for name in ("raycast", "megastep", "rgbd", "observations",
                         "levelgen")
            for suffix, defs in (("", []),
                                 ("-reverse", ["-DMHS_LANES_REVERSE"]))]:
        so = out / f"{key}.so"
        subprocess.run(
            [cxx, "-x", "c++", "-std=c++17", "-DMHS_HOST_BUILD", *defs,
             "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I",
             str(build.CSRC), "-o", str(so), str(build.CSRC / f"{name}.cu")],
            check=True, capture_output=True, timeout=300)
        libs[key] = ctypes.CDLL(str(so))
    return libs


# Lane order of the host builds, and the world count: the configuration's
# (a multiple of the 4 worlds per block of megastep.cu and of the 8 of
# raycast.cu and rgbd.cu) or one less.
LANES = ["forward", "reverse"]
WORLDS = ["aligned", "ragged"]


def _lib(libs, name, lanes):
    return libs[name if lanes == "forward" else f"{name}-reverse"]


def _megastep_lib(libs, lanes):
    return _lib(libs, "megastep", lanes)


def _sized(kw, worlds):
    return kw if worlds == "aligned" else dict(
        kw, num_worlds=kw["num_worlds"] - 1)


def _env_state(kw, step):
    cfg = EnvConfig(**kw, sim_flags=FLAGS, rand_seed=3)
    ps, _ = PackedEnv(cfg, device="cpu").init()
    return cfg, ps.replace(step=torch.full_like(ps.step, step))


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
@pytest.mark.parametrize("worlds", WORLDS)
@pytest.mark.parametrize("lanes", LANES)
def test_raycast_source_matches_plain(host_libs, kw, worlds, lanes):
    cfg, ps = _env_state(_sized(kw, worlds), 0)
    st = obs_mod.world_first(ps)
    for q in (obs_mod.obs_ray_queries(cfg, st),
              obs_mod.action_ray_queries(cfg, st)):
        o, d, m, e = [torch.movedim(x, 0, -1).contiguous() for x in q]
        t_p, id_p = ops_rays.raycast_packed_plain(cfg, ps, o, d, m, e)
        t_h = torch.empty_like(t_p)
        id_h = torch.empty_like(id_p)
        b, s = ps.bodies, ps.statics
        (_, _), (rl, rh), _ = body_slot_ranges(cfg)
        args = [b.pos, b.quat, b.half_ext, b.active, s.wall_pos,
                s.wall_half_ext, s.wall_active, s.plane_point,
                s.plane_normal, s.plane_active, o, d, m, e, t_h, id_h]
        rc = _lib(host_libs, "raycast", lanes).mhs_raycast_host(
            *[ctypes.c_void_p(a.data_ptr()) for a in args],
            cfg.num_worlds, m.shape[0], cfg.num_dyn_bodies, rl, rh,
            s.wall_active.shape[0], s.plane_active.shape[0])
        assert rc == 0
        assert torch.equal(id_h, id_p)
        assert torch.equal(t_h, t_p)


def _host_megastep(lib, cfg, ps, acts):
    ptrs, ip, fp, out, _keep = ops_step.megastep_buffers(cfg, ps, acts)
    pa, ia, fa = ops_common.c_arrays(ptrs, ip, fp)
    assert lib.mhs_megastep_host(pa, len(ptrs), ia, len(ip), fa,
                                 len(fp)) == 0
    return ops_step.megastep_results(ps, out)


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
@pytest.mark.parametrize("step0", [100, 239])
@pytest.mark.parametrize("worlds", WORLDS)
@pytest.mark.parametrize("lanes", LANES)
def test_megastep_source_matches_plain(host_libs, kw, step0, worlds, lanes):
    """Three steps, each from the same input on both sides."""
    cfg, ps = _env_state(_sized(kw, worlds), step0)
    lib = _megastep_lib(host_libs, lanes)
    g = torch.Generator().manual_seed(step0)
    na, w = cfg.max_agents, cfg.num_worlds
    for _ in range(3):
        acts = torch.cat([torch.randint(0, 5, (na, 3, w), generator=g),
                          torch.randint(0, 2, (na, 2, w), generator=g)],
                         1).to(torch.int32)
        rp = ops_step.megastep_plain(cfg, ps, acts)
        rh = _host_megastep(lib, cfg, ps, acts)
        for name, tol in TIGHT.items():
            torch.testing.assert_close(getattr(rh[0].bodies, name),
                                       getattr(rp[0].bodies, name),
                                       atol=tol, rtol=1e-5, msg=name)
        for name in ("locked", "owner"):
            assert torch.equal(getattr(rh[0].bodies, name),
                               getattr(rp[0].bodies, name)), name
        for name in ("target", "r2", "rel_q", "sep"):
            a, b = getattr(rh[0].grab, name), getattr(rp[0].grab, name)
            assert torch.equal(a, b), name
        assert torch.equal(rh[1].vis_seen, rp[1].vis_seen)
        assert torch.equal(rh[1].act_id, rp[1].act_id)
        assert torch.equal(rh[1].rew_seen, rp[1].rew_seen)
        torch.testing.assert_close(rh[1].lidar, rp[1].lidar, atol=1e-4,
                                   rtol=1e-5)
        for a, b in zip(rh[2:], rp[2:]):
            assert torch.equal(a, b)
        assert torch.equal(rh[0].running_scores, rp[0].running_scores)
        assert torch.equal(rh[0].finished_scores, rp[0].finished_scores)
        ps = rp[0].replace(step=rp[0].step + 1, act_hit_t=rp[1].act_t,
                           act_hit_id=rp[1].act_id)


def _pre_physics(cfg, ps, g):
    """Random actions through movement and grab/lock: the K2/K3 inputs."""
    na, w = cfg.max_agents, cfg.num_worlds
    acts = torch.cat([torch.randint(0, 5, (na, 3, w), generator=g),
                      torch.randint(0, 2, (na, 2, w), generator=g)],
                     1).to(torch.int32)
    ext_f, ext_t = tp.movement_packed(cfg, ps, acts)
    ps = tp.action_system_packed(cfg, ps, acts, ps.act_hit_t, ps.act_hit_id)
    return ps, ext_f, ext_t


def _host_call(fn, ptrs, ip, fp):
    pa, ia, fa = ops_common.c_arrays(ptrs, ip, fp)
    assert fn(pa, len(ptrs), ia, len(ip), fa, len(fp)) == 0


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
@pytest.mark.parametrize("entry", ["physics", "fused"])
@pytest.mark.parametrize("worlds", WORLDS)
@pytest.mark.parametrize("lanes", LANES)
def test_physics_and_fused_sources_match_plain(host_libs, kw, entry, worlds,
                                               lanes):
    """K2 (physics) and K3 (physics + sweep): three steps, each from the
    same input on both sides, on a moving state."""
    cfg, ps = _env_state(_sized(kw, worlds), 100)
    g = torch.Generator().manual_seed(7)
    lib = _megastep_lib(host_libs, lanes)
    for _ in range(3):
        ps, ext_f, ext_t = _pre_physics(cfg, ps, g)
        if entry == "physics":
            bp = ops_physics.physics_plain(cfg, ps.bodies, ps.statics,
                                           ps.grab, ext_f, ext_t)
            ptrs, ip, fp, out = ops_physics.physics_buffers(
                cfg, ps.bodies, ps.statics, ps.grab, ext_f, ext_t)
            _host_call(lib.mhs_physics_host, ptrs, ip, fp)
        else:
            bp, sp = ops_fused.fused_step_plain(cfg, ps, ext_f, ext_t)
            ptrs, ip, fp, out, sh, _keep = ops_fused.fused_buffers(
                cfg, ps, ext_f, ext_t)
            _host_call(lib.mhs_fused_host, ptrs, ip, fp)
            assert torch.equal(sh.vis_seen, sp.vis_seen)
            assert torch.equal(sh.act_id, sp.act_id)
            assert torch.equal(sh.rew_seen, sp.rew_seen)
            torch.testing.assert_close(sh.act_t, sp.act_t, atol=1e-5,
                                       rtol=1e-5)
            torch.testing.assert_close(sh.lidar, sp.lidar, atol=1e-4,
                                       rtol=1e-5)
        for name, tol in TIGHT.items():
            torch.testing.assert_close(out[name], getattr(bp, name),
                                       atol=tol, rtol=1e-5, msg=name)
        ps = ps.replace(bodies=bp)


def _host_rgbd(lib, cfg, state, img):
    """K5's host build on packed ``state``: (rgba, depth)."""
    w = state.step.shape[-1]
    out = ops_rgbd.rgbd_buffers(cfg, w, img, img, "cpu")
    ptrs, ip, fp, (rgba_h, depth_h), _keep = ops_rgbd.rgbd_args(
        cfg, state, img, img, 90.0, 200.0, out)
    _host_call(lib.mhs_rgbd_host, ptrs, ip, fp)
    return rgba_h, depth_h


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
@pytest.mark.parametrize("worlds", WORLDS)
@pytest.mark.parametrize("lanes", LANES)
def test_rgbd_source_matches_plain(host_libs, kw, worlds, lanes):
    """K5 at 16x16 on level-1 worlds and on debug level 8 (a ramp, locked
    and unlocked boxes): the same op order on both sides, so equal
    colours and depths but for a last-bit difference of a root."""
    cfg, ps = _env_state(_sized(dict(kw, num_worlds=16), worlds), 100)
    w = cfg.num_worlds
    env = PackedEnv(cfg, device="cpu")
    ps8, _ = env.step(ps, torch.zeros((cfg.max_agents, 5, w),
                                      dtype=torch.int32),
                      torch.full((w,), 8, dtype=torch.int32))
    for state in (ps, ps8):
        rgba_p, depth_p = ops_rgbd.render_rgbd_packed_fast(cfg, state, 16, 16)
        rgba_h, depth_h = _host_rgbd(_lib(host_libs, "rgbd", lanes), cfg,
                                     state, 16)
        same = (rgba_h.view(torch.int32) == rgba_p.view(torch.int32))
        assert same.float().mean().item() >= 0.999
        torch.testing.assert_close(depth_h, depth_p, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("worlds", WORLDS)
@pytest.mark.parametrize("lanes", LANES)
def test_rgbd_frames_mode_matches_packed_mode(host_libs, worlds, lanes):
    """K5's frames mode (the policy's ``[W, A, 4, H, W]`` float32 store)
    against its packed mode's output on the same state, unpacked and
    scaled in plain PyTorch (``to_frames`` of ``to_reference_layout``):
    equal bit for bit, both from the same host build, at 20x20 (partial
    pixel tiles) on level-1 worlds after 100 steps."""
    cfg, ps = _env_state(_sized(dict(FULL, num_worlds=16), worlds), 100)
    w, img = cfg.num_worlds, 20
    lib = _lib(host_libs, "rgbd", lanes)
    rgba, depth = _host_rgbd(lib, cfg, ps, img)
    frames = torch.full((w, cfg.max_agents, 4, img, img), float("nan"))
    ptrs, ip, fp, (out,), _keep = ops_rgbd.rgbd_args(
        cfg, ps, img, img, 90.0, 200.0, frames=frames)
    _host_call(lib.mhs_rgbd_frames_host, ptrs, ip, fp)
    want = ops_rgbd.to_frames(*ops_rgbd.to_reference_layout(
        cfg, rgba, depth, img, img), 200.0)
    assert out is frames
    assert torch.equal(frames.view(torch.int32), want.view(torch.int32))
    assert 0.0 < float(frames[:, :, 3].max()) <= 1.0


def _cull_scene(cfg, ps):
    """Agent 0 of every world looks along +y from its eye e, with: box 0
    wholly behind e; box 1 straddling the eye plane, partly in view; box
    2 beside e, whose bounding sphere holds e; box 3 near, straight ahead,
    and box 4 behind it, hidden; box 5 far beyond the walls. Agent 1 is
    upside down and agent 2 pitched by 30 degrees, so that their
    cameras' axes are not a yaw of the world's."""
    (box_lo, _), _, (agent_lo, _) = body_slot_ranges(cfg)
    b = ps.bodies
    pos, quat, half = b.pos.clone(), b.quat.clone(), b.half_ext.clone()
    active = b.active.clone()
    eye = pos[agent_lo] + torch.tensor([0.0, 0.0, 0.5])[:, None]
    quat[agent_lo] = torch.tensor([1.0, 0.0, 0.0, 0.0])[:, None]
    quat[agent_lo + 1] = torch.tensor([0.0, 0.0, 1.0, 0.0])[:, None]
    quat[agent_lo + 2] = torch.tensor(
        [math.cos(math.pi / 12), math.sin(math.pi / 12), 0.0, 0.0])[:, None]
    boxes = [((0.0, -3.0, 0.0), 0.5), ((-0.8, 0.0, 0.0), 0.5),
             ((0.9, 0.5, 0.0), 0.6), ((0.0, 1.5, 0.0), 0.3),
             ((0.0, 6.0, 0.0), 0.3), ((0.0, 150.0, 0.0), 0.5)]
    for i, (off, h) in enumerate(boxes):
        pos[box_lo + i] = eye + torch.tensor(off)[:, None]
        quat[box_lo + i] = torch.tensor([1.0, 0.0, 0.0, 0.0])[:, None]
        half[box_lo + i] = h
        active[box_lo + i] = True
    return ps.replace(bodies=b.replace(pos=pos, quat=quat, half_ext=half,
                                       active=active))


@pytest.mark.parametrize("lanes", LANES)
def test_rgbd_source_culls_exactly(host_libs, lanes):
    """K5's culls on a scene edited by hand (``_cull_scene``), at 20x20
    (partial 16 x 8 pixel tiles at the right and bottom edges) over 9
    worlds (a ragged second block): colours and depths equal the
    plain renderer's (depths but for a last-bit difference of a root, as
    in ``test_rgbd_source_matches_plain``), and both culls dropped
    work."""
    cfg, ps = _env_state(dict(FULL, num_worlds=9), 0)
    ps = _cull_scene(cfg, ps)
    lib = _lib(host_libs, "rgbd", lanes)
    counts = (ctypes.c_longlong * 2)()
    lib.mhs_rgbd_host_culls(counts)
    rgba_p, depth_p = ops_rgbd.render_rgbd_packed_fast(cfg, ps, 20, 20)
    rgba_h, depth_h = _host_rgbd(lib, cfg, ps, 20)
    lib.mhs_rgbd_host_culls(counts)
    assert torch.equal(rgba_h.view(torch.int32), rgba_p.view(torch.int32))
    torch.testing.assert_close(depth_h, depth_p, atol=1e-5, rtol=1e-6)
    assert counts[0] > 0 and counts[1] > 0, list(counts)


# Team sizes of the observation cases: 1v1 with 3 boxes and a ramp, 2v2
# and 3v3 at full capacity; 16 worlds (two blocks of 8) or one less.
OBS_TEAMS = {
    "1v1": dict(num_worlds=16, min_hiders=1, max_hiders=1, min_seekers=1,
                max_seekers=1, max_boxes=3, max_ramps=1),
    "2v2": dict(FULL, num_worlds=16),
    "3v3": dict(num_worlds=16, min_hiders=3, max_hiders=3, min_seekers=3,
                max_seekers=3),
}


@pytest.fixture(scope="module")
def obs_states():
    """Each team size's packed init state and a drawn case of it."""
    out = {}
    for name, kw in OBS_TEAMS.items():
        cfg, ps = _env_state(kw, 0)
        out[name] = (cfg, ps, observation_case(cfg, ps, len(out)))
    return out


def _host_observations(lib, cfg, ps, vis, lidar):
    ptrs, ip = obs_mod.observation_params(cfg, ps, vis, lidar)
    out = obs_mod.observation_outputs(cfg, ip[0], "cpu")
    _host_call(lib.mhs_observations_host,
               ptrs + [t.data_ptr() for t in out.values()], ip, [])
    return out


def _sweep(cfg, ps):
    sw = tp.standalone_sweep_packed(cfg, ps)
    return sw.vis_seen, sw.lidar


@pytest.mark.parametrize("teams", list(OBS_TEAMS))
@pytest.mark.parametrize("case", ["init", "drawn"])
@pytest.mark.parametrize("layout", ["packed", "world_major"])
@pytest.mark.parametrize("worlds", WORLDS)
@pytest.mark.parametrize("lanes", LANES)
def test_observations_source_matches_plain(host_libs, obs_states, teams,
                                           case, layout, worlds, lanes):
    """K6's eleven leaves against the plain assembly's: the same names,
    dtypes and shapes; integer leaves and masks equal; every float within
    rounding of the math library's atan2f / asinf (host libm against
    PyTorch's CPU kernels). The packed layout, and ``world_last`` views
    of the same values held world-major, read through their strides."""
    cfg, ps, drawn = obs_states[teams]
    ins = (ps, *_sweep(cfg, ps)) if case == "init" else drawn
    if worlds == "ragged":
        w = cfg.num_worlds - 1
        ins = tuple(x.map(lambda t: t[..., :w]) if hasattr(x, "map")
                    else x[..., :w] for x in ins)
    want = obs_mod.build_observations_plain(cfg, *ins)
    st, vis, lidar = ins
    if layout == "world_major":
        st = obs_mod.world_last(unpack_state(st))
        vis = torch.movedim(torch.movedim(vis, -1, 0).contiguous(), 0, -1)
        lidar = torch.movedim(torch.movedim(lidar, -1, 0).contiguous(), 0,
                              -1)
        assert st.bodies.pos.stride()[-1] != 1 and vis.stride()[-1] != 1
    got = _host_observations(_lib(host_libs, "observations", lanes), cfg,
                             st, vis, lidar)
    assert list(got) == list(want)
    for name, p in want.items():
        h = got[name]
        assert h.dtype == p.dtype and h.shape == p.shape, name
        if p.dtype != torch.float32 or "mask" in name or name == "self_lidar":
            assert torch.equal(h, p), name
        else:
            torch.testing.assert_close(h, p, atol=1e-5, rtol=1e-5, msg=name)


# Level generation (K7): 64 keys of 2v2 and 3v3 worlds, each drawn
# per world or under UseFixedWorld (every world the zero key's).
LEVEL_TEAMS = {"2v2": 2, "3v3": 3}
LEVEL_WORLDS = 64


def _level_inputs(teams, fixed, seed=11):
    """(cfg, draws, episode draws)."""
    flags = SimFlags.RandomFlipTeams | (
        SimFlags.UseFixedWorld if fixed else SimFlags(0))
    n = LEVEL_TEAMS[teams]
    cfg = EnvConfig(num_worlds=LEVEL_WORLDS, min_hiders=1, max_hiders=n,
                    min_seekers=1, max_seekers=n, sim_flags=flags)
    ids = torch.arange(LEVEL_WORLDS)
    ep = draw_episode(cfg, episode_keys(prng.key(seed), ids,
                                        torch.zeros_like(ids)))
    level_key = ep[1]
    keys = (torch.zeros((1, 2), dtype=torch.uint32) if fixed else
            prng.u32(prng.i32(level_key).T.contiguous()))
    return cfg, levelgen.level_draws(cfg, keys), ep


@pytest.fixture(scope="module")
def level_cases():
    """Each case's inputs and the plain generator's packed state."""
    out = {}
    for t in LEVEL_TEAMS:
        for f in (False, True):
            cfg, draws, ep = _level_inputs(t, f)
            out[(t, f)] = (cfg, draws, ep, pack_state(
                levelgen.generate_training_world(cfg, ep[1], ep[0],
                                                 *ep[2:])))
    return out


def _host_levelgen(lib, cfg, draws, ep, w):
    # Contiguous copies, kept alive through the call.
    ep_key, level_key, nh, ns, flip = (
        prng.u32(prng.i32(x[..., :w]).contiguous()) if x.dtype == torch.uint32
        else x[..., :w].contiguous() for x in ep)
    if not cfg.use_fixed_world:
        draws = levelgen.LevelDraws(
            draws.counts[:w], draws.pose_u[:w],
            type(draws.walls)(draws.walls.bits[:w], draws.walls.u[:w]))
    out = ops_levelgen.level1_outputs(cfg, w, "cpu")
    ptrs, ip = ops_levelgen.levelgen_params(cfg, draws, level_key, ep_key,
                                            nh, ns, flip, out)
    _host_call(lib.mhs_levelgen_host, ptrs, ip, [])
    return out


@pytest.mark.parametrize("teams", list(LEVEL_TEAMS))
@pytest.mark.parametrize("fixed", [False, True], ids=["keyed", "fixed"])
@pytest.mark.parametrize("worlds", WORLDS)
@pytest.mark.parametrize("lanes", LANES)
def test_levelgen_source_matches_plain(host_libs, level_cases, teams, fixed,
                                       worlds, lanes):
    """K7's 37 leaves against the plain generator's packed state, over 64
    keys (63 ragged: not a multiple of the 8 worlds per block): the same
    dtypes and shapes; integer, key and bool leaves equal; floats within
    1e-5 (the host's libm sinf / cosf against PyTorch's CPU kernels move
    a yaw quaternion by an ulp; on the card both reach the same CUDA
    functions and the leaves are equal bit for bit)."""
    cfg, draws, ep, want = level_cases[(teams, fixed)]
    w = LEVEL_WORLDS - (worlds == "ragged")
    got = _host_levelgen(_lib(host_libs, "levelgen", lanes), cfg, draws, ep,
                         w)
    for g, p in zip(got.leaves(), want.leaves()):
        p = p[..., :w]
        assert g.dtype == p.dtype and g.shape == p.shape
        if p.dtype == torch.float32:
            torch.testing.assert_close(g, p, atol=1e-5, rtol=0)
        elif p.dtype == torch.uint32:
            assert torch.equal(g.view(torch.int32), p.view(torch.int32))
        else:
            assert torch.equal(g, p)


@pytest.mark.parametrize("teams", list(LEVEL_TEAMS))
def test_levelgen_outputs_follow_the_schema(teams):
    """K7's outputs are ``empty_world``'s packed leaves with W worlds, the
    same shapes and dtypes in the same order, as contiguous views of one
    allocation, each starting on a 16-byte boundary, none overlapping."""
    cfg = _level_inputs(teams, False)[0]
    w = 37
    got = ops_levelgen.level1_outputs(cfg, w, "cpu").leaves()
    want = pack_state(levelgen.empty_world(cfg, w, "cpu")).leaves()
    assert len(got) == len(want) == 37
    base = got[0].untyped_storage().data_ptr()
    end = base
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and g.shape == p.shape and g.is_contiguous()
        assert g.untyped_storage().data_ptr() == base
        assert g.data_ptr() % 16 == 0 and g.data_ptr() >= end
        end = g.data_ptr() + g.numel() * g.element_size()


def _bad_levelgen_args(case):
    """K7's arguments for 8 2v2 worlds with one of them made wrong."""
    cfg, draws, ep = _level_inputs("2v2", False)
    ep = [x[..., :8].contiguous() for x in ep]
    wd = draws.walls
    draws = levelgen.LevelDraws(draws.counts[:8], draws.pose_u[:8],
                                type(wd)(wd.bits[:8], wd.u[:8]))
    if case == "level_key_dtype":
        ep[1] = prng.i32(ep[1])
    elif case == "team_dtype":
        ep[2] = ep[2].to(torch.int32)
    elif case == "draws_worlds":
        draws = draws._replace(pose_u=draws.pose_u[:4])
    elif case == "wall_bits_shape":
        draws = draws._replace(walls=type(wd)(wd.bits[:8, :-1], wd.u[:8]))
    elif case == "not_contiguous":
        draws = draws._replace(counts=draws.counts.transpose(1, 2))
    return cfg, draws, ep


@pytest.mark.parametrize("case", ["level_key_dtype", "team_dtype",
                                  "draws_worlds", "wall_bits_shape",
                                  "not_contiguous", "cpu_tensors"])
def test_levelgen_wrapper_checks_inputs(case):
    """K7's wrapper refuses what the kernel does not take, before any
    launch: a wrong dtype, shape or layout of a draw or an episode input,
    and CPU tensors (the plain generator's)."""
    cfg, draws, ep = _bad_levelgen_args(case)
    out = ops_levelgen.level1_outputs(cfg, 8, "cpu")
    launches = ops_levelgen.LEVELGEN.launches
    with pytest.raises(ValueError):
        if case == "cpu_tensors":
            ops_levelgen.training_world_kernel(cfg, draws, ep[1], ep[0],
                                               *ep[2:])
        else:
            ops_levelgen.levelgen_params(cfg, draws, ep[1], ep[0], *ep[2:],
                                         out)
    assert ops_levelgen.LEVELGEN.launches == launches


@pytest.fixture(scope="module")
def threefry_host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' sources")
    so = tmp_path_factory.mktemp("host_threefry") / "threefry.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-DMHS_HOST_BUILD", "-O1",
         "-shared", "-fPIC", "-o", str(so), str(build.CSRC / "threefry.cu")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fn = lib.mhs_threefry_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _host_threefry(fn, keys, counters, n, mode):
    k = keys.shape[0]
    out = torch.empty((k, n, 2) if mode == ops_threefry.PAIRS else (k, n),
                      dtype=torch.float32 if mode == ops_threefry.UNIFORM
                      else torch.uint32)
    stride = 0 if counters is None or counters.shape[0] == 1 else 2 * n
    assert fn(keys.data_ptr(), None if counters is None else
              counters.data_ptr(), stride, k, n, mode, out.data_ptr()) == 0
    return out


def _u32(x):
    return x.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("ragged", [False, True])
def test_threefry_source_matches_jax(threefry_host, ragged):
    """csrc/threefry.cu as host C++ against JAX's ``threefry_2x32`` bit
    for bit: both words on batched keys with per-key counters (JAX's
    hash of (key, (c0, c1)) is ``threefry_2x32(key, [c0, c1])``), and the
    bits and uniform modes on the iota counters against ``jax.random``;
    at a ragged count too."""
    import jax
    import jax.numpy as jnp
    from jax._src import prng as jprng

    k, n = (13, 37) if ragged else (16, 64)
    rng = np.random.default_rng(k)
    kw = rng.integers(0, 2 ** 32, (k, 2), dtype=np.uint64).astype(np.uint32)
    cw = rng.integers(0, 2 ** 32, (k, n, 2), dtype=np.uint64).astype(
        np.uint32)
    keys = torch.from_numpy(kw.view(np.int32).copy()).view(torch.uint32)
    ctr = torch.from_numpy(cw.view(np.int32).copy()).view(torch.uint32)
    got = _u32(_host_threefry(threefry_host, keys, ctr, n,
                              ops_threefry.PAIRS))
    want = jax.vmap(jax.vmap(lambda kk, c: jprng.threefry_2x32(kk, c),
                             in_axes=(None, 0)))(jnp.asarray(kw),
                                                 jnp.asarray(cw))
    np.testing.assert_array_equal(got, np.asarray(want))
    jk = jnp.asarray(kw)
    np.testing.assert_array_equal(
        _u32(_host_threefry(threefry_host, keys, None, n,
                            ops_threefry.BITS)),
        np.asarray(jax.vmap(lambda kk: jax.random.bits(kk, (n,)))(jk)))
    np.testing.assert_array_equal(
        _host_threefry(threefry_host, keys, None, n,
                       ops_threefry.UNIFORM).numpy().view(np.uint32),
        np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (n,)))(
            jk)).view(np.uint32))
    # The plain version is the same function.
    for mode in (ops_threefry.PAIRS, ops_threefry.BITS):
        np.testing.assert_array_equal(
            _u32(ops_threefry.threefry(keys, ctr if mode ==
                                       ops_threefry.PAIRS else None, n,
                                       mode)),
            _u32(_host_threefry(threefry_host, keys, ctr if mode ==
                                ops_threefry.PAIRS else None, n, mode)))

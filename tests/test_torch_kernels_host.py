"""PyTorch port: the CUDA kernels' sources (csrc/raycast.cu,
csrc/megastep.cu with its megastep, physics and fused entries,
csrc/rgbd.cu) compiled as plain host C++ (-DMHS_HOST_BUILD, the same
per-ray / per-world / per-pixel functions in a loop) and held to the
plain PyTorch versions on CPU tensors. This checks the kernels' arithmetic and their
argument layout without a card; the launch itself is checked on the card
(tests/test_torch_gpu.py, chip_smoke.py). Needs a host C++ compiler.

megastep.cu runs a warp per world; as host C++ its lane helpers run the
lanes of each phase one after another. It is built twice, with the lanes
in forward and in reverse order (-DMHS_LANES_REVERSE): a phase that reads
what another lane writes in the same phase - a missing barrier - gives
different results in the two orders. Its cases also run at a world count
that is not a multiple of the worlds per block (the ragged last block)."""

import ctypes
import shutil
import subprocess

import pytest
import torch

from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.env import packed as tp
from marl_hideandseek_torch.ops import build, rays as ops_rays
from marl_hideandseek_torch.ops import fused as ops_fused
from marl_hideandseek_torch.ops import physics as ops_physics
from marl_hideandseek_torch.ops import rgbd as ops_rgbd
from marl_hideandseek_torch.ops import common as ops_common
from marl_hideandseek_torch.ops import step as ops_step
from marl_hideandseek_torch.types import body_slot_ranges

REDUCED = dict(num_worlds=96, min_hiders=1, max_hiders=1, min_seekers=1,
               max_seekers=1, max_boxes=3, max_ramps=1)
FULL = dict(num_worlds=24, min_hiders=2, max_hiders=2, min_seekers=2,
            max_seekers=2)
FLAGS = SimFlags.ZeroAgentVelocity | SimFlags.RandomFlipTeams
# Same op order on both sides; what is left is the order of a few sums
# (the one-hot contractions) and of libm's sqrt/rsqrt: a few ulp.
TIGHT = dict(pos=1e-5, quat=1e-5, vel=1e-3, omega=2e-3)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' sources")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for key, name, defs in (("raycast", "raycast", []),
                            ("megastep", "megastep", []),
                            ("megastep-reverse", "megastep",
                             ["-DMHS_LANES_REVERSE"]),
                            ("rgbd", "rgbd", [])):
        so = out / f"{key}.so"
        subprocess.run(
            [cxx, "-x", "c++", "-std=c++17", "-DMHS_HOST_BUILD", *defs,
             "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I",
             str(build.CSRC), "-o", str(so), str(build.CSRC / f"{name}.cu")],
            check=True, capture_output=True, timeout=300)
        libs[key] = ctypes.CDLL(str(so))
    return libs


# Lane order of the megastep.cu host build, and the world count: the
# configuration's (a multiple of the 4 worlds per block) or one less.
LANES = ["forward", "reverse"]
WORLDS = ["aligned", "ragged"]


def _megastep_lib(libs, lanes):
    return libs["megastep" if lanes == "forward" else "megastep-reverse"]


def _sized(kw, worlds):
    return kw if worlds == "aligned" else dict(
        kw, num_worlds=kw["num_worlds"] - 1)


def _env_state(kw, step):
    cfg = EnvConfig(**kw, sim_flags=FLAGS, rand_seed=3)
    ps, _ = PackedEnv(cfg, device="cpu").init()
    return cfg, ps.replace(step=torch.full_like(ps.step, step))


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
def test_raycast_source_matches_plain(host_libs, kw):
    cfg, ps = _env_state(kw, 0)
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
        rc = host_libs["raycast"].mhs_raycast_host(
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


@pytest.mark.parametrize("kw", [REDUCED, FULL], ids=["reduced", "full"])
def test_rgbd_source_matches_plain(host_libs, kw):
    """K5 at 16x16 on level-1 worlds and on debug level 8 (a ramp, locked
    and unlocked boxes): the same op order on both sides, so equal
    colours and depths but for a last-bit difference of a root."""
    cfg, ps = _env_state(dict(kw, num_worlds=12), 100)
    env = PackedEnv(cfg, device="cpu")
    ps8, _ = env.step(ps, torch.zeros((cfg.max_agents, 5, 12),
                                      dtype=torch.int32),
                      torch.full((12,), 8, dtype=torch.int32))
    for state in (ps, ps8):
        rgba_p, depth_p = ops_rgbd.render_rgbd_packed_fast(cfg, state, 16, 16)
        out = ops_rgbd.rgbd_buffers(cfg, 12, 16, 16, "cpu")
        ptrs, ip, fp, (rgba_h, depth_h), _keep = ops_rgbd.rgbd_args(
            cfg, state, 16, 16, 90.0, 200.0, out)
        _host_call(host_libs["rgbd"].mhs_rgbd_host, ptrs, ip, fp)
        same = (rgba_h.view(torch.int32) == rgba_p.view(torch.int32))
        assert same.float().mean().item() >= 0.999
        torch.testing.assert_close(depth_h, depth_p, atol=1e-5, rtol=1e-6)

"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on CUDA tensors, and the env's main path through both kernels.

Marked ``gpu``; every test skips here without a card (decided in the
``cuda`` fixture). On a machine with one:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest`` leaves out tests/conftest.py's JAX setup, which these
tests do not need and which a machine without JAX cannot import.)
"""

import pytest
import torch

from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.ops import rays as ops_rays
from marl_hideandseek_torch.ops import step as ops_step

pytestmark = pytest.mark.gpu

FLAGS = SimFlags.ZeroAgentVelocity | SimFlags.RandomFlipTeams
REDUCED = dict(min_hiders=1, max_hiders=1, min_seekers=1, max_seekers=1,
               max_boxes=3, max_ramps=1)
FULL = dict(min_hiders=2, max_hiders=2, min_seekers=2, max_seekers=2)
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
@pytest.mark.parametrize("w", [200, 2048])
def test_megastep_kernel_matches_plain(cuda, kw, w):
    cfg, ps = _state(cuda, kw, w, 100)
    g = torch.Generator(device=cuda).manual_seed(0)
    na = cfg.max_agents
    for _ in range(3):
        acts = torch.cat([
            torch.randint(0, 5, (na, 3, w), generator=g, device=cuda),
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

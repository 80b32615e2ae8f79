"""PyTorch port: the observation assembly's dispatch and K6's declared
interface, on the CPU. ``build_observations_packed`` runs the plain
version on CPU tensors and K6 (``csrc/observations.cu``) on CUDA tensors;
K6's arithmetic is held to the plain version by its host build
(tests/test_torch_kernels_host.py) and on the card
(tests/test_torch_gpu.py)."""

import pytest
import torch

from marl_hideandseek_torch.config import (
    MAX_AGENTS,
    NUM_LIDAR_SAMPLES,
    EnvConfig,
    SimFlags,
)
from marl_hideandseek_torch.env import observations as obs_mod
from marl_hideandseek_torch.env import packed as tp

TEAMS = {
    "1v1": dict(min_hiders=1, max_hiders=1, min_seekers=1, max_seekers=1,
                max_boxes=3, max_ramps=1),
    "2v2": dict(min_hiders=2, max_hiders=2, min_seekers=2, max_seekers=2),
    "3v3": dict(min_hiders=3, max_hiders=3, min_seekers=3, max_seekers=3),
}


def _case(teams, w=4):
    cfg = EnvConfig(num_worlds=w, **TEAMS[teams],
                    sim_flags=SimFlags.ZeroAgentVelocity, rand_seed=2)
    ps, _ = tp.PackedEnv(cfg, device="cpu").init()
    sw = tp.standalone_sweep_packed(cfg, ps)
    return cfg, ps, sw.vis_seen, sw.lidar


@pytest.mark.parametrize("teams", list(TEAMS))
def test_kernel_leaf_table_matches_plain(teams):
    """The leaves K6 allocates and writes (names in order, [W, A, F]
    widths, dtypes) are the plain version's: self 13, lidar 30, 14 a
    visible agent or ramp and 17 a box."""
    cfg, ps, vis, lidar = _case(teams)
    plain = obs_mod.build_observations_plain(cfg, ps, vis, lidar)
    table = obs_mod.observation_leaves(cfg)
    assert [(n, (4, cfg.max_agents, f), dt) for n, f, dt in table] == [
        (n, tuple(v.shape), v.dtype) for n, v in plain.items()]
    widths = {n: f for n, f, _ in table}
    assert widths["self_data"] == 13
    assert widths["self_lidar"] == NUM_LIDAR_SAMPLES == 30
    assert widths["agent_data"] == (MAX_AGENTS - 1) * 14
    assert widths["box_data"] == cfg.max_boxes * 17
    assert widths["ramp_data"] == cfg.max_ramps * 14


def test_cpu_tensors_take_the_plain_version():
    cfg, ps, vis, lidar = _case("2v2")
    n0 = obs_mod.OBSERVATIONS.launches
    got = obs_mod.build_observations_packed(cfg, ps, vis, lidar)
    want = obs_mod.build_observations_plain(cfg, ps, vis, lidar)
    assert obs_mod.OBSERVATIONS.launches == n0
    for name, v in want.items():
        assert torch.equal(got[name], v), name


def test_kernel_request_off_the_card_raises():
    """A state on any device but the CPU goes to K6, which refuses what
    is not on a CUDA device: no fall-back to the plain version, no
    launch."""
    cfg, ps, vis, lidar = _case("2v2")
    n0 = obs_mod.OBSERVATIONS.launches
    with pytest.raises(ValueError, match="CUDA"):
        obs_mod.build_observations_kernel(cfg, ps, vis, lidar)
    meta = ps.map(lambda t: t.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        obs_mod.build_observations_packed(cfg, meta, vis.to("meta"),
                                          lidar.to("meta"))
    assert obs_mod.OBSERVATIONS.launches == n0


def test_kernel_params_check_inputs():
    """Each input is checked for device, dtype and shape before a launch,
    and passed with its strides: the packed layout with world stride 1,
    world-major views with their own."""
    cfg, ps, vis, lidar = _case("2v2", w=6)
    with pytest.raises(ValueError, match="dtype"):
        obs_mod.observation_params(cfg, ps, vis, lidar.double())
    with pytest.raises(ValueError, match="shape"):
        obs_mod.observation_params(cfg, ps, vis[:, 1:], lidar)
    with pytest.raises(ValueError, match="meta"):
        obs_mod.observation_params(cfg, ps, vis.to("meta"), lidar)
    with pytest.raises(ValueError, match="dtype"):
        obs_mod.observation_params(
            cfg, ps.replace(agent_active=ps.agent_active.to(torch.uint8)),
            vis, lidar)
    ptrs, ip = obs_mod.observation_params(cfg, ps, vis, lidar)
    n_in = len(obs_mod.observation_inputs(cfg, ps, vis, lidar))
    assert len(ptrs) == n_in and len(ip) == 5 + 3 * n_in
    assert ip[:5] == [6, cfg.max_boxes, cfg.max_ramps, cfg.max_agents,
                      cfg.num_prep_steps]
    nb = cfg.num_dyn_bodies
    assert ip[5:8] == [3 * 6, 6, 1]                     # pos [B, 3, W]
    wm = torch.movedim(torch.movedim(vis, -1, 0).contiguous(), 0, -1)
    _, ip_wm = obs_mod.observation_params(cfg, ps, wm, lidar)
    t = obs_mod.num_vis_targets(cfg)
    assert ip_wm[5 + 3 * 13:5 + 3 * 14] == [t, 1, cfg.max_agents * t]
    assert ip[5 + 3 * 10:5 + 3 * 11] == [0, 0, 1]       # num_active_boxes
    assert ip[5 + 3 * 5:5 + 3 * 6] == [6, 0, 1]         # locked [B, W]
    assert nb == cfg.max_boxes + cfg.max_ramps + cfg.max_agents


@pytest.mark.parametrize("teams", list(TEAMS))
@pytest.mark.parametrize("w", [1, 33])
def test_kernel_outputs_are_aligned_views_of_one_buffer(teams, w):
    """K6's leaves: the table's shapes and dtypes, contiguous, disjoint,
    one allocation, each starting on a 16-byte boundary (the kernel's
    bulk copies), whatever the world count."""
    cfg = EnvConfig(num_worlds=w, **TEAMS[teams])
    out = obs_mod.observation_outputs(cfg, w, "cpu")
    table = obs_mod.observation_leaves(cfg)
    assert [(n, (w, cfg.max_agents, f), dt) for n, f, dt in table] == [
        (n, tuple(v.shape), v.dtype) for n, v in out.items()]
    base = out["prep_counter"].untyped_storage().data_ptr()
    spans = []
    for v in out.values():
        assert v.is_contiguous()
        assert v.untyped_storage().data_ptr() == base
        assert (v.data_ptr() - base) % 16 == 0
        spans.append((v.data_ptr(), v.data_ptr() + 4 * v.numel()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))

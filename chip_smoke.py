"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels with nvcc (in parallel), holds each kernel
against its plain PyTorch version at the main path's shapes, then drives
the main path - ``PackedEnv.init`` and ``PackedEnv.step`` at bench.py's
configuration (16,384 worlds, 2 hiders and 2 seekers, 9 boxes, 2 ramps,
ZeroAgentVelocity | RandomFlipTeams, seed 5) - for 300 steps across the
episode-end full reset, then 20 steps with 1 % random resets (the compact
reset branch). The megastep is checked twice: on a fresh init state, at
rest, and on the main path's state after 100 steps, where bodies move.
It checks that everything stays finite, that both kernels were launched
by the main path, and prints one JSON line of per-kernel numbers, the
card's name and power limit, and a final JSON status line.

``--profile`` adds a last phase: torch.profiler over 20 main-path steps
without resets and 5 steps with 1 % resets, printing each window's wall
time per step, device kernel time per step, busy share and top kernels.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

WORLDS = 16384
MAIN_STEPS = 300          # crosses step 239: the full episode-end reset
COMPACT_STEPS = 20        # 1 % random resets: the compact branch
K4_CHECK_STEPS = 3        # per K4 check: one tight step, then chained
MOVING_AT = 100           # main-path step whose state the 2nd check uses
RESET_FRACTION = 0.01
SEED = 5

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 outside the tensor cores, FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# One step of the kernel and its plain version from the same input: the
# CPU tests' one-step bars (tests/test_torch_step.py). Velocity is a
# position difference over h = 1/120 s, angular velocity 2/h times a
# quaternion difference, hence 120x and 240x the position bar.
TIGHT = dict(pos=1e-4, quat=1e-4, vel=1.2e-2, omega=2.4e-2)
# On a moving state a near-tie contact may flip between the two sides:
# TIGHT must hold on this share of the live elements (velocity elements
# where either side exceeds the bar; every position element), and there
# must be at least MIN_LIVE live velocity and angular-velocity elements.
LIVE_SHARE = 0.995
MIN_LIVE = 1000
# Chained steps: the JAX package's kernel bars against their own oracles
# (tests/test_pallas_kernels.py:36-237), on >= 99.5 % of all elements.
JAX_BARS = dict(pos=5e-3, quat=5e-3, vel=0.5, omega=0.5)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, t0: float) -> None:
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def frac_close(a, b, tol) -> float:
    return (torch.abs(a.float() - b.float()) < tol).float().mean().item()


def max_err(a, b) -> float:
    a, b = a.float(), b.float()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool((torch.isinf(a) == torch.isinf(b)).all()):
        return math.inf
    return torch.abs(torch.where(fin, a - b, 0.0)).max().item()


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile main-path steps after the checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from marl_hideandseek_torch.config import EnvConfig, SimFlags
    from marl_hideandseek_torch.env import observations as O
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.ops import build, rays, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {gpu} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(["raycast", "megastep"])
    phase("build", t0)
    for name in ("raycast", "megastep"):
        log(f"ptxas {name}:\n{build.ptxas_summary(name)}")

    cfg = EnvConfig(
        num_worlds=WORLDS, min_hiders=2, max_hiders=2, min_seekers=2,
        max_seekers=2, rand_seed=SEED,
        sim_flags=SimFlags.ZeroAgentVelocity | SimFlags.RandomFlipTeams)
    na = cfg.max_agents
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def random_actions():
        move = torch.randint(0, 5, (na, 3, WORLDS), generator=gen,
                             device=dev)
        gl = torch.randint(0, 2, (na, 2, WORLDS), generator=gen, device=dev)
        return torch.cat([move, gl], 1).to(torch.int32).contiguous()

    # A state for the kernel checks, from its own env (not the main path).
    ref_env = PackedEnv(cfg.replace(rand_seed=SEED + 1), device=dev)
    ps0, _ = ref_env.init()

    # ---- 2. K1 vs plain ------------------------------------------------------
    t0 = time.perf_counter()
    st = O.world_first(ps0)
    q = [torch.movedim(x, 0, -1).contiguous()
         for x in O.obs_ray_queries(cfg, st)]
    t_k, id_k = rays.raycast_batch_packed(cfg, ps0, *q)
    t_p, id_p = rays.raycast_packed_plain(cfg, ps0, *q)
    torch.cuda.synchronize()
    id_eq = (id_k == id_p).float().mean().item()
    both = (id_k == id_p) & (id_k >= 0)
    k1_err = max_err(t_k[both], t_p[both])
    log(f"K1 raycast: rays {q[2].shape[0]} x worlds {WORLDS}; id equal "
        f"{id_eq:.6f}; max |t - t_plain| on equal hits {k1_err:.3g}")
    require(id_eq >= 0.999, f"K1 ids agree on {id_eq} < 0.999")
    require(k1_err <= 1e-4, f"K1 t error {k1_err} > 1e-4")
    k1_ms = cuda_ms(lambda: rays.raycast_batch_packed(cfg, ps0, *q), 20)
    k1_plain_ms = cuda_ms(lambda: rays.raycast_packed_plain(cfg, ps0, *q), 2)
    b, s = ps0.bodies, ps0.statics
    k1_bytes = (nbytes(b.pos, b.quat, b.half_ext, b.active, s.wall_pos,
                       s.wall_half_ext, s.wall_active, s.plane_point,
                       s.plane_normal, s.plane_active, *q) +
                nbytes(t_k, id_k))
    k1_ops = raycast_ops(cfg, ps0, q[3])
    k1_bound = max(k1_bytes / PEAK_BYTES, k1_ops / PEAK_F32) * 1e3
    k1_by = "bytes" if k1_bytes / PEAK_BYTES > k1_ops / PEAK_F32 \
        else "operations"
    log(f"K1 {k1_ms:.4f} ms/launch, plain {k1_plain_ms:.3f} ms, bound "
        f"{k1_bound:.5f} ms ({k1_by}: {k1_bytes} B, {k1_ops:.4g} ops)")
    phase("k1_check", t0)

    # ---- 3. K4 vs plain, on a fresh init state (at rest) --------------------
    t0 = time.perf_counter()
    ps = ps0.replace(step=torch.full_like(ps0.step, 100))
    k4_err = check_k4_run(step, cfg, ps, random_actions, "init")
    phase("k4_check_init", t0)
    del ref_env, ps0, ps
    torch.cuda.empty_cache()

    # ---- 4. main path --------------------------------------------------------
    t0 = time.perf_counter()
    rays.RAYCAST.launches = 0
    step.MEGASTEP.launches = 0
    env = PackedEnv(cfg, device=dev)
    ps, res = env.init()
    check_finite(ps, res, "init")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t1 = time.perf_counter()
    t_reset = 0.0
    moving = None
    for i in range(MAIN_STEPS):
        at_end = i == cfg.episode_len - 1      # this step fires the reset
        if at_end:
            torch.cuda.synchronize()
            tr = time.perf_counter()
        ps, res = env.step(ps, random_actions())
        if at_end:
            torch.cuda.synchronize()
            t_reset = time.perf_counter() - tr
        if i + 1 == MOVING_AT:
            moving = ps.map(snapshot)
        if (i + 1) % 100 == 0:
            check_finite(ps, res, f"step {i + 1}")
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t1
    require(env.reset_counts["full"] >= 1, "the full reset never ran")
    t2 = time.perf_counter()
    for i in range(COMPACT_STEPS):
        resets = (torch.rand(WORLDS, generator=gen, device=dev)
                  < RESET_FRACTION).to(torch.int32)
        ps, res = env.step(ps, random_actions(), resets)
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t2
    check_finite(ps, res, "compact")
    launches = {"raycast": rays.RAYCAST.launches,
                "megastep": step.MEGASTEP.launches}
    require(env.reset_counts["compact"] >= 1, "the compact reset never ran")
    require(launches["raycast"] > 0 and launches["megastep"] > 0,
            f"kernel launches on the main path: {launches}")
    obs_shapes = {k: tuple(v.shape) for k, v in res.obs.items()}
    require(obs_shapes["box_data"] == (WORLDS, na, 9 * 17) and
            obs_shapes["self_lidar"] == (WORLDS, na, 30),
            f"observation shapes {obs_shapes}")
    sps_main = MAIN_STEPS * WORLDS / t_main
    sps_steady = (MAIN_STEPS - 1) * WORLDS / (t_main - t_reset)
    sps_compact = COMPACT_STEPS * WORLDS / t_compact
    log(f"main path: init {t_init:.3f} s; {MAIN_STEPS} steps in "
        f"{t_main:.3f} s = {sps_main:.1f} steps x worlds / s, of which the "
        f"episode-end full-reset step {t_reset:.3f} s (without it "
        f"{sps_steady:.1f}); {COMPACT_STEPS} steps with 1 % resets in "
        f"{t_compact:.3f} s = {sps_compact:.1f}; resets "
        f"{env.reset_counts}; launches {launches}; {gpu}")
    phase("main_path", t0)

    # ---- 5. K4 vs plain on the main path's moving state; K4 timing -----------
    t0 = time.perf_counter()
    tally: dict = {}
    k4_err = max(k4_err, check_k4_run(step, cfg, moving, random_actions,
                                      f"main-path step {MOVING_AT}", tally))
    acts = random_actions()
    rk = step.megastep_packed(cfg, moving, acts)
    k4_ms = cuda_ms(lambda: step.megastep_packed(cfg, moving, acts), 10)
    k4_plain_ms = cuda_ms(lambda: step.megastep_plain(cfg, moving, acts), 1)
    k4_bytes = (nbytes(*[t for t, _, _ in
                         step.megastep_inputs(cfg, moving, acts)]) +
                nbytes(*k4_outputs(rk)))
    k4_ops = megastep_ops(cfg, moving, tally)
    k4_bound = max(k4_bytes / PEAK_BYTES, k4_ops / PEAK_F32) * 1e3
    k4_by = "bytes" if k4_bytes / PEAK_BYTES > k4_ops / PEAK_F32 \
        else "operations"
    log(f"K4 {k4_ms:.4f} ms/launch, plain {k4_plain_ms:.3f} ms, bound "
        f"{k4_bound:.5f} ms ({k4_by}: {k4_bytes} B, {k4_ops:.4g} ops; "
        f"physics work per launch {tally})")
    phase("k4_check_moving", t0)

    kernels = [
        dict(name="raycast", route="cuda",
             source="marl_hideandseek_torch/csrc/raycast.cu",
             replaces="marl_hideandseek_tpu/ops/pallas_rays.py:216",
             launches=launches["raycast"], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None),
        dict(name="megastep", route="cuda",
             source="marl_hideandseek_torch/csrc/megastep.cu",
             replaces="marl_hideandseek_tpu/ops/pallas_step.py:1064",
             launches=launches["megastep"], max_abs_err=k4_err, ms=k4_ms,
             plain_ms=k4_plain_ms, bound_ms=k4_bound, bound_by=k4_by,
             library_ms=None),
    ]
    if args.profile:
        t0 = time.perf_counter()
        ps = profile_window(env, ps, 20, random_actions, gen, 0.0,
                            "no resets")
        profile_window(env, ps, 5, random_actions, gen, RESET_FRACTION,
                       "1 % resets")
        phase("profile", t0)
    phase("total", t_all)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_finite(ps, res, where: str) -> None:
    """State floats finite (act_hit_t may be +inf: a ray miss); every
    observation, reward and episode result finite."""
    for t in ps.leaves():
        if t.is_floating_point():
            bad = ~(torch.isfinite(t) | (t == math.inf))
            require(not bool(bad.any()), f"non-finite state at {where}")
    for k, v in res.obs.items():
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"obs {k} at {where}")
    require(bool(torch.isfinite(res.rewards).all()), f"rewards at {where}")


def snapshot(x: torch.Tensor) -> torch.Tensor:
    """A copy of a state leaf (uint32 through its int32 view)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).clone().view(torch.uint32)
    return x.clone()


def check_k4_run(step, cfg, ps, random_actions, label: str,
                 tally: dict | None = None) -> float:
    """K4_CHECK_STEPS launches of K4 against its plain version, each from
    the kernel's previous output: the first held to TIGHT (on every
    element of a state at rest, on LIVE_SHARE of the live elements of a
    moving one), the rest to JAX_BARS. ``tally`` gets the first plain
    step's physics work counts. Returns the largest body error seen."""
    err = 0.0
    for i in range(K4_CHECK_STEPS):
        acts = random_actions()
        rk = step.megastep_packed(cfg, ps, acts)
        rp = step.megastep_plain(cfg, ps, acts, tally=tally if i == 0
                                 else None)
        torch.cuda.synchronize()
        where = f"K4 {label}, step {i}"
        notes = []
        for name, tol in TIGHT.items():
            a, p_ = getattr(rk[0].bodies, name), getattr(rp[0].bodies, name)
            e = max_err(a, p_)
            err = max(err, e)
            if i > 0:
                fr = frac_close(a, p_, JAX_BARS[name])
                require(fr >= 0.995, f"{where} {name}: {fr} within "
                        f"{JAX_BARS[name]}")
                notes.append(f"{name} err {e:.3g}")
                continue
            live = (a.abs() > tol) | (p_.abs() > tol)
            if name in ("pos", "quat"):
                live = torch.ones_like(live)
            n_live = int(live.sum())
            close = int(((a - p_).abs() <= tol)[live].sum())
            notes.append(f"{name} err {e:.3g}, {close}/{n_live} live "
                         f"within {tol}")
            if label == "init":
                require(e <= tol, f"{where} {name}: max error {e} > {tol}")
                continue
            if name in ("vel", "omega"):
                require(n_live >= MIN_LIVE, f"{where} {name}: only "
                        f"{n_live} live elements")
            require(close >= LIVE_SHARE * n_live, f"{where} {name}: "
                    f"{close}/{n_live} live elements within {tol}")
        vis_eq = (rk[1].vis_seen == rp[1].vis_seen).float().mean().item()
        aid_eq = (rk[1].act_id == rp[1].act_id).float().mean().item()
        lid = frac_close(rk[1].lidar, rp[1].lidar, 1e-3)
        require(vis_eq >= 0.999, f"{where} vis agree {vis_eq}")
        require(aid_eq >= 0.999, f"{where} act_id agree {aid_eq}")
        require(lid >= 0.999, f"{where} lidar agree {lid}")
        require(bool((rk[2] == rp[2]).all()), f"{where} rewards")
        require(bool((rk[3] == rp[3]).all()), f"{where} dones")
        for name in ("locked", "owner"):
            require(bool((getattr(rk[0].bodies, name) ==
                          getattr(rp[0].bodies, name)).all()),
                    f"{where} {name}")
        require(bool((rk[0].grab.target == rp[0].grab.target).all()),
                f"{where} grab target")
        require(bool((rk[0].running_scores == rp[0].running_scores).all()),
                f"{where} running scores")
        log(f"{where}: {'; '.join(notes)}; vis {vis_eq:.6f} act_id "
            f"{aid_eq:.6f} lidar {lid:.6f}")
        ps = rk[0].replace(step=rk[0].step + 1, act_hit_t=rk[1].act_t,
                           act_hit_id=rk[1].act_id)
    return err


def k4_outputs(rk) -> list:
    """The tensors one megastep launch writes."""
    ps2, sweep, rewards, dones, team_r = rk
    b, g = ps2.bodies, ps2.grab
    return [b.pos, b.quat, b.vel, b.omega, b.locked, b.owner, g.target,
            g.r2, g.rel_q, g.sep, *sweep, rewards, dones, team_r,
            ps2.running_scores, ps2.finished_scores]


def profile_window(env, ps, steps, random_actions, gen, reset_frac, label):
    """torch.profiler over ``steps`` main-path steps: wall and device
    kernel time per step, busy share (kernel-time sum over wall time) and
    the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    w = env.cfg.num_worlds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            resets = (torch.rand(w, generator=gen, device=env.device)
                      < reset_frac).to(torch.int32)
            ps, _ = env.step(ps, random_actions(), resets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.device_time_total, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3                     # ms
    log(f"profile [{label}] {steps} steps: {wall / steps * 1e3:.3f} ms/step "
        f"wall (under the profiler); device kernel time "
        f"{busy / steps:.3f} ms/step; busy share {busy / (wall * 1e3):.3f}")
    for key, t, n in rows[:15]:
        log(f"  {t / 1e3 / steps:9.4f} ms/step {n:7d} calls  {key[:90]}")
    return ps


# Operations per primitive, counted from the sources (csrc/common.cuh,
# csrc/raycast.cu, csrc/megastep.cu): every float add, subtract,
# multiply, divide, square root, absolute value, min/max and compare is
# one; negations and selects are not counted. Each count leaves out some
# set-up (loads, index arithmetic, movement decode, grab/lock, rewards,
# the rare restitution impulse), so it errs low and the bound with it.
# Rays: ray_body on an OBB (2 rotations, slab test) or a wedge (2
# rotations, 5 faces), ray_aabb on a wall, ray_plane, each with
# cast_ray's two compares.
OPS_RAY_BOX, OPS_RAY_WEDGE, OPS_RAY_WALL, OPS_RAY_PLANE = 101, 160, 44, 20
# Sweep per agent: 2 rotations; per visibility ray 17, per lidar ray 19.
OPS_SWEEP_AGENT, OPS_VIS_RAY, OPS_LIDAR_RAY = 60, 17, 19
# build_manifold per body slot (active or not): 8 vertices x 390 (2
# rotations, 3 planes, 3 wall and 3 pair candidates), the two
# candidate selections (3 x 36 x 3 and 3 x 15 x 3 compares) and r_bound;
# plus 12 per active wall and 11 per other active body (preselection).
OPS_MANIFOLD_SLOT, OPS_PRESEL_WALL, OPS_PRESEL_BODY = 3585, 12, 11
# Per body slot and substep: integrate 140, combine the solve 81, apply
# the joints 51, velocities from positions 42, combine the velocity
# passes 33.
OPS_SUBSTEP_SLOT = 347
# Per live manifold slot and substep, the refresh: 81 (vertex, 2
# rotations, inset) plus the surface test by kind.
OPS_REFRESH = {"live_plane": 90, "live_wall": 105, "live_pair": 251}
# Per solved contact and substep (physics.physics_step's tally): the
# position solve with static friction 409 plus the velocity pass's
# relative velocities and restitution test 53; per contact with a
# positive impulse the dynamic friction 190; a pair adds 160 to each
# for the neighbour's terms; a grab joint 660.
OPS_TALLY = {"masked": 462, "masked_pair": 160, "pushing": 190,
             "pushing_pair": 160, "joints": 660}


def body_ray_ops(cfg, ps) -> torch.Tensor:
    """[B, W] operations of one ray's test against each body slot (0 for
    an inactive body)."""
    from marl_hideandseek_torch.types import body_slot_ranges

    _, (rl, rh), _ = body_slot_ranges(cfg)
    per = torch.full((cfg.num_dyn_bodies, 1), float(OPS_RAY_BOX),
                     device=ps.step.device)
    per[rl:rh] = OPS_RAY_WEDGE
    return ps.bodies.active.float() * per


def static_ray_ops(ps) -> torch.Tensor:
    """[W] operations of one ray's tests against a world's statics."""
    s = ps.statics
    return (s.wall_active.float().sum(0) * OPS_RAY_WALL +
            s.plane_active.float().sum(0) * OPS_RAY_PLANE)


def raycast_ops(cfg, ps, excl: torch.Tensor) -> float:
    """Operations of one K1 launch on this state: every ray ([R, W]
    excluded ids) tests every active primitive of its world but the one
    it excludes."""
    per_body = body_ray_ops(cfg, ps)
    s = ps.statics
    per_id = torch.cat([per_body, s.wall_active.float() * OPS_RAY_WALL,
                        s.plane_active.float() * OPS_RAY_PLANE])
    per_ray = per_body.sum(0) + static_ray_ops(ps)
    skipped = torch.gather(per_id, 0, excl.clamp(min=0).long()) * (excl >= 0)
    return (per_ray * excl.shape[0] - skipped.sum(0)).sum().item()


def megastep_ops(cfg, ps, tally: dict) -> float:
    """Operations of one K4 launch on this state: the sweep's rays (per
    agent: the visibility targets, 30 lidar and 1 grab ray, each against
    every active primitive but the agent itself), the manifold build and
    the substeps' per-slot work, plus the refreshes, solves and joints
    the plain physics counted on the same input (``tally``)."""
    from marl_hideandseek_torch.env.observations import num_vis_targets
    from marl_hideandseek_torch.types import body_slot_ranges

    _, _, (al, ah) = body_slot_ranges(cfg)
    n_tgt = num_vis_targets(cfg)
    per_body = body_ray_ops(cfg, ps)
    per_ray = per_body.sum(0) + static_ray_ops(ps)               # [W]
    own = per_body[al:ah]                                        # [A, W]
    rays = (n_tgt + 30 + 1) * (per_ray[None] - own)
    sweep = rays.sum().item() + cfg.max_agents * ps.step.numel() * (
        OPS_SWEEP_AGENT + n_tgt * OPS_VIS_RAY + 30 * OPS_LIDAR_RAY)
    n_slot = cfg.num_dyn_bodies
    walls = ps.statics.wall_active.float().sum(0)
    active = ps.bodies.active.float().sum(0)
    manifold = (n_slot * (OPS_MANIFOLD_SLOT + OPS_PRESEL_WALL * walls) +
                OPS_PRESEL_BODY * active * (n_slot - 1)).sum().item()
    substeps = (cfg.num_physics_substeps * n_slot * OPS_SUBSTEP_SLOT *
                ps.step.numel())
    work = sum(OPS_REFRESH.get(k, 0) * v + OPS_TALLY.get(k, 0) * v
               for k, v in tally.items())
    return sweep + manifold + substeps + work


if __name__ == "__main__":
    sys.exit(main())

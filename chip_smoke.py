"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--profile]

Builds the port's CUDA kernels with nvcc and the record log's codec
with the host C++ compiler (one process per source, all in parallel),
holds the threefry kernel (``csrc/threefry.cu``, every random draw of
the port) to its plain version bit for bit on 16,384 keys x
4,096 words and on ragged shapes, and the card's ``prng`` draws to
jax.random's outputs carried here as constants (``THREEFRY_TABLE``),
then drives these paths, each with its kernels' launch counts set to 0
just before and read just after (the threefry kernel's on every path):

* the packed main path - ``PackedEnv.init`` and ``PackedEnv.step`` at
  bench.py's configuration (16,384 worlds, 2 hiders and 2 seekers, 9
  boxes, 2 ramps, ZeroAgentVelocity | RandomFlipTeams, seed 5) - for 300
  steps across the episode-end full reset, then 20 steps with 1 % random
  resets (the compact branch): K4 megastep, K1 raycast and K6
  observation assembly (one launch a step and at init);
* k6_check - K6 against the plain assembly on the main path's state at
  step 100, leaf by leaf (integers and masks equal, floats within 1e-5),
  then at 65,536 worlds (that state four times over): ms a launch, the
  byte bound, the plain version's ms, the largest error;
* k7_check - K7 (level generation) against the plain generator at 256,
  16,384 and 65,536 worlds of bench.py's 2v2 and at 16,384 worlds of
  3v3, of the serve path's fixed world and of headless.py's 3v2, every
  leaf bit for bit: ms a launch (arguments built once), a whole call with
  its draws, the plain version's ms, the byte bound; K7's launches (one
  at init and on each reset step) are required on the main, classic,
  serve, eval and train paths and counted on every other;
* the classic path - ``HideAndSeekEnv`` at scripts/headless.py's
  configuration (16,384 worlds, 3 hiders and 2 seekers, SimFlags.Default,
  seed 5) - for 250 steps across the full reset, then 5 steps with 1 %
  random resets, some to debug levels 2-8 (the compact branch): K3 fused
  physics + sweep and K1; then 10 steps of its unfused branch: K2 physics
  and K1;
* the render path - bench.py's BENCH_RENDER=1 protocol: 20 more packed
  steps, each followed by the K5 RGBD kernel at 64x64 into buffers
  allocated once;
* the frames path - the pixel policy's training: the train CLI's
  ``build`` with ``--backbone impala_cnn`` at 256 2v2 worlds (the env
  renders every agent's 64x64 RGBD frame in its init and in each step,
  K5's frames mode), ``init_training`` and one ``update_iter``: K5's
  frames launches counted over that run, the last frames held to the
  plain renderer, K5's frames-mode time against its bound;
* the serve path - the inference loop of ``python -m
  marl_hideandseek_torch.infer`` (``infer.run_inference``) on
  ``PackedEnv`` at 16,384 worlds, 2 hiders and 2 seekers, UseFixedWorld
  | ZeroAgentVelocity, seed 5, with the flagship ``make_policy()`` at full
  width, 4 policies drawn as flax draws them from PRNGKey(5), for 250
  stochastic
  steps across the episode-end reset: K4 on every step, K1 on the reset
  steps; the ensemble forward on step 100's observations is held to the
  same modules on the CPU for 512 agents, with TF32 off;
* the eval path - ``train.evaluate.eval_policies`` with the same 4
  policies on the classic env at headless.py's configuration, 2,048
  worlds, 250 steps: K3 and K1, the ELOs moving at the episode end;
* the train path - ``python -m marl_hideandseek_torch.train``'s
  ``build`` at train.sh's recipe (1,024 worlds, 2v2, RandomFlipTeams |
  UseFixedWorld | ZeroAgentVelocity, seed 5, PBT 2 train + 2 past
  policies with grouped PPO, lr and entropy coefficient explored, the
  Dreamer critic, the flagship policy at full width) in float32 with TF32
  off, then ``init_training``, 7 ``update_iter`` (280 steps, across the
  episode end), ``eval_elo`` (240 steps), ``explore_exploit`` and
  ``refresh_past_policies``, and a checkpoint round trip: K4 on every
  step, K1 on the init and reset steps; the first update's
  ``ppo_update`` on 64 worlds of its buffer against the CPU's at the
  update's rounding bars (``testing.rounding_bars``: per moment leaf, the
  CPU's own spread under one-ulp moves of the observations, floored at
  the CPU tests' bars); the training rate, rollout and PPO ms per update
  and the PPO update's FLOP/s;
* dp_nccl_1 - one more update of the train path's state over a mesh of
  one NCCL rank (``utils/runtime.init_distributed``,
  ``parallel/mesh.make_mesh``), bit for bit the update without a mesh;
* train_bf16 - train.sh's recipe as written, with ``--bf16``: 3
  updates, the first update's PPO on 64 worlds against the CPU's bf16
  update at rounding bars from bf16 ulp moves, the bf16 ensemble forward
  against the CPU's at tests/test_torch_policy.py's 5e-2, the rate beside
  float32's;
* train_3v3 - scripts/train.py's default 3v3 teams at train.sh's other
  settings in bf16: 3 updates, finite state, grouped PPO, the dropped
  agent share, the rate;
* dp_path - ``--data-parallel``'s training over 2 gloo ranks spawned on
  the one card (512 worlds each, float32): the first rollout's buffer and
  post-rollout state against the train path's slices (equal, or at the
  chained steps' bars with the reason printed), the first update at its
  rounding bars, ELOs, hyperparameters and parameters equal on both
  ranks, the rate (two ranks sharing one card: not a scaling figure);
* record_path - ``python -m marl_hideandseek_torch.infer``'s ``main`` with
  infer.sh's arguments as written (16 worlds, 2v2, ``--record-log``) but
  500 steps, across two episode ends, on a policy checkpoint of 4 seeded
  flagship policies: K4 every step, K1 on the resets; the log's frames
  0, 239, 240 and 499 against the checkpoint records of the states the
  loop held; frame 499 loaded through ``load_checkpoints`` (bodies bit
  for bit, statics regenerated equal); K4 and K1 at 16 worlds against
  their plain versions; ``replay`` and ``replay3d`` on the log; the
  16-world step's time with and without recording;
* viewer_path - a command script piped through the viewer with the
  follow camera at 1 world: K3 per step, K1 on the init, loads and
  resets, K5 per frame; ``n`` restores the state saved at ``m``; K3, K1
  and K5 at 1 world against their plain versions;
* tooluse_path - ``eval_tooluse`` on the train path's checkpoint at its
  defaults (128 worlds, 480 steps): K4, K1; fractions in [0, 1] and the
  seek-phase world-steps counted from the step counters;
* nan_guard - one update of the train path's state with the NaN guards
  on, then one from a state with a NaN planted in a parameter leaf,
  which must raise naming it;
* entry - ``entry.entry()``'s forward on the card against the CPU at
  1e-5, TF32 off, and ``entry.dryrun_multichip(2)`` over 2 gloo ranks
  sharing the card.

After the build it prints each kernel entry's ptxas registers, stack and
spills, megastep.cu's worlds per block, shared bytes per world and
resident worlds per SM, and raycast.cu's and rgbd.cu's worlds per block,
shared bytes per block and resident worlds per SM.

Every kernel is held against its plain PyTorch version at the path's
shapes: K1 on the packed and the classic path's init states (bench.py's
2v2, R = 184 rays a world; headless.py's 3v2, R = 230); K4, K2 and K3 on
an init state at rest and on their path's state after 100 steps (one
step at the one-step bars, then chained steps at the JAX kernels' bars);
K5 on 256 worlds of the render path's last step, at the JAX kernel's
bar. It checks that everything stays
finite, that each path launched its kernels, prints the threefry
launches per packed step, per reset step and per training update, the
full reset's time and the training rate, and prints one JSON line of
per-kernel numbers, the card's name and power limit, and a final JSON
status line.

``--profile`` adds a last phase: torch.profiler over 20 main-path steps
without resets and 5 steps with 1 % resets, printing each window's wall
time per step, device kernel time per step, busy share and top kernels,
then over 3 of the serve path's ensemble forwards and over one more
training update of the train path.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

WORLDS = 16384
MAIN_STEPS = 300          # crosses step 239: the full episode-end reset
COMPACT_STEPS = 20        # 1 % random resets: the compact branch
K4_CHECK_STEPS = 3        # per kernel check: one tight step, then chained
MOVING_AT = 100           # path step whose state the 2nd check uses
RESET_FRACTION = 0.01
SEED = 5
CLASSIC_STEPS = 250       # crosses step 239: the full episode-end reset
CLASSIC_COMPACT_STEPS = 5
UNFUSED_STEPS = 10        # the classic env's unfused branch: K2 + K1
RENDER_STEPS = 20         # bench.py BENCH_RENDER=1: a render every step
RENDER_HW = 64
RENDER_CHECK_WORLDS = 256  # K5 against the plain renderer on these
FRAMES_WORLDS = 256       # the pixel policy's training (impala_cnn)
SERVE_STEPS = 250         # crosses step 239: the episode-end full reset
SERVE_POLICIES = 4
SERVE_CHECK_AT = 100      # step whose forward is held to the CPU's
SERVE_CHECK_AGENTS = 512
SERVE_BAR = 1e-4          # card vs CPU forward, float32 without TF32
SERVE_BEST_SHARE = 0.999  # best() equal on at least this share
EVAL_WORLDS = 2048
EVAL_STEPS = 250
TRAIN_WORLDS = 1024       # train.sh's recipe
TRAIN_UPDATES = 7         # 280 steps: crosses the 240-step episode end
TRAIN_CHECK_WORLDS = 64   # update 1's PPO held to the CPU's on these
EXTRA_UPDATES = 3         # the bf16, 3v3 and data-parallel runs
DP_RANKS = 2              # dp_path: ranks sharing the one card
# tests/test_torch_policy.py's bar of the bf16 forward (argued there from
# bf16's 2^-8 step), on this many agents of the bf16 run's first step.
BF16_BAR = 5e-2
BF16_CHECK_AGENTS = 512
RECORD_WORLDS = 16        # infer.sh's worlds
RECORD_STEPS = 500        # crosses both episode ends (steps 239 and 479)
RECORD_BYTES = 1044       # a 2v2 world's checkpoint record
RECORD_CHECK = (0, 239, 240, 499)   # frames held to the loop's states
RECORD_MOVING = 100       # the record run's state the K4 / K1 checks use
RECORD_TIMED = 50         # steps per timing run, with and without the log
RECORD_PAIRS = 3
REPLAY_EVERY = 50
REPLAY3D_EVERY = 25
VIEWER_SCRIPT = "w w g l m d d n f q 3 r x"
TOOLUSE_WORLDS = 128      # eval_tooluse's defaults
TOOLUSE_STEPS = 480
ENTRY_BAR = 1e-5

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 outside the tensor cores, FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# 32-bit integer operations/s outside the tensor cores: 64 INT32 lanes
# per SM (half the 128 FP32 lanes behind PEAK_F32, which counts an FMA
# as two) x 132 SMs x 1.98 GHz (Hopper white paper).
PEAK_INT32 = 64 * 132 * 1.98e9
# Least integer operations of threefry2x32-20: per item, 20 rounds of
# add, rotate (one funnel shift) and xor and 12 key-injection adds, then
# 1 xor for the bits mode, 3 more (shift, or, subtract) for the uniform
# mode; per key, the key schedule's 2 xors and the 5 injected words (a
# key word plus its round constant), which the kernel repeats per item.
THREEFRY_ITEM_OPS = {0: 72, 1: 73, 2: 75}
THREEFRY_KEY_OPS = 7
THREEFRY_KEYS = 16384      # the check's batch: keys x words
THREEFRY_WORDS = 4096

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


# jax.random's outputs (JAX 0.9.0, threefry2x32, partitionable) on fixed
# keys, for the threefry check on the card, where JAX is not installed.
# tests/test_torch_random.py recomputes them with JAX and fails if this
# copy differs. Floats as their u32 bit patterns.
THREEFRY_TABLE = {
    "key": [0, 42],
    "split": [[1832780943, 270669613], [64467757, 2916123636],
              [2465931498, 255383827]],
    "fold_in": [3383801349, 143359933],
    "episode_keys": [[1069507333, 595131425], [1843143148, 391770929],
                     [2195160428, 1013523968], [1976544331, 3472217764]],
    "bits": [2098992034, 2919706841, 2646866425, 2409546199, 1935504149,
             2516274904, 321304473, 3329172656],
    "uniform": [1056585764, 1059981104, 1058915320, 1057988288, 1055308516,
                1058405198, 1033450928, 1061580580],
    "uniform_scaled": [3201309424, 1087316056, 1082520028, 1074566336,
                       3219353084, 1078318526, 3245664486, 1092516369],
    "randint": [4, 4, 1, 9, 9, 9, 7, 7],
    "randint_batched": [2, 3, 5, 7],
    "categorical": [2, 4, 1, 1, 3, 4],
    "permutation": [7, 4, 2, 5, 3, 6, 10, 11, 8, 9, 0, 1],
    "permutation_2000": [2010407423, 1474, 815, 539, 874],
}


def threefry_table(device) -> dict:
    """``THREEFRY_TABLE``'s entries drawn by the port's ``prng`` on
    ``device``: PRNGKey(42); split 3 ways; fold_in 1000; the episode keys
    fold_in(fold_in(PRNGKey(5), w), 7) of worlds 0-3; 8 bits, uniforms on
    [0, 1) and [-18, 18), randints in [0, 10); one randint each from
    split(PRNGKey(7), 4) below 3, 5, 7, 9; a categorical over 6 rows of
    logits ((3 i) mod 7) / 4 - 0.75; permutations of 12 and of 2,000
    (its sum of i * perm[i] and first four)."""
    from marl_hideandseek_torch import prng

    def u(x):
        if x.dtype == torch.float32:
            x = x.view(torch.int32)
        return (x.view(torch.int32).long() & 0xFFFFFFFF).cpu().tolist()

    def i(x):
        return x.long().cpu().tolist()

    k = prng.key(42, device)
    logits = ((torch.arange(30, device=device).reshape(6, 5) * 3) % 7
              ).float() / 4.0 - 0.75
    perm = prng.permutation(k, 2000)
    return {
        "key": u(k),
        "split": u(prng.split(k, 3)),
        "fold_in": u(prng.fold_in(k, 1000)),
        "episode_keys": u(prng.fold_in(prng.fold_in(
            prng.key(5, device), torch.arange(4, device=device)), 7)),
        "bits": u(prng.bits(k, (8,))),
        "uniform": u(prng.uniform(k, (8,))),
        "uniform_scaled": u(prng.uniform(k, (8,), -18.0, 18.0)),
        "randint": i(prng.randint(k, (8,), 0, 10)),
        "randint_batched": i(prng.randint(
            prng.split(prng.key(7, device), 4), (), 0,
            torch.tensor([3, 5, 7, 9], device=device))),
        "categorical": i(prng.categorical(k, logits)),
        "permutation": i(prng.permutation(k, 12)),
        "permutation_2000": [int((perm * torch.arange(
            2000, device=device)).sum()), *i(perm[:4])],
    }


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
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(args, work: str) -> int:
    """The phases of ``main``; ``work`` a directory for their files."""
    from marl_hideandseek_torch.config import EnvConfig, SimFlags
    from marl_hideandseek_torch.env import observations as O
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.ops import build, rays, step
    from marl_hideandseek_torch.ops import levelgen as LG
    from marl_hideandseek_torch.ops import threefry as tfk
    from marl_hideandseek_torch.ops.common import block_occupancy
    from marl_hideandseek_torch.types import pack_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {gpu} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(["raycast", "megastep", "rgbd", "threefry", "observations",
                 "levelgen"], host=["ckptlog"])
    phase("build", t0)
    for name in ("raycast", "megastep", "rgbd", "threefry", "observations",
                 "levelgen"):
        log(f"ptxas {name}:\n{build.ptxas_summary(name)}")
    occ = step.megastep_occupancy()
    log(f"megastep.cu (K2, K3, K4): one warp per world, "
        f"{occ['worlds_per_block']} worlds per block, "
        f"{occ['smem_bytes_per_world']} B of shared memory per world; "
        f"resident worlds per SM: K4 {occ['megastep_worlds_per_sm']}, K2 "
        f"{occ['physics_worlds_per_sm']}, K3 {occ['fused_worlds_per_sm']}")
    for name, label in (("raycast", "K1"), ("rgbd", "K5"),
                        ("levelgen", "K7")):
        o = block_occupancy(name)
        log(f"{name}.cu ({label}): one warp per world, "
            f"{o['worlds_per_block']} worlds per block, "
            f"{o['smem_bytes_per_block']} B of shared memory per block; "
            f"resident worlds per SM {o['worlds_per_sm']}")

    for teams in (1, 2, 3):
        o = obs_occupancy(teams)
        log(f"observations.cu (K6), {teams}v{teams}: "
            f"{o['worlds_per_block']} worlds per block, "
            f"{o['smem_bytes_per_block']} B of shared memory per block; "
            f"resident worlds per SM {o['worlds_per_sm']}")

    cfg = EnvConfig(
        num_worlds=WORLDS, min_hiders=2, max_hiders=2, min_seekers=2,
        max_seekers=2, rand_seed=SEED,
        sim_flags=SimFlags.ZeroAgentVelocity | SimFlags.RandomFlipTeams)
    na = cfg.max_agents
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def random_actions(n_agents=na, n_move=5):
        """Packed [A, 5, W] actions: move buckets, then grab and lock."""
        move = torch.randint(0, n_move, (n_agents, 3, WORLDS), generator=gen,
                             device=dev)
        gl = torch.randint(0, 2, (n_agents, 2, WORLDS), generator=gen,
                           device=dev)
        return torch.cat([move, gl], 1).to(torch.int32).contiguous()

    # ---- 1b. the threefry kernel vs plain and vs JAX's table ---------------
    t0 = time.perf_counter()
    threefry = threefry_check(dev, gpu)
    phase("threefry_check", t0)

    # A state for the kernel checks, from its own env (not the main path).
    ref_env = PackedEnv(cfg.replace(rand_seed=SEED + 1), device=dev)
    ps0, _ = ref_env.init()

    # ---- 2. K1 vs plain ------------------------------------------------------
    t0 = time.perf_counter()
    k1 = check_k1(cfg, ps0, "packed init")
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
    tfk.THREEFRY.launches = 0
    O.OBSERVATIONS.launches = 0
    LG.LEVELGEN.launches = 0
    env = PackedEnv(cfg, device=dev)
    ps, res = env.init()
    tf_init = tfk.THREEFRY.launches
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
            tf_before = tfk.THREEFRY.launches
        ps, res = env.step(ps, random_actions())
        if at_end:
            torch.cuda.synchronize()
            t_reset = time.perf_counter() - tr
            tf_reset = tfk.THREEFRY.launches - tf_before
        if i + 1 == MOVING_AT:
            moving = ps.map(snapshot)
        if (i + 1) % 100 == 0:
            check_finite(ps, res, f"step {i + 1}")
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t1
    require(env.reset_counts["full"] >= 1, "the full reset never ran")
    tf_main = tfk.THREEFRY.launches
    full_main = env.reset_counts["full"]
    t2 = time.perf_counter()
    for i in range(COMPACT_STEPS):
        resets = (torch.rand(WORLDS, generator=gen, device=dev)
                  < RESET_FRACTION).to(torch.int32)
        ps, res = env.step(ps, random_actions(), resets)
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t2
    check_finite(ps, res, "compact")
    launches = {"raycast": rays.RAYCAST.launches,
                "megastep": step.MEGASTEP.launches,
                "threefry": tfk.THREEFRY.launches,
                "observations": O.OBSERVATIONS.launches,
                "levelgen": LG.LEVELGEN.launches}
    tf_compact = launches["threefry"] - tf_main
    require(env.reset_counts["compact"] >= 1, "the compact reset never ran")
    n_reset_steps = env.reset_counts["full"] + env.reset_counts["compact"]
    require(tf_init > 0 and tf_reset > 0 and
            tf_main - tf_init == tf_reset * full_main,
            f"threefry launches on the main path: init {tf_init}, full "
            f"reset {tf_reset}, {MAIN_STEPS} steps {tf_main - tf_init}")
    require(launches["raycast"] > 0 and launches["megastep"] > 0 and
            launches["observations"] == 1 + MAIN_STEPS + COMPACT_STEPS and
            launches["levelgen"] == 1 + n_reset_steps,
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
    log(f"threefry launches, main path: init {tf_init}; per packed step "
        f"without a reset 0 ({MAIN_STEPS - full_main} such "
        f"steps of {MAIN_STEPS} drew nothing); per full-reset step "
        f"{tf_reset}; {tf_compact} in {COMPACT_STEPS} steps with 1 % "
        f"resets ({tf_compact / COMPACT_STEPS:.2f} a step, "
        f"{n_reset_steps} reset steps in all); full reset step "
        f"{t_reset:.3f} s; {gpu}")
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
    k4_bound, k4_by = bound(k4_bytes, megastep_ops(cfg, moving, tally))
    log(f"K4 {k4_ms:.4f} ms/launch, plain {k4_plain_ms:.3f} ms, bound "
        f"{k4_bound:.5f} ms ({k4_by}: {k4_bytes} B; physics work per "
        f"launch {tally})")
    phase("k4_check_moving", t0)

    # ---- 5b. K6 vs plain on the moved state; K6 at 16,384 and 65,536 ------
    t0 = time.perf_counter()
    k6 = check_k6(cfg, rk[0], rk[1])
    del moving, rk
    phase("k6_check", t0)

    # ---- 5c. K7 vs plain at 256 to 65,536 worlds, 2v2, 3v3, fixed, 3v2 ------
    t0 = time.perf_counter()
    k7 = check_k7(cfg, dev)
    phase("k7_check", t0)

    # ---- 6. render path: bench.py BENCH_RENDER=1 ----------------------------
    t0 = time.perf_counter()
    render = render_path(cfg, env, ps, random_actions, gpu)
    ps = render.pop("state")
    phase("render_path", t0)

    # ---- 6b. frames path: impala_cnn's training, K5's frames mode ---------
    t0 = time.perf_counter()
    frames = frames_path(dev, gpu)
    torch.cuda.empty_cache()
    phase("frames_path", t0)

    # ---- 7. classic path (K3, K1), then its unfused branch (K2, K1) ---------
    t0 = time.perf_counter()
    del env, res
    torch.cuda.empty_cache()
    classic = classic_path(dev, random_actions, gpu)
    phase("classic_path", t0)

    # ---- 8. K2 and K3 vs plain on the classic init and moving states; K1 on
    # the classic init state's queries ----------------------------------------
    t0 = time.perf_counter()
    steps_k = check_physics_kernels(classic, random_actions)
    k1_classic = check_k1(classic["cfg"], pack_state(classic["init"]),
                          "classic init")
    phase("k2_k3_checks", t0)

    # ---- 9. serve path: the inference loop on the packed env (K4, K1) -------
    t0 = time.perf_counter()
    serve = serve_path(dev, gpu)
    phase("serve_path", t0)

    # ---- 10. eval path: eval_policies on the classic env (K3, K1) -----------
    t0 = time.perf_counter()
    evaluation = eval_path(dev, serve["policy"], serve["params"], gpu)
    phase("eval_path", t0)

    # ---- 11. train path: train.sh's recipe at 1,024 worlds (K4, K1) ---------
    t0 = time.perf_counter()
    training = train_path(dev, gpu, work)
    phase("train_path", t0)

    # ---- 12. the data-parallel update over one NCCL rank, bit for bit -------
    t0 = time.perf_counter()
    nccl1 = dp_nccl_1(dev, training["mgr"], gpu)
    phase("dp_nccl_1", t0)

    # ---- 13. train.sh as written (bf16), then its 3v3 teams ------------------
    t0 = time.perf_counter()
    bf16 = train_bf16(dev, gpu, training["fps"])
    phase("train_bf16", t0)
    t0 = time.perf_counter()
    v3 = train_3v3(dev, gpu)
    phase("train_3v3", t0)

    # ---- 14. data parallel: 2 gloo ranks on the card against train_path ----
    t0 = time.perf_counter()
    dp = dp_path(dev, gpu, training)
    phase("dp_path", t0)

    # ---- 15. the record/replay path, the viewer, tool use, NaN guards and
    # the entry points ----------------------------------------------------------
    t0 = time.perf_counter()
    record = record_path(dev, gpu, work)
    phase("record_path", t0)
    t0 = time.perf_counter()
    view = viewer_path(dev, gpu, work)
    phase("viewer_path", t0)
    t0 = time.perf_counter()
    tooluse = tooluse_path(dev, gpu, training["ckpt"])
    phase("tooluse_path", t0)
    t0 = time.perf_counter()
    nan_guard(training["mgr"])
    phase("nan_guard", t0)
    t0 = time.perf_counter()
    entry_phase(dev)
    phase("entry", t0)
    paths = {"dp_launches": dp["launches"],
             "nccl1_launches": nccl1["launches"],
             "bf16_launches": bf16["launches"],
             "train3v3_launches": v3["launches"],
             "record_launches": record["launches"],
             "viewer_launches": view["launches"],
             "tooluse_launches": tooluse["launches"]}

    def new_paths(name):
        """A kernel's launches on the paths of this slice (per rank on
        the data-parallel one)."""
        return {k: ([c[name] for c in v] if isinstance(v, list)
                    else v[name]) for k, v in paths.items()}

    kernels = [
        dict(name="raycast", route="cuda",
             source="marl_hideandseek_torch/csrc/raycast.cu",
             replaces="marl_hideandseek_tpu/ops/pallas_rays.py:216",
             launches=launches["raycast"],
             max_abs_err=max(k1["max_abs_err"], k1_classic["max_abs_err"]),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             classic_launches=classic["launches"]["raycast"],
             serve_launches=serve["launches"]["raycast"],
             eval_launches=evaluation["launches"]["raycast"],
             train_launches=training["launches"]["raycast"],
             classic_ms=k1_classic["ms"],
             classic_plain_ms=k1_classic["plain_ms"],
             classic_bound_ms=k1_classic["bound_ms"],
             **new_paths("raycast")),
        dict(name="physics", route="cuda",
             source="marl_hideandseek_torch/csrc/megastep.cu",
             replaces="marl_hideandseek_tpu/ops/pallas_physics.py:812",
             launches=classic["launches"]["physics"], **steps_k["physics"],
             **new_paths("physics")),
        dict(name="fused", route="cuda",
             source="marl_hideandseek_torch/csrc/megastep.cu",
             replaces="marl_hideandseek_tpu/ops/pallas_step.py:554",
             launches=classic["launches"]["fused"],
             eval_launches=evaluation["launches"]["fused"], **steps_k["fused"],
             **new_paths("fused")),
        dict(name="megastep", route="cuda",
             source="marl_hideandseek_torch/csrc/megastep.cu",
             replaces="marl_hideandseek_tpu/ops/pallas_step.py:1064",
             launches=launches["megastep"],
             serve_launches=serve["launches"]["megastep"],
             train_launches=training["launches"]["megastep"],
             max_abs_err=k4_err, ms=k4_ms,
             plain_ms=k4_plain_ms, bound_ms=k4_bound, bound_by=k4_by,
             library_ms=None, **new_paths("megastep")),
        dict(name="rgbd", route="cuda",
             source="marl_hideandseek_torch/csrc/rgbd.cu",
             replaces="marl_hideandseek_tpu/ops/pallas_rgbd.py:325",
             **render["kernel"], **new_paths("rgbd")),
        dict(name="rgbd_frames", route="cuda",
             source="marl_hideandseek_torch/csrc/rgbd.cu",
             replaces="none: K5's store in the policy's frame layout; "
                      "marl_hideandseek_tpu renders no frame for a policy",
             **frames),
        dict(name="observations", route="cuda",
             source="marl_hideandseek_torch/csrc/observations.cu",
             replaces="none: XLA's fusion of "
                      "marl_hideandseek_tpu/env/observations.py:226",
             launches=launches["observations"],
             serve_launches=serve["launches"]["observations"],
             eval_launches=evaluation["launches"]["observations"],
             train_launches=training["launches"]["observations"],
             library_ms=None, **k6, **new_paths("observations")),
        dict(name="levelgen", route="cuda",
             source="marl_hideandseek_torch/csrc/levelgen.cu",
             replaces="none: XLA's fusion of "
                      "marl_hideandseek_tpu/env/levelgen.py and geometry.py",
             launches=launches["levelgen"],
             classic_launches=classic["launches"]["levelgen"],
             serve_launches=serve["launches"]["levelgen"],
             eval_launches=evaluation["launches"]["levelgen"],
             train_launches=training["launches"]["levelgen"],
             library_ms=None, **k7, **new_paths("levelgen")),
        dict(launches=launches["threefry"],
             classic_launches=classic["launches"]["threefry"],
             serve_launches=serve["launches"]["threefry"],
             eval_launches=evaluation["launches"]["threefry"],
             train_launches=training["launches"]["threefry"], **threefry,
             **new_paths("threefry")),
    ]
    if args.profile:
        t0 = time.perf_counter()
        env = PackedEnv(cfg, device=dev)
        ps, _ = env.init()
        ps = profile_window(env, ps, 20, random_actions, gen, 0.0,
                            "no resets")
        profile_window(env, ps, 5, random_actions, gen, RESET_FRACTION,
                       "1 % resets")
        profile_forward(serve["forward"], 3)
        profile_update(training["mgr"])
        phase("profile", t0)
    phase("total", t_all)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def threefry_check(dev, gpu) -> dict:
    """The threefry kernel against its plain version, bit for bit: the
    bits mode on THREEFRY_KEYS keys x THREEFRY_WORDS words, each mode on
    ragged shapes (per-key and shared counters); the card's ``prng``
    draws against JAX's table; the kernel's time at a full reset's
    largest call (the level generator's poses: 16,384 worlds x 15 slots x
    2 keys, 42 uniforms each) and at the check's batch, beside the plain
    version's and the bound. Returns the kernel's JSON entry without
    launch counts."""
    from marl_hideandseek_torch import prng
    from marl_hideandseek_torch.ops import threefry as tfk

    def words(x):
        return x.view(torch.int32).long() & 0xFFFFFFFF

    def err(a, b):
        return int((words(a) - words(b)).abs().max())

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def u32(*shape):
        return torch.randint(0, 2 ** 32, shape, generator=gen, device=dev,
                             dtype=torch.long).to(torch.uint32)

    worst = 0
    keys = u32(THREEFRY_KEYS, 2)
    got = tfk.threefry(keys, None, THREEFRY_WORDS, tfk.BITS)
    want = tfk.threefry_plain(keys, None, THREEFRY_WORDS, tfk.BITS)
    worst = max(worst, err(got, want))
    del got, want
    for k, n, shared in ((13, 37, False), (1001, 5, True), (1, 4099, False),
                         (257, 1, False)):
        kk = u32(k, 2)
        ctr = u32(1 if shared else k, n, 2)
        for mode in (tfk.PAIRS, tfk.BITS, tfk.UNIFORM):
            for c in (ctr, None):
                a = tfk.threefry(kk, c, n, mode)
                b = tfk.threefry_plain(kk, c, n, mode)
                worst = max(worst, err(a, b))
    table = threefry_table(dev)
    bad = [k for k in THREEFRY_TABLE if table[k] != THREEFRY_TABLE[k]]
    log(f"threefry check: kernel vs plain, max abs difference of words "
        f"{worst} over {THREEFRY_KEYS} keys x {THREEFRY_WORDS} words and 4 "
        f"ragged shapes x 3 modes x 2 counter kinds; card's prng vs JAX's "
        f"table: {len(THREEFRY_TABLE) - len(bad)} of {len(THREEFRY_TABLE)} "
        f"entries equal {bad or ''}")
    require(worst == 0, f"threefry kernel differs from its plain version "
            f"by {worst}")
    require(not bad, f"threefry: the card's draws differ from JAX's in {bad}")

    def timing(k, n, mode):
        kk = u32(k, 2)
        ms = cuda_ms(lambda: tfk.threefry(kk, None, n, mode), 20)
        plain = cuda_ms(lambda: tfk.threefry_plain(kk, None, n, mode), 2)
        out_b = 8 if mode == tfk.PAIRS else 4
        n_bytes = 8 * k + out_b * k * n
        n_ops = THREEFRY_ITEM_OPS[mode] * k * n + THREEFRY_KEY_OPS * k
        b_ms, by = bound(n_bytes, n_ops, peak_ops=PEAK_INT32)
        return ms, plain, b_ms, by

    pose = (16384 * 15 * 2, 42, tfk.UNIFORM)
    ms, plain_ms, b_ms, by = timing(*pose)
    big_ms, big_plain, big_b, big_by = timing(THREEFRY_KEYS, THREEFRY_WORDS,
                                              tfk.BITS)
    log(f"threefry kernel: {ms:.4f} ms a launch at a full reset's pose "
        f"draws ({pose[0]} keys x {pose[1]} uniforms), plain {plain_ms:.3f} "
        f"ms, bound {b_ms:.5f} ms ({by}); {big_ms:.4f} ms at {THREEFRY_KEYS} "
        f"keys x {THREEFRY_WORDS} bits, plain {big_plain:.3f} ms, bound "
        f"{big_b:.5f} ms ({big_by}); INT32 peak {PEAK_INT32 / 1e12:.2f} "
        f"Top/s; {gpu}")
    return dict(name="threefry", route="cuda",
                source="marl_hideandseek_torch/csrc/threefry.cu",
                replaces="jax/_src/prng.py:883 (XLA's threefry2x32 "
                         "lowering; no Pallas kernel)",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None, batch_ms=big_ms,
                batch_plain_ms=big_plain, batch_bound_ms=big_b)


def seeded_policy(dev, gen):
    """The flagship policy at full width, SERVE_POLICIES policies drawn as
    flax draws them from PRNGKey(SEED); the zero-initialised leaves
    (biases, the critic's kernel) moved off zero from ``gen`` so that they
    take part. Returns (policy, params)."""
    from marl_hideandseek_torch import prng
    from marl_hideandseek_torch.policy import make_policy

    policy = make_policy(num_policies=SERVE_POLICIES, device=dev,
                         key=prng.key(SEED))
    params = dict(policy.actor_critic.named_parameters())
    with torch.no_grad():
        for p in params.values():
            if not bool(p.any()):
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    return policy, params


def seeded_stats(norm, obs, gen):
    """Normalizer statistics for observations ``obs`` ([N, ...] prepped):
    means drawn around 0 and variances in [0.5, 2) from ``gen``."""
    st = norm.init_state(obs)
    for k in st.mean:
        f = st.mean[k].shape
        st.mean[k] = (0.1 * torch.randn(f, generator=gen)).to(obs[k].device)
        st.var[k] = (0.5 + 1.5 * torch.rand(f, generator=gen)).to(
            obs[k].device)
    return st


def flat_obs(norm, obs):
    """[W, A, ...] observations -> prepped [W * A, ...]."""
    return {k: v.flatten(0, 1) for k, v in norm.prep(obs).items()}


def dense_macs(module, fn) -> int:
    """Multiply-adds of the dense products (``models/layers.py::Dense``)
    that ``fn()`` runs through ``module``, counted from each call's shapes
    by forward hooks."""
    from marl_hideandseek_torch.models.layers import Dense

    total = [0]

    def hook(mod, args, out):
        n_in = math.prod(mod.in_shape)
        rows = args[0].numel() // (args[0].shape[0] * n_in)
        total[0] += (mod.kernel.shape[0] * rows * n_in *
                     math.prod(mod.out_shape))

    hs = [m.register_forward_hook(hook) for m in module.modules()
          if isinstance(m, Dense)]
    try:
        fn()
    finally:
        for h in hs:
            h.remove()
    return total[0]


def serve_path(dev, gpu):
    """The inference loop (``infer.run_inference``) for SERVE_STEPS
    stochastic steps on the packed env with SERVE_POLICIES seeded flagship
    policies; per step finite logits, values and LSTM states, actions in
    their buckets, and a zero LSTM state for every agent whose episode
    ended; K4 on every step and K1 on the reset step; the ensemble forward
    on step SERVE_CHECK_AT's inputs against the same modules on the CPU
    for SERVE_CHECK_AGENTS agents; the forward's time and FLOP/s."""
    from marl_hideandseek_torch.config import EnvConfig, SimFlags
    from marl_hideandseek_torch.env import observations as O
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.infer import run_inference
    from marl_hideandseek_torch.models import DiscreteActionDistributions
    from marl_hideandseek_torch.models.actor_critic import tree_map
    from marl_hideandseek_torch.ops import rays, step
    from marl_hideandseek_torch.ops import threefry as tfk
    from marl_hideandseek_torch.ops import levelgen as LG
    from marl_hideandseek_torch.policy import make_policy
    from marl_hideandseek_torch.train.rollout import apply_ensemble

    require(not torch.backends.cuda.matmul.allow_tf32 and
            not torch.backends.cudnn.allow_tf32 and
            torch.get_float32_matmul_precision() == "highest",
            "TF32 must be off for the float32 forward")
    cfg = EnvConfig(
        num_worlds=WORLDS, min_hiders=2, max_hiders=2, min_seekers=2,
        max_seekers=2, rand_seed=SEED,
        sim_flags=SimFlags.UseFixedWorld | SimFlags.ZeroAgentVelocity)
    n = WORLDS * cfg.max_agents
    gen = torch.Generator().manual_seed(SEED)
    policy, params = seeded_policy(dev, gen)
    norm = policy.obs_preprocess
    small = PackedEnv(cfg.replace(num_worlds=8), device=dev)
    stats = seeded_stats(norm, flat_obs(norm, small.init()[1].obs), gen)
    buckets = torch.tensor(policy.actor_critic.actor.buckets, device=dev)
    env = PackedEnv(cfg, device=dev)
    ok = {"finite": torch.ones((), dtype=torch.bool, device=dev),
          "in_buckets": torch.ones((), dtype=torch.bool, device=dev),
          "cleared": torch.ones((), dtype=torch.bool, device=dev),
          "done_agents": torch.zeros((), dtype=torch.long, device=dev)}
    saved = {}
    pick = torch.randperm(n, generator=gen)[:SERVE_CHECK_AGENTS].to(dev)

    def on_step(d):
        leaves = [d["logits"], d["values"]] + [
            x for enc in d["rnn_next"] for x in enc]
        ok["finite"] &= torch.stack([torch.isfinite(x).all()
                                     for x in leaves]).all()
        ok["in_buckets"] &= ((d["actions"] >= 0) &
                             (d["actions"] < buckets)).all()
        done = d["result"].dones.T.reshape(-1).to(torch.float32)
        for x in (x for enc in d["rnn_next"] for x in enc):
            ok["cleared"] &= (x.abs() * done[None, :, None]).amax() == 0
        ok["done_agents"] += done.sum().to(torch.long)
        if d["step"] == cfg.episode_len - 2:
            torch.cuda.synchronize()
            saved["k1_before_reset"] = rays.RAYCAST.launches
        if d["step"] == SERVE_CHECK_AT:
            saved.update(
                obs={k: v.clone() for k, v in d["obs"].items()},
                rnn=tree_map(torch.clone, d["rnn"]),
                assignments=d["assignments"].clone(),
                logits=d["logits"][pick].clone(),
                values=d["values"][pick].clone(),
                rnn_next=tree_map(lambda x: x[:, pick].clone(),
                                  d["rnn_next"]),
                dones=int(d["dones"].sum()))

    rays.RAYCAST.launches = 0
    step.MEGASTEP.launches = 0
    tfk.THREEFRY.launches = 0
    O.OBSERVATIONS.launches = 0
    LG.LEVELGEN.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_inference(env, policy, params, stats, SERVE_STEPS,
                        iter_cb=on_step, timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"megastep": step.MEGASTEP.launches,
                "raycast": rays.RAYCAST.launches,
                "threefry": tfk.THREEFRY.launches,
                "observations": O.OBSERVATIONS.launches,
                "levelgen": LG.LEVELGEN.launches}
    # Per step: the step key's split, the buckets' split and their Gumbel
    # noise; more on the reset steps and at init.
    require(launches["threefry"] > 3 * SERVE_STEPS,
            f"serve path: threefry launches {launches['threefry']}, "
            f"expected more than {3 * SERVE_STEPS}")
    require(launches["megastep"] == SERVE_STEPS,
            f"serve path: K4 launches {launches['megastep']}, expected "
            f"{SERVE_STEPS}")
    require(launches["observations"] == SERVE_STEPS + 1,
            f"serve path: K6 launches {launches['observations']}, expected "
            f"{SERVE_STEPS + 1} (the loop's init and every step)")
    require(launches["raycast"] > saved["k1_before_reset"],
            f"serve path: no K1 launch on the reset step ({launches})")
    require(env.reset_counts["full"] >= 1, "serve path: no episode end")
    require(launches["levelgen"] == 1 + sum(env.reset_counts.values()),
            f"serve path: K7 launches {launches['levelgen']}, expected one "
            f"at init and one a reset step ({env.reset_counts})")
    require(bool(ok["finite"]), "serve path: non-finite logits, values or "
            "LSTM states")
    require(bool(ok["in_buckets"]), "serve path: an action outside its "
            "bucket")
    require(bool(ok["cleared"]) and int(ok["done_agents"]) >= n,
            f"serve path: LSTM state of done agents not zero after the "
            f"clear ({int(ok['done_agents'])} done agents)")
    require(saved["dones"] == 0, "serve path: an episode ended at the "
            "checked step")

    # Step SERVE_CHECK_AT's forward: card against the CPU, then timed.
    cpu_policy = make_policy(num_policies=SERVE_POLICIES, device="cpu")
    cpu_params = {k: v.detach().cpu() for k, v in params.items()}
    sub = lambda x: x[pick].cpu()
    cpu_obs = {k: sub(v) for k, v in saved["obs"].items()}
    cpu_rnn = tree_map(lambda x: x[:, pick].cpu(), saved["rnn"])
    cpu_stats = stats.to("cpu")
    with torch.no_grad():
        cpu_fwd = lambda: apply_ensemble(
            cpu_policy, cpu_params, cpu_rnn,
            norm.normalize(cpu_stats, cpu_obs), sub(saved["assignments"]),
            SERVE_POLICIES)
        lg, val, rnn_c = cpu_fwd()
        macs = dense_macs(cpu_policy.actor_critic, cpu_fwd)
    macs_agent = macs // (SERVE_CHECK_AGENTS * SERVE_POLICIES)
    errs = {"logits": max_err(saved["logits"].cpu(), lg),
            "values": max_err(saved["values"].cpu(), val),
            "rnn": max(max_err(a.cpu(), b) for a, b in zip(
                [x for enc in saved["rnn_next"] for x in enc],
                [x for enc in rnn_c for x in enc]))}
    buck = tuple(policy.actor_critic.actor.buckets)
    best_eq = (DiscreteActionDistributions(buck, saved["logits"].cpu())
               .best() == DiscreteActionDistributions(buck, lg).best()
               ).all(-1).float().mean().item()
    log(f"serve forward, card vs CPU on {SERVE_CHECK_AGENTS} agents of step "
        f"{SERVE_CHECK_AT}: max abs err {errs}; best() equal on {best_eq:.6f};"
        f" TF32 off")
    require(max(errs.values()) <= SERVE_BAR,
            f"serve forward: card vs CPU {errs} > {SERVE_BAR}")
    require(best_eq >= SERVE_BEST_SHARE,
            f"serve forward: best() equal on {best_eq} < {SERVE_BEST_SHARE}")

    full_obs = norm.normalize(stats, saved["obs"])
    fwd = lambda: apply_ensemble(policy, params, saved["rnn"], full_obs,
                                 saved["assignments"], SERVE_POLICIES)
    with torch.no_grad():
        fwd_ms = cuda_ms(fwd, 10)
    flop = 2.0 * macs_agent * n * SERVE_POLICIES
    step_ms = out["forward_ms"] + out["env_ms"]
    log(f"serve path: {SERVE_STEPS} steps x {WORLDS} worlds x "
        f"{SERVE_POLICIES} policies; per step (CUDA events in the loop) "
        f"forward {out['forward_ms']:.3f} ms (normalize, ensemble, draw) + "
        f"env step {out['env_ms']:.3f} ms = {step_ms:.3f} ms, serve rate "
        f"{WORLDS / step_ms * 1e3:.1f} steps x worlds / s, "
        f"{WORLDS * cfg.max_agents / step_ms * 1e3:.1f} agent steps / s; "
        f"wall with init and checks {wall:.3f} s = "
        f"{SERVE_STEPS * WORLDS / wall:.1f} steps x worlds / s; resets "
        f"{env.reset_counts}; launches {launches}; {gpu}")
    log(f"serve forward alone: {fwd_ms:.3f} ms per step of {n} agents x "
        f"{SERVE_POLICIES} policies = "
        f"{n * SERVE_POLICIES / fwd_ms * 1e3:.4g} agent-policy forwards / s;"
        f" {macs_agent} multiply-adds per agent per policy, "
        f"{flop / 1e12:.4f} TFLOP a step, {flop / fwd_ms / 1e9:.4g} TFLOP/s "
        f"= {flop / fwd_ms / 1e9 / (PEAK_F32 / 1e12):.4f} of the "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s FP32 peak (least time "
        f"{flop / PEAK_F32 * 1e3:.3f} ms); {gpu}")
    return dict(policy=policy, params=params, launches=launches,
                forward=fwd)


def eval_path(dev, policy, params, gpu):
    """``eval_policies`` for EVAL_STEPS competitive steps with the serve
    path's policies on the classic env at headless.py's configuration and
    EVAL_WORLDS worlds: K3 on every step, K1 on the reset steps, at least
    one finished episode, and ELOs moved from 1,500 and finite."""
    from marl_hideandseek_torch.config import EnvConfig, SimFlags
    from marl_hideandseek_torch.env import observations as O
    from marl_hideandseek_torch.env.env import HideAndSeekEnv
    from marl_hideandseek_torch.ops import fused, rays
    from marl_hideandseek_torch.ops import threefry as tfk
    from marl_hideandseek_torch.ops import levelgen as LG
    from marl_hideandseek_torch.train import (
        ActionsConfig,
        EvalConfig,
        eval_policies,
    )
    from marl_hideandseek_torch.train.elo import ELO_START

    cfg = EnvConfig(num_worlds=EVAL_WORLDS, min_hiders=3, max_hiders=3,
                    min_seekers=2, max_seekers=2,
                    sim_flags=SimFlags.Default, rand_seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 3)
    norm = policy.obs_preprocess
    small = HideAndSeekEnv(cfg.replace(num_worlds=4), device=dev)
    stats = seeded_stats(norm, flat_obs(norm, small.init()[1].obs), gen)
    env = HideAndSeekEnv(cfg, device=dev)
    ecfg = EvalConfig(num_worlds=EVAL_WORLDS, num_teams=2, team_size=3,
                      num_eval_steps=EVAL_STEPS, actions=ActionsConfig())
    fused.FUSED.launches = 0
    rays.RAYCAST.launches = 0
    tfk.THREEFRY.launches = 0
    O.OBSERVATIONS.launches = 0
    LG.LEVELGEN.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eval_policies(dev, ecfg, env, policy, params, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused": fused.FUSED.launches,
                "raycast": rays.RAYCAST.launches,
                "threefry": tfk.THREEFRY.launches,
                "observations": O.OBSERVATIONS.launches,
                "levelgen": LG.LEVELGEN.launches}
    elo = out["elo"].cpu()
    log(f"eval path: {EVAL_STEPS} steps x {EVAL_WORLDS} worlds in "
        f"{wall:.3f} s = {EVAL_STEPS * EVAL_WORLDS / wall:.1f} steps x "
        f"worlds / s; episodes finished {out['episodes_finished']}; ELOs "
        f"{[round(float(e), 3) for e in elo]}; launches {launches}; {gpu}")
    require(launches["fused"] == EVAL_STEPS and launches["raycast"] > 0 and
            launches["threefry"] > 3 * EVAL_STEPS and
            launches["observations"] >= EVAL_STEPS,
            f"eval path launches {launches}")
    require(out["episodes_finished"] >= 1, "eval path: no episode finished")
    require(launches["levelgen"] == 1 + sum(env.reset_counts.values()),
            f"eval path: K7 launches {launches['levelgen']}, expected one "
            f"at init and one a reset step ({env.reset_counts})")
    require(bool(torch.isfinite(elo).all()) and
            float((elo - ELO_START).abs().max()) > 0.0,
            f"eval path: ELOs {elo.tolist()} did not move or are not finite")
    return dict(launches=launches)


KERNEL_COUNTERS = {"raycast": ("ops.rays", "RAYCAST"),
                   "physics": ("ops.physics", "PHYSICS"),
                   "fused": ("ops.fused", "FUSED"),
                   "megastep": ("ops.step", "MEGASTEP"),
                   "rgbd": ("ops.rgbd", "RGBD"),
                   "threefry": ("ops.threefry", "THREEFRY"),
                   "observations": ("env.observations", "OBSERVATIONS"),
                   "levelgen": ("ops.levelgen", "LEVELGEN")}


def kernel_counters() -> dict:
    """Each kernel wrapper (``ops/*.py``, ``env/observations.py``) by the
    name of the ``kernels`` line."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"marl_hideandseek_torch.{mod}"), attr)
        for name, (mod, attr) in KERNEL_COUNTERS.items()}


def zero_counts() -> None:
    for k in kernel_counters().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in kernel_counters().items()}


def train_args(tmp: str, device: str, *extra: str):
    """``python -m marl_hideandseek_torch.train``'s arguments for
    train.sh's recipe (1,024 worlds, 2v2, PBT 2 + 2) on ``device``, with
    ``extra`` appended (later flags win)."""
    from marl_hideandseek_torch.train import __main__ as cli

    return cli.parse_args([
        "--ckpt-dir", tmp, "--tb-dir", tmp, "--run-name", "smoke",
        "--num-worlds", str(TRAIN_WORLDS), "--num-updates",
        str(TRAIN_UPDATES), "--pbt-ensemble-size", "2",
        "--pbt-past-policies", "2", "--num-hiders", "2", "--num-seekers",
        "2", "--device", device, *extra])


def train_run(dev, args, updates: int, mesh=None) -> dict:
    """The train CLI's ``build`` of ``args``, ``init_training`` over
    ``mesh`` (one process by default) and ``updates`` ``update_iter``,
    with every kernel count set to 0 just before: the states before and
    after each update, each update's (start, rollout end, end) host
    times, the first update's buffer and ``ppo_update`` result, and the
    launches after the init and after the updates."""
    from unittest import mock

    from marl_hideandseek_torch.parallel.mesh import LOCAL
    from marl_hideandseek_torch.train import TrainHooks, init_training
    from marl_hideandseek_torch.train import __main__ as cli
    from marl_hideandseek_torch.train import manager

    env, cfg, policy = cli.build(args)

    class Marks(TrainHooks):
        def __init__(self):
            self.t, self.buffer = [], None

        def post_rollout(self, update_idx, buffer, metrics):
            sync(dev)
            self.t.append(time.perf_counter())
            if self.buffer is None:
                self.buffer = buffer
            return metrics

    hooks, first = Marks(), []

    def recording(*a, **kw):
        out = manager_update(*a, **kw)
        if not first:
            first.append(out)
        return out

    manager_update = manager.ppo_update
    zero_counts()
    with mock.patch.object(manager, "ppo_update", recording):
        mgr = init_training(dev, cfg, env, policy, hooks=hooks,
                            mesh=mesh or LOCAL)
        init_launches = read_counts()
        states, marks = [mgr.state], []
        for _ in range(updates):
            sync(dev)
            t0 = time.perf_counter()
            mgr = mgr.update_iter()
            sync(dev)
            marks.append((t0, hooks.t[-1], time.perf_counter()))
            states.append(mgr.state)
    return dict(env=env, cfg=cfg, policy=policy, mgr=mgr, states=states,
                marks=marks, buffer=hooks.buffer, update1=first[0],
                init_launches=init_launches, launches=read_counts())


def sync(dev) -> None:
    """Wait for the card (``dev`` a CUDA device)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def train_rate(run: dict, worlds: int) -> float:
    """scripts/train.py's FPS over updates 2 to the last."""
    marks = run["marks"]
    return (worlds * run["cfg"].steps_per_update * (len(marks) - 1) /
            (marks[-1][2] - marks[0][2]))


def check_slice_update(cfg, policy, cpu_policy, run, n, dev, kinds, label):
    """The first update's ``ppo_update`` on its buffer's first ``n``
    agents on the card against the CPU's, at the CPU update's rounding
    bars (``testing.rounding_bars``, observations moved one ulp of their
    dtype; ``kinds`` the bars derived from that spread). Returns the
    comparison's worst readings."""
    from marl_hideandseek_torch import testing

    s0, s1, buf = run["states"][0], run["states"][1], run["buffer"]
    cpu = torch.device("cpu")
    got = slice_update(cfg, policy, s0, s1, buf, n, dev)
    want, bars = testing.rounding_bars(
        lambda o: slice_update(cfg, cpu_policy, s0, s1, buf, n, cpu, o),
        buffer_slice(buf, n, cpu).obs, kinds)
    lr_max = float(s0.hyper_params["lr"].max())
    cmp = testing.compare_updates(got, want, s0.params, bars, lr_max,
                                  cfg.algo.num_epochs)
    widened = sorted((v, k) for k, v in bars.items()
                     if k[0] in ("mu", "nu") and
                     v > testing.FIXED_BARS[k[0]])
    log(f"{label} PPO update, card vs CPU on {n // 4} worlds ({n} agents) "
        f"of update 1's buffer, at the update's rounding bars (derived: "
        f"{', '.join(kinds)}; {len(widened)} moment leaves over the fixed "
        f"bar, widest {widened[-1] if widened else None}): worst error "
        f"over its bar {({k: (round(r, 4), leaf) for k, (r, leaf) in cmp['worst'].items()})}"
        f"; TF32 off")
    require(not cmp["violations"], f"{label}: card and CPU PPO updates "
            f"disagree: {cmp['violations'][:8]}")
    return cmp["worst"]


def train_path(dev, gpu, ckpt_dir: str):
    """Training at train.sh's recipe through the entry points of ``python
    -m marl_hideandseek_torch.train`` (its ``build``, ``init_training``,
    ``update_iter``, ``eval_elo``, PBT and checkpoints), float32 with TF32
    off: TRAIN_UPDATES updates, one ELO pass, ``explore_exploit`` and
    ``refresh_past_policies`` on the card state, a checkpoint round trip
    (its file kept in ``ckpt_dir``), and the first update's ``ppo_update`` on a TRAIN_CHECK_WORLDS slice of
    its buffer against the CPU's at its rounding bars. K4 on every rollout
    and eval step, K1 on the init and reset steps. Prints the training
    rate over updates 2 to TRAIN_UPDATES, rollout and PPO ms per update
    and the PPO update's FLOP/s against the FP32 peak."""
    import tempfile

    from marl_hideandseek_torch.policy import make_policy
    from marl_hideandseek_torch.train import eval_elo
    from marl_hideandseek_torch.train import pbt, ppo
    from marl_hideandseek_torch.train.elo import ELO_START

    with tempfile.TemporaryDirectory() as tmp:
        run = train_run(dev, train_args(tmp, dev.type), TRAIN_UPDATES)
        env, cfg, policy, mgr = (run[k] for k in ("env", "cfg", "policy",
                                                  "mgr"))
        require(ppo.use_grouped_ppo(cfg) and cfg.dreamer_v3_critic and
                cfg.total_policies == 4, "train path: not the recipe's "
                "grouped PBT 2 + 2 with the Dreamer critic")
        k1_init = run["init_launches"]["raycast"]
        tf_init = run["init_launches"]["threefry"]
        k1_train = run["launches"]["raycast"]
        k4_train = run["launches"]["megastep"]
        tf_train = run["launches"]["threefry"] - tf_init
        lg_init = run["init_launches"]["levelgen"]
        lg_train = run["launches"]["levelgen"]
        resets_train = sum(env.reset_counts.values())
        elo_train = mgr.state.elo.clone()
        mgr = eval_elo(mgr)
        launches = read_counts()
        resets_eval = sum(env.reset_counts.values()) - resets_train
        st = mgr.state
        n_steps = TRAIN_UPDATES * cfg.steps_per_update
        eval_steps = cfg.steps_per_update * 6
        log(f"train path launches: K4 {k4_train} in {n_steps} rollout steps, "
            f"{launches['megastep'] - k4_train} in {eval_steps} eval_elo "
            f"steps; K1 {k1_init} at init, {k1_train - k1_init} in training, "
            f"{launches['raycast'] - k1_train} in eval_elo; resets "
            f"{env.reset_counts}; threefry {tf_init} at init, {tf_train} in "
            f"{TRAIN_UPDATES} updates ({tf_train / TRAIN_UPDATES:.1f} an "
            f"update), {launches['threefry'] - tf_init - tf_train} in "
            f"eval_elo")
        require(tf_init > 0 and tf_train > 3 * n_steps,
                f"train path: threefry launches {tf_init} at init and "
                f"{tf_train} in {n_steps} rollout steps")
        require(k4_train == n_steps and
                launches["megastep"] == n_steps + eval_steps,
                f"train path: K4 launches {k4_train} and "
                f"{launches['megastep']}, expected {n_steps} and "
                f"{n_steps + eval_steps}")
        require(k1_init > 0 and k1_train > k1_init and
                launches["raycast"] > k1_train,
                f"train path: K1 not launched on the init and reset steps "
                f"({k1_init}, {k1_train}, {launches['raycast']})")
        # eval_elo steps on from the rollout's state: no init there.
        require(lg_init == 1 and resets_train >= 1 and
                lg_train - lg_init == resets_train and
                launches["levelgen"] - lg_train == resets_eval,
                f"train path: K7 launches {lg_init} at init, "
                f"{lg_train - lg_init} in training with {resets_train} reset "
                f"steps, {launches['levelgen'] - lg_train} in eval_elo with "
                f"{resets_eval} (one at the init and on each reset step)")

        metrics = {k: v.cpu() for k, v in st.metrics.items()}
        require(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
                f"train path: non-finite metrics {metrics}")
        require(float(metrics["loss"][:TRAIN_UPDATES].abs().min()) > 0.0,
                "train path: an update with a zero loss")
        states = run["states"]
        moved = {k: float((v - states[0].params[k]).abs().amax(
            dim=tuple(range(1, v.dim()))).min()) for k, v in st.params.items()}
        require(min(moved.values()) > 0.0, "train path: a train policy's "
                f"parameter did not move: {min(moved, key=moved.get)}")
        count = st.opt_states.count.tolist()
        require(count == [cfg.algo.num_epochs * TRAIN_UPDATES] * 2,
                f"train path: Adam counts {count}")
        require(float((elo_train - ELO_START).abs().max()) > 0.0 and
                float((st.elo - elo_train).abs().max()) > 0.0 and
                bool(torch.isfinite(st.elo).all()),
                f"train path: ELOs did not move ({elo_train.tolist()}, "
                f"{st.elo.tolist()})")

        # PBT on the card state.
        elo = st.elo
        require(float(elo[0]) != float(elo[1]), "train path: the train "
                "policies' ELOs tie, so explore_exploit copies nothing")
        best, worst = int(torch.argmax(elo[:2])), int(torch.argmin(elo[:2]))
        p2, o2, h2 = pbt.explore_exploit(cfg, st.key, elo, st.params,
                                         st.opt_states, st.hyper_params)
        copied = all(torch.equal(v[worst], v[best]) for v in p2.values()) and \
            all(torch.equal(m[k][worst], m[k][best])
                for m in (o2.mu, o2.nu) for k in m) and \
            int(o2.count[worst]) == int(o2.count[best])
        require(copied, "train path: explore_exploit did not copy the best "
                "policy's parameters and Adam state into the worst")
        past2, elo2 = pbt.refresh_past_policies(
            cfg, cfg.pbt.past_policy_update_interval, p2, st.past_params, elo)
        require(all(torch.equal(past2[k][1], p2[k][best]) for k in past2) and
                float(elo2[3]) == float(elo[best]),
                "train path: refresh_past_policies did not snapshot the best "
                "policy into past slot 1")
        log(f"train path PBT: best {best}, worst {worst}, lr "
            f"{st.hyper_params['lr'].tolist()} -> {h2['lr'].tolist()}, "
            f"entropy coef {st.hyper_params['entropy_coef'].tolist()} -> "
            f"{h2['entropy_coef'].tolist()}")

        # Checkpoint round trip.
        path = mgr.save_ckpt(ckpt_dir)
        back = mgr.restore_ckpt(path)
        a, b = flat_tree(mgr.state_tree()), flat_tree(back.state_tree())
        require(a.keys() == b.keys() and all(same(a[k], b[k]) for k in a),
                "train path: the restored checkpoint differs")
        log(f"train path checkpoint: {len(a)} leaves equal after save_ckpt "
            f"and restore_ckpt ({os.path.getsize(path)} B)")

    fps = train_rate(run, TRAIN_WORLDS)
    marks = run["marks"]
    roll_ms = [(m[1] - m[0]) * 1e3 for m in marks[1:]]
    ppo_ms = [(m[2] - m[1]) * 1e3 for m in marks[1:]]

    # The first update's PPO on a slice of its buffer, card against CPU.
    from marl_hideandseek_torch import testing

    check_slice_update(cfg, policy, make_policy(device="cpu"), run,
                       TRAIN_CHECK_WORLDS * 4, dev, testing.FLOAT32_KINDS,
                       "train path")

    # FLOP of one update: the forward's multiply-adds over the gathered
    # batch, the backward twice the forward, per epoch.
    s0, s1, buf = states[0], states[1], run["buffer"]
    macs = ppo_forward_macs(cfg, policy, s0, s1, buf)
    flop = 2.0 * macs * 3 * cfg.algo.num_epochs
    ppo_mean = sum(ppo_ms) / len(ppo_ms)
    log(f"train path: {TRAIN_UPDATES} updates x {cfg.steps_per_update} steps "
        f"x {TRAIN_WORLDS} worlds, 2v2, PBT 2 + 2 grouped, float32: "
        f"{fps:.1f} steps x worlds / s over updates 2-{TRAIN_UPDATES} "
        f"(scripts/train.py's FPS); per update rollout "
        f"{sum(roll_ms) / len(roll_ms):.1f} ms, PPO (normalizer update, PPO, "
        f"ELO) {ppo_mean:.1f} ms; rollout ms {[round(x, 1) for x in roll_ms]}"
        f", PPO ms {[round(x, 1) for x in ppo_ms]}; {gpu}")
    log(f"train path PPO update: {macs} forward multiply-adds an epoch, "
        f"{flop / 1e12:.4f} TFLOP an update (backward 2x forward), "
        f"{flop / ppo_mean / 1e9:.4g} TFLOP/s = "
        f"{flop / ppo_mean / 1e9 / (PEAK_F32 / 1e12):.4f} of the "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s FP32 peak (least time "
        f"{flop / PEAK_F32 * 1e3:.3f} ms); ELOs {st.elo.tolist()}; "
        f"metrics {ring_means(metrics, TRAIN_UPDATES)}; {gpu}")
    return dict(launches=launches, mgr=mgr, run=run, fps=fps, ckpt=path)


def dp_nccl_1(dev, mgr, gpu) -> dict:
    """One ``update_iter`` of the train path's final state over a mesh of
    one NCCL rank, against the same update without a mesh: bit for bit
    (the all-reduces are identities, and nothing else differs). Runs the
    NCCL code path of the data-parallel update on the one card."""
    from marl_hideandseek_torch import testing
    from marl_hideandseek_torch.parallel.mesh import make_mesh
    from marl_hideandseek_torch.utils import runtime

    import torch.distributed as dist

    plain = mgr.update_iter()
    runtime.init_distributed(f"localhost:{testing.free_port()}", 1, 0,
                             backend="nccl", device=dev)
    try:
        mesh = make_mesh()
        require(mesh.size == 1 and mesh.backend == "nccl",
                f"dp_nccl_1: mesh {mesh}")
        zero_counts()
        t0 = time.perf_counter()
        nccl = mgr.replace(mesh=mesh).update_iter()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        dist.destroy_process_group()
    a, b = flat_tree(plain.state_tree()), flat_tree(nccl.state_tree())
    differ = [k for k in a if not same(a[k], b[k])]
    if differ:
        again = flat_tree(mgr.update_iter().state_tree())
        repeat = [k for k in a if not same(a[k], again[k])]
        raise SystemExit(f"chip_smoke FAILED: dp_nccl_1: {len(differ)} of "
                         f"{len(a)} leaves differ from the update without a "
                         f"mesh ({differ[:6]}); the update without a mesh "
                         f"run twice differs on {len(repeat)}")
    log(f"dp_nccl_1: one update over a 1-rank NCCL mesh equals the update "
        f"without a mesh bit for bit on all {len(a)} state leaves; "
        f"{wall * 1e3:.1f} ms; launches {launches}; {gpu}")
    return dict(launches=launches)


def train_bf16(dev, gpu, fps32: float) -> dict:
    """train.sh's recipe as written: ``--bf16`` (the policy's products in
    bf16), EXTRA_UPDATES updates; the first update's PPO on a slice of its
    buffer against the CPU's bf16 update at rounding bars from bf16 ulp
    moves of the observations; the bf16 ensemble forward on the card
    against the CPU's at tests/test_torch_policy.py's BF16_BAR; the rate
    beside the float32 one of the same call."""
    import tempfile

    from marl_hideandseek_torch import testing
    from marl_hideandseek_torch.models.actor_critic import tree_map
    from marl_hideandseek_torch.policy import make_policy
    from marl_hideandseek_torch.train.rollout import apply_ensemble

    with tempfile.TemporaryDirectory() as tmp:
        run = train_run(dev, train_args(tmp, dev.type, "--bf16"),
                        EXTRA_UPDATES)
    cfg, policy, mgr = run["cfg"], run["policy"], run["mgr"]
    buf = run["buffer"]
    require(cfg.compute_dtype == torch.bfloat16 and
            buf.obs["self_data"].dtype == torch.bfloat16,
            f"train_bf16: compute dtype {cfg.compute_dtype}, observations "
            f"{buf.obs['self_data'].dtype}")
    finite_state("train_bf16", mgr)
    cpu_policy = make_policy(dtype=torch.bfloat16, device="cpu")
    worst = check_slice_update(cfg, policy, cpu_policy, run,
                               TRAIN_CHECK_WORLDS * 4, dev,
                               testing.ALL_KINDS, "train_bf16")

    # The forward: step 0 of the first rollout, BF16_CHECK_AGENTS agents.
    s0 = run["states"][0]
    n = BF16_CHECK_AGENTS
    norm = policy.obs_preprocess
    params = {k: torch.cat([v, s0.past_params[k]]) for k, v in
              s0.params.items()}
    inputs = ({k: v[0, 0, :n] for k, v in buf.obs.items()},
              tree_map(lambda x: x[0, :, :n], buf.rnn_start_states),
              buf.assignments[0, 0, :n])

    def forward(pol, d):
        obs, rnn, assign = (tree_map(lambda x: x.to(d), t) for t in inputs)
        with torch.no_grad():
            out = apply_ensemble(
                pol, {k: v.to(d) for k, v in params.items()}, rnn,
                norm.normalize(s0.obs_stats.to(d), obs), assign,
                cfg.total_policies, num_train=cfg.num_train_policies)
        return [x.float().cpu() for x in (out[0], out[1],
                                          *flat_tree(out[2]).values())]

    fwd_err = max(max_err(a, b) for a, b in zip(
        forward(policy, dev), forward(cpu_policy, torch.device("cpu"))))
    require(fwd_err <= BF16_BAR, f"train_bf16: the bf16 forward on the card "
            f"is {fwd_err} from the CPU's (bar {BF16_BAR})")
    fps = train_rate(run, TRAIN_WORLDS)
    marks = run["marks"]
    launches = run["launches"]
    log(f"train_bf16: {EXTRA_UPDATES} updates at train.sh's recipe as "
        f"written (bf16), {fps:.1f} steps x worlds / s over updates "
        f"2-{EXTRA_UPDATES} beside float32's {fps32:.1f} in this call "
        f"(updates 2-{TRAIN_UPDATES}); rollout ms "
        f"{[round((m[1] - m[0]) * 1e3, 1) for m in marks]}, PPO ms "
        f"{[round((m[2] - m[1]) * 1e3, 1) for m in marks]}; the bf16 "
        f"forward on {n} agents within {fwd_err:.4g} of the CPU's (bar "
        f"{BF16_BAR}); launches {launches}; {gpu}")
    require(launches["megastep"] == EXTRA_UPDATES * cfg.steps_per_update and
            launches["raycast"] > 0, f"train_bf16: launches {launches}")
    return dict(launches=launches, fps=fps, worst=worst, fwd_err=fwd_err)


def train_3v3(dev, gpu) -> dict:
    """scripts/train.py's default teams, 3 hiders and 3 seekers, at
    train.sh's other settings in bf16: EXTRA_UPDATES updates at 1,024
    worlds; finite state, grouped PPO on, the dropped agent share, the
    launches and the rate."""
    import tempfile

    from marl_hideandseek_torch.train import ppo

    with tempfile.TemporaryDirectory() as tmp:
        run = train_run(dev, train_args(tmp, dev.type, "--bf16",
                                        "--num-hiders", "3",
                                        "--num-seekers", "3"),
                        EXTRA_UPDATES)
    cfg, mgr = run["cfg"], run["mgr"]
    require(ppo.use_grouped_ppo(cfg) and run["env"].cfg.max_agents == 6,
            "train_3v3: not 3v3 with grouped PPO")
    finite_state("train_3v3", mgr)
    fps = train_rate(run, TRAIN_WORLDS)
    dropped = mgr.state.metrics["dropped_agent_frac"][:EXTRA_UPDATES]
    launches = run["launches"]
    log(f"train_3v3: {EXTRA_UPDATES} updates, 3v3, PBT 2 + 2 grouped, bf16, "
        f"{TRAIN_WORLDS} worlds: {fps:.1f} steps x worlds / s over updates "
        f"2-{EXTRA_UPDATES}; dropped agent share per update "
        f"{dropped.tolist()}; K4 {launches['megastep']}, K1 "
        f"{launches['raycast']} (init {run['init_launches']['raycast']}), "
        f"threefry {launches['threefry']}; {gpu}")
    require(launches["megastep"] == EXTRA_UPDATES * cfg.steps_per_update and
            launches["raycast"] > 0, f"train_3v3: launches {launches}")
    return dict(launches=launches, fps=fps)


def _dp_rank(rank: int, nprocs: int, address: str, out_dir: str,
             device: str, worlds: int, updates: int) -> None:
    """One rank of ``dp_path``: train.sh's recipe at ``worlds`` global
    worlds in float32 over a gloo mesh of ``nprocs`` ranks, all on
    ``device``, ``updates`` updates; writes its buffer of update 1,
    post-rollout state, first update, ELOs, hyperparameters, parameters,
    times and launches to ``<out_dir>/rank<rank>.pt``."""
    import tempfile

    import torch.distributed as dist

    from marl_hideandseek_torch.models.actor_critic import tree_map
    from marl_hideandseek_torch.parallel.mesh import make_mesh
    from marl_hideandseek_torch.utils import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    dev = runtime.init_distributed(address, nprocs, rank, backend="gloo",
                                   device=device)
    try:
        mesh = make_mesh()
        with tempfile.TemporaryDirectory() as tmp:
            run = train_run(dev, train_args(tmp, str(dev), "--num-worlds",
                                            str(worlds)), updates, mesh)
        host = lambda t: tree_map(lambda x: x.cpu(), t)
        params, opt, _, metrics = run["update1"]
        out = {
            "buffer": host(dict(vars(run["buffer"]))),
            "rollout1": host(run["mgr"].replace(
                state=run["states"][1]).state_tree()["rollout"]),
            "update1": host({"params": params, "mu": opt.mu, "nu": opt.nu,
                             "count": opt.count, "metrics": metrics}),
            "elo": [st.elo.cpu() for st in run["states"]],
            "hyper": [host(st.hyper_params) for st in run["states"]],
            "params": host(run["states"][-1].params),
            "marks": run["marks"], "fps": train_rate(run, worlds),
            "launches": run["launches"],
            "init_launches": run["init_launches"],
        }
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def held_to(got: dict, want: dict, label: str) -> list:
    """Two flat trees leaf by leaf: equal bit for bit, or at the chained
    steps' bars (floats within JAX_BARS for pos, quat, vel and omega and
    1e-3 otherwise on >= 99.5 % of the elements, integers and flags equal
    on >= 99.9 %). Returns the leaves that differ, with their share
    within the bar and largest error."""
    differ = []
    for k, w in want.items():
        g = got[k]
        if same(g, w):
            continue
        g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
        if w.dtype == torch.uint32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if w.is_floating_point():
            bar = JAX_BARS.get(k.split(".")[-1], 1e-3)
            ok = (g == w) | ((g.float() - w.float()).abs() <= bar)
            need = 0.995
        else:
            ok, need = g == w, 0.999
        share = float(ok.float().mean())
        differ.append(f"{k} {share:.6f} within bar, max {max_err(g, w):.3g}")
        require(share >= need, f"{label}: {k} within its bar on {share} "
                f"of its elements (needs {need})")
    return differ


def dp_path(dev, gpu, train: dict) -> dict:
    """DP_RANKS ranks on the one card under gloo (NCCL refuses two ranks
    on one device; gloo's collectives on card tensors go through host
    memory), each with TRAIN_WORLDS / DP_RANKS of train.sh's worlds in
    float32, EXTRA_UPDATES updates, spawned after the kernels were built.
    Each rank's buffer of update 1 and post-rollout state against its
    slice of the train path's single-process run (same seed): equal, or
    at the chained steps' bars with the reason printed; each rank's first
    update against the train path's at the update's rounding bars
    (measured on the card on the whole buffer); ELOs, hyperparameters and
    parameters equal on every rank; the rate, labelled."""
    import dataclasses
    import tempfile

    from marl_hideandseek_torch import prng, testing
    from marl_hideandseek_torch.models.actor_critic import tree_map
    from marl_hideandseek_torch.train import ppo

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        testing.spawn_ranks(_dp_rank, DP_RANKS, (out, str(dev), TRAIN_WORLDS,
                                                 EXTRA_UPDATES), timeout=600)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_RANKS)]
    run = train["run"]
    cfg, policy = run["cfg"], run["policy"]
    s0, s1, buf = run["states"][0], run["states"][1], run["buffer"]
    ref_rollout = run["mgr"].replace(state=s1).state_tree()["rollout"]
    n = TRAIN_WORLDS * 4 // DP_RANKS
    w = TRAIN_WORLDS // DP_RANKS

    notes = []
    for r, got in enumerate(ranks):
        a = slice(r * n, (r + 1) * n)
        want_buf = {k: tree_map(lambda x: x[a] if k == "bootstrap_value"
                                else x[:, :, a], v)
                    for k, v in vars(buf).items()}
        differ = held_to(flat_tree(got["buffer"]), flat_tree(want_buf),
                         f"dp_path rank {r} buffer")
        ro = ref_rollout
        want_ro = {"env_state": {k: x[..., r * w:(r + 1) * w] for k, x in
                                 flat_tree(ro["env_state"]).items()},
                   "obs": {k: x[a] for k, x in ro["obs"].items()},
                   "rnn_states": tuple(tuple(x[:, a] for x in e)
                                       for e in ro["rnn_states"]),
                   "assignments": ro["assignments"][a], "key": ro["key"]}
        got_ro = dict(got["rollout1"])
        got_ro["env_state"] = flat_tree(got_ro["env_state"])
        differ += held_to(flat_tree(got_ro), flat_tree(want_ro),
                          f"dp_path rank {r} post-rollout state")
        if differ:
            step0 = all(same(got["buffer"]["obs"][k][0, 0], v[0, 0, a])
                        for k, v in buf.obs.items())
            lp0 = max_err(got["buffer"]["log_probs"][0, 0],
                          buf.log_probs[0, 0, a].cpu())
            notes.append(
                f"rank {r}: {len(differ)} leaves differ "
                f"({[d.split()[0] for d in differ]}; {differ[:3]}); the "
                f"first step's observations "
                f"{'equal' if step0 else 'differ'}, its log-probabilities "
                f"differ by {lp0:.3g}: " +
                (f"from equal inputs the forward at the rank's {n} agents "
                 f"rounds otherwise than at {n * DP_RANKS}, and the steps "
                 "carry that" if step0 else "the env's first step "
                 "differs"))

    # The first update at its rounding bars, measured on the card.
    k_ppo = prng.split(s0.key, 3)[1]

    def update(obs):
        return ppo.ppo_update(cfg, policy, s0.params, s0.opt_states,
                              s1.obs_stats, s0.value_stats, s0.hyper_params,
                              dataclasses.replace(buf, obs=obs), k_ppo)

    base, bars = testing.rounding_bars(update, buf.obs,
                                       testing.FLOAT32_KINDS)
    want = run["update1"]
    repeat = all(same(a, b) for a, b in zip(flat_tree(base[0]).values(),
                                            flat_tree(want[0]).values()))
    lr_max = float(s0.hyper_params["lr"].max())
    worst = []
    for r, got in enumerate(ranks):
        u = got["update1"]
        cmp = testing.compare_updates(
            (u["params"], ppo.AdamState(mu=u["mu"], nu=u["nu"],
                                        count=u["count"]), None,
             u["metrics"]), want, s0.params, bars, lr_max,
            cfg.algo.num_epochs)
        require(not cmp["violations"], f"dp_path rank {r}: update 1 "
                f"against the single process's: {cmp['violations'][:8]}")
        worst.append({k: (round(x, 4), leaf)
                      for k, (x, leaf) in cmp["worst"].items()})
    for k in ("elo", "hyper", "params"):
        a, b = (flat_tree(got[k]) for got in ranks[:2])
        require(all(same(a[j], b[j]) for j in a),
                f"dp_path: the ranks' {k} differ")
    elo_same = all(same(x, st.elo) for x, st in
                   zip(ranks[0]["elo"], run["states"]))
    launches = [got["launches"] for got in ranks]
    for r, got in enumerate(ranks):
        require(got["launches"]["megastep"] ==
                EXTRA_UPDATES * cfg.steps_per_update and
                got["init_launches"]["raycast"] > 0,
                f"dp_path rank {r}: launches {got['launches']}")
    fps = ranks[0]["fps"]
    log(f"dp_path: {DP_RANKS} ranks x {TRAIN_WORLDS // DP_RANKS} worlds "
        f"under gloo on one card, {EXTRA_UPDATES} updates; buffer of update "
        f"1 and post-rollout state against the single process's slices: "
        f"{'; '.join(notes) if notes else 'equal bit for bit'}; update 1 "
        f"at its rounding bars (worst over bar per rank {worst}); the card "
        f"repeats the single process's update bit for bit: {repeat}; ELOs "
        f"equal the single process's through update {EXTRA_UPDATES}: "
        f"{elo_same}; ELOs, hyperparameters and parameters equal on every "
        f"rank; launches per rank {launches}")
    log(f"dp_path rate: {fps:.1f} steps x worlds / s over updates "
        f"2-{EXTRA_UPDATES} with {DP_RANKS} ranks sharing one card (gloo, "
        f"host-staged collectives; not a scaling figure), "
        f"{wall:.1f} s for the spawn, init and updates; {gpu}")
    return dict(launches=launches, fps=fps)


def finite_state(label: str, mgr) -> None:
    """Every floating leaf of a manager's state finite (the env state's
    +inf misses allowed)."""
    for k, v in flat_tree(mgr.state_tree()).items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            ok = torch.isfinite(v) | (v == math.inf) if "env_state" in k \
                else torch.isfinite(v)
            require(bool(ok.all()), f"{label}: non-finite {k}")


def profile_update(mgr) -> None:
    """torch.profiler over one training update (``update_iter``): wall and
    device kernel time, busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mgr.update_iter()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows) / 1e3                     # ms
    log(f"profile [train update] {wall * 1e3:.3f} ms wall (under the "
        f"profiler); device kernel time {busy:.3f} ms; busy share "
        f"{busy / (wall * 1e3):.3f}; {sum(r[2] for r in rows)} device "
        f"events")
    for key, t, n in rows[:20]:
        log(f"  {t / 1e3:9.4f} ms {n:7d} calls  {key[:90]}")


def flat_tree(tree) -> dict:
    """Nested dicts, tuples and lists -> {"a.b.0": leaf}."""
    from marl_hideandseek_torch.train.manager import named_leaves

    return named_leaves(tree)


def same(a, b) -> bool:
    """Leaves equal bit for bit (u32 leaves through their i32 view)."""
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if a.dtype == torch.uint32:
        a = a.view(torch.int32)
    if b.dtype == torch.uint32:
        b = b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def ring_means(metrics, n: int) -> dict:
    """Each metric's mean over the ring's first n slots."""
    return {k: round(float(v[:n].mean()), 5) for k, v in metrics.items()}


def buffer_slice(buf, n, dev):
    """The first n agents of a RolloutBuffer, on ``dev``."""
    from marl_hideandseek_torch.models.actor_critic import tree_map
    from marl_hideandseek_torch.train.rollout import RolloutBuffer

    cut = lambda x: x[:, :, :n].to(dev)
    return RolloutBuffer(
        obs={k: cut(v) for k, v in buf.obs.items()},
        actions=cut(buf.actions), log_probs=cut(buf.log_probs),
        values=cut(buf.values), rewards=cut(buf.rewards),
        dones=cut(buf.dones), assignments=cut(buf.assignments),
        rnn_start_states=tree_map(cut, buf.rnn_start_states),
        bootstrap_value=buf.bootstrap_value[:n].to(dev))


def slice_update(cfg, policy, s0, s1, buf, n, dev, obs=None):
    """``ppo_update`` of the first update on its buffer's first n agents
    (their observations replaced by ``obs`` if given), from the state
    before it (parameters, Adam, return statistics, hyperparameters) with
    the normalizer statistics it used, on ``dev``."""
    import dataclasses

    from marl_hideandseek_torch.train import ppo

    to = lambda d: {k: v.to(dev) for k, v in d.items()}
    opt = ppo.AdamState(mu=to(s0.opt_states.mu), nu=to(s0.opt_states.nu),
                        count=s0.opt_states.count.to(dev))
    b = buffer_slice(buf, n, dev)
    if obs is not None:
        b = dataclasses.replace(b, obs=to(obs))
    return ppo.ppo_update(cfg, policy, to(s0.params), opt,
                          s1.obs_stats.to(dev), to(s0.value_stats),
                          to(s0.hyper_params), b, s0.key.to(dev))


def ppo_forward_macs(cfg, policy, s0, s1, buf) -> int:
    """Dense multiply-adds of one epoch's forward of the first update's PPO
    over its whole (grouped) batch, counted by ``dense_macs`` over a rerun
    of that update."""
    from marl_hideandseek_torch.train import ppo

    macs = dense_macs(policy.actor_critic, lambda: ppo.ppo_update(
        cfg, policy, s0.params, s0.opt_states, s1.obs_stats, s0.value_stats,
        s0.hyper_params, buf, s0.key))
    return macs // cfg.algo.num_epochs


def check_k1(cfg, ps, label: str) -> dict:
    """K1 against its plain version on the visibility and lidar queries
    of packed state ``ps``: ids equal on >= 99.9 % and t within 1e-4 on
    equal hits; then its time, the plain version's and its bound."""
    from marl_hideandseek_torch.env import observations as O
    from marl_hideandseek_torch.ops import rays

    w = ps.step.shape[-1]
    q = [torch.movedim(x, 0, -1).contiguous()
         for x in O.obs_ray_queries(cfg, O.world_first(ps))]
    t_k, id_k = rays.raycast_batch_packed(cfg, ps, *q)
    t_p, id_p = rays.raycast_packed_plain(cfg, ps, *q)
    torch.cuda.synchronize()
    id_eq = (id_k == id_p).float().mean().item()
    both = (id_k == id_p) & (id_k >= 0)
    err = max_err(t_k[both], t_p[both])
    log(f"K1 raycast on the {label} state: rays {q[2].shape[0]} x worlds "
        f"{w}; id equal {id_eq:.6f}; max |t - t_plain| on equal hits "
        f"{err:.3g}")
    require(id_eq >= 0.999, f"K1 ({label}) ids agree on {id_eq} < 0.999")
    require(err <= 1e-4, f"K1 ({label}) t error {err} > 1e-4")
    ms = cuda_ms(lambda: rays.raycast_batch_packed(cfg, ps, *q), 20)
    plain_ms = cuda_ms(lambda: rays.raycast_packed_plain(cfg, ps, *q), 2)
    b, s = ps.bodies, ps.statics
    n_bytes = (nbytes(b.pos, b.quat, b.half_ext, b.active, s.wall_pos,
                      s.wall_half_ext, s.wall_active, s.plane_point,
                      s.plane_normal, s.plane_active, *q) +
               nbytes(t_k, id_k))
    b_ms, b_by = bound(n_bytes, raycast_ops(cfg, ps, q[3]))
    log(f"K1 ({label}) {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes} B)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def obs_occupancy(teams: int) -> dict:
    """K6's launch shape at teams v teams, full capacity (9 boxes, 2
    ramps), as the CUDA runtime reckons it (``mhs_observations_occupancy``):
    worlds and shared bytes per block, blocks and worlds resident per SM."""
    import ctypes

    from marl_hideandseek_torch.ops.build import load

    fn = load("observations").mhs_observations_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(9, 2, 2 * teams, ctypes.cast(out, ctypes.c_void_p))
    require(err == 0, f"mhs_observations_occupancy: cudaError {err}")
    return {"worlds_per_block": out[0], "smem_bytes_per_block": out[1],
            "blocks_per_sm": out[2], "worlds_per_sm": out[0] * out[2]}


def obs_bytes(cfg, w: int) -> int:
    """The bytes K6 must move for ``w`` worlds, each read or written once:
    every body's pose and velocity, the boxes' sizes, the boxes' and
    ramps' locks and owners, each agent's grab, type and flag, three
    per-world ints, the sweep's visibility and lidar; the eleven
    leaves."""
    from marl_hideandseek_torch.env import observations as O

    nb, nr, na = cfg.max_boxes, cfg.max_ramps, cfg.max_agents
    read = (4 * 13 * cfg.num_dyn_bodies + 4 * 3 * nb + 5 * (nb + nr) +
            9 * na + 12 + 4 * na * (O.num_vis_targets(cfg) + 30))
    written = 4 * na * sum(f for _, f, _ in O.observation_leaves(cfg))
    return w * (read + written)


def check_k6(cfg, ps, sweep) -> dict:
    """K6 against the plain assembly on packed state ``ps`` and its
    sweep, leaf by leaf: integers and masks equal, floats within 1e-5
    absolute plus 1e-5 relative. Then K6's time (launches from arguments
    built once; ``call_ms``: whole calls of the wrapper, which at 16,384
    worlds the host paces), its byte bound and the plain version's time,
    there and at four times the worlds (the same worlds four times
    over)."""
    import ctypes

    from marl_hideandseek_torch.env import observations as O
    from marl_hideandseek_torch.ops.common import c_arrays, stream_ptr
    from marl_hideandseek_torch.types import on_bits

    out = {}
    for label, times in (("", 1), ("_64k", 4)):
        st, vis, lidar = ps, sweep.vis_seen, sweep.lidar
        if times > 1:
            st = ps.map(on_bits(lambda x: torch.cat([x] * times, -1)))
            vis, lidar = (torch.cat([x] * times, -1) for x in (vis, lidar))
        w = st.step.shape[-1]
        got = O.build_observations_kernel(cfg, st, vis, lidar)
        want = O.build_observations_plain(cfg, st, vis, lidar)
        err = 0.0
        for name, p in want.items():
            k = got[name]
            require(k.dtype == p.dtype and k.shape == p.shape,
                    f"K6 {name}: {k.dtype} {tuple(k.shape)} against "
                    f"{p.dtype} {tuple(p.shape)}")
            if p.dtype != torch.float32 or "mask" in name:
                require(torch.equal(k, p), f"K6 {name} differs")
                continue
            e = max_err(k, p)
            rel = ((k - p).abs() - 1e-5 * p.abs()).max().item()
            require(rel <= 1e-5, f"K6 {name}: error {e} beyond 1e-5 + 1e-5 x")
            err = max(err, e)
        call_ms = cuda_ms(lambda: O.build_observations_kernel(cfg, st, vis,
                                                              lidar), 20)
        ptrs, ip = O.observation_params(cfg, st, vis, lidar)
        ptrs += [t.data_ptr() for t in got.values()]
        pa, ia, fa = c_arrays(ptrs, ip, [])
        launch = (ctypes.cast(pa, ctypes.c_void_p), len(ptrs),
                  ctypes.cast(ia, ctypes.c_void_p), len(ip),
                  ctypes.cast(fa, ctypes.c_void_p), 0,
                  stream_ptr(st.step.device))
        ms = cuda_ms(lambda: O.OBSERVATIONS(*launch), 50)
        plain_ms = cuda_ms(lambda: O.build_observations_plain(cfg, st, vis,
                                                              lidar), 3)
        n_bytes = obs_bytes(cfg, w)
        b_ms, b_by = bound(n_bytes, 0.0)
        log(f"K6 at {w} worlds: {ms:.4f} ms/launch ({ms / b_ms:.2f}x the "
            f"bound; a whole call {call_ms:.4f}), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}: {n_bytes} B); max abs err "
            f"against plain {err:.3g}")
        out.update({f"ms{label}": ms, f"call_ms{label}": call_ms,
                    f"plain_ms{label}": plain_ms, f"bound_ms{label}": b_ms,
                    f"max_abs_err{label}": err})
    out["bound_by"] = "bytes"
    out["max_abs_err"] = max(out["max_abs_err"], out.pop("max_abs_err_64k"))
    return out


def check_k7(cfg, dev) -> dict:
    """K7 against the plain generator: packed level 1 of bench.py's 2v2 at
    256 (a compact reset's slots), 16,384 and 65,536 worlds, and at 16,384
    worlds of 3v3, of the serve path's 2v2 under ``UseFixedWorld`` (one
    draw row for every world) and of headless.py's 3v2 (5 agent slots,
    ``SimFlags.Default``), every leaf bit for bit (floats as their
    words). Then K7's time
    (launches from arguments built once), a whole call of
    ``training_world_packed`` (the threefry draws and the launch), the
    plain version's time and the byte bound (the draws read, the state
    written: the least any kernel could take; K7 is bound by each
    world's sequential program instead)."""
    import ctypes

    from marl_hideandseek_torch import prng
    from marl_hideandseek_torch.config import SimFlags
    from marl_hideandseek_torch.env import levelgen as L
    from marl_hideandseek_torch.env.episode import draw_episode
    from marl_hideandseek_torch.env.rng import episode_keys
    from marl_hideandseek_torch.ops import levelgen as LG
    from marl_hideandseek_torch.ops.common import c_arrays, stream_ptr
    from marl_hideandseek_torch.types import pack_state

    words = lambda t: t.view(torch.int32) if t.dtype in (
        torch.float32, torch.uint32) else t
    out = {}
    cases = [("_256", 256, cfg), ("", WORLDS, cfg), ("_64k", 4 * WORLDS, cfg),
             ("_3v3", WORLDS, cfg.replace(min_hiders=3, max_hiders=3,
                                          min_seekers=3, max_seekers=3)),
             ("_fixed", WORLDS, cfg.replace(
                 sim_flags=SimFlags.UseFixedWorld |
                 SimFlags.ZeroAgentVelocity)),
             ("_3v2", WORLDS, cfg.replace(min_hiders=3, max_hiders=3,
                                          min_seekers=2, max_seekers=2,
                                          sim_flags=SimFlags.Default))]
    for label, w, c in cases:
        c = c.replace(num_worlds=w)
        ids = torch.arange(w, device=dev)
        ep, lk, nh, ns, flip = draw_episode(c, episode_keys(
            prng.key(SEED, dev), ids, torch.zeros_like(ids)))
        got = L.training_world_packed(c, lk, ep, nh, ns, flip)
        want = pack_state(L.generate_training_world(c, lk, ep, nh, ns, flip))
        for k, p in zip(got.leaves(), want.leaves()):
            require(k.dtype == p.dtype and k.shape == p.shape and
                    torch.equal(words(k), words(p)),
                    f"K7 at {w} worlds{label} differs from the plain "
                    f"generator")
        call_ms = cuda_ms(lambda: L.training_world_packed(c, lk, ep, nh, ns,
                                                          flip), 5)
        draws = L.training_draws(c, lk)
        nh, ns = nh.long(), ns.long()
        ptrs, ip = LG.levelgen_params(c, draws, lk, ep, nh, ns, flip, got)
        pa, ia, fa = c_arrays(ptrs, ip, [])
        launch = (ctypes.cast(pa, ctypes.c_void_p), len(ptrs),
                  ctypes.cast(ia, ctypes.c_void_p), len(ip),
                  ctypes.cast(fa, ctypes.c_void_p), 0, stream_ptr(dev))
        ms = cuda_ms(lambda: LG.LEVELGEN(*launch), 20)
        plain_ms = cuda_ms(lambda: L.generate_training_world(
            c, lk, ep, nh, ns, flip), 1)
        n_bytes = nbytes(draws.counts, draws.pose_u, draws.walls.bits,
                         draws.walls.u, lk, ep, nh, ns, flip, *got.leaves())
        b_ms, _ = bound(n_bytes, 0.0)
        log(f"K7 at {w} worlds{label}: {ms:.4f} ms/launch ({ms / b_ms:.1f}x "
            f"the byte bound {b_ms:.5f} ms, {n_bytes} B); a whole call with "
            f"its draws {call_ms:.4f} ms; plain {plain_ms:.3f} ms; equal bit "
            f"for bit")
        out.update({f"ms{label}": ms, f"call_ms{label}": call_ms,
                    f"plain_ms{label}": plain_ms, f"bound_ms{label}": b_ms})
        del got, want, draws
        torch.cuda.empty_cache()
    out.update(bound_by="bytes (a floor; latency bounds it)",
               max_abs_err=0.0)
    return out


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32):
    """(least time in ms, what bounds it) for this many bytes moved and
    operations done at ``peak_ops`` a second (float32 by default)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def render_path(cfg, env, ps, random_actions, gpu):
    """bench.py's BENCH_RENDER=1 protocol: RENDER_STEPS packed steps, each
    followed by K5 into buffers allocated once; then K5 against the plain
    renderer on RENDER_CHECK_WORLDS worlds of the last step, and K5's time
    at full width. Returns the state and K5's kernels-line row."""
    from marl_hideandseek_torch.ops import rgbd as R
    from marl_hideandseek_torch.types import on_bits
    from marl_hideandseek_torch.viz import rgbd as plain

    dev = ps.step.device
    hw = RENDER_HW
    out = R.rgbd_buffers(cfg, WORLDS, hw, hw, dev)
    R.RGBD.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(RENDER_STEPS):
        ps, res = env.step(ps, random_actions())
        R.render_rgbd_packed_fast(cfg, ps, hw, hw, out=out)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t1
    n_launch = R.RGBD.launches
    require(n_launch == RENDER_STEPS, f"K5 launches {n_launch} on the "
            f"render path, expected {RENDER_STEPS}")
    check_finite(ps, res, "render path")
    rgba, depth = out
    require(bool(torch.isfinite(depth).all()), "K5 depth not finite")
    n_pix = cfg.max_agents * hw * hw
    log(f"render path: {RENDER_STEPS} steps + {hw}x{hw} RGBD each in "
        f"{t_render:.3f} s = {RENDER_STEPS * WORLDS / t_render:.1f} steps x "
        f"worlds / s, {RENDER_STEPS * WORLDS * n_pix / t_render:.4g} "
        f"pixel-rays / s; K5 launches {n_launch}; {gpu}")

    # K5 vs the plain renderer on the first RENDER_CHECK_WORLDS worlds.
    k = RENDER_CHECK_WORLDS
    sub = ps.map(on_bits(lambda x: x[..., :k].contiguous()))
    rgb_k, d_k = R.to_reference_layout(cfg, rgba[..., :k], depth[..., :k],
                                       hw, hw)
    rgb_p, d_p = plain.render_rgbd_packed(cfg, sub, hw, hw)
    d_err = compare_k5(rgb_k, d_k, rgb_p, d_p, f"{k} worlds")

    ms = cuda_ms(lambda: R.render_rgbd_packed_fast(cfg, ps, hw, hw,
                                                   out=out), 10)
    plain_ms = cuda_ms(lambda: plain.render_rgbd_packed(cfg, sub, hw, hw), 1)
    b, s = ps.bodies, ps.statics
    n_bytes = (nbytes(b.pos, b.quat, b.half_ext, b.active, b.locked,
                      ps.agent_type, s.wall_pos, s.wall_half_ext,
                      s.wall_active, s.plane_point, s.plane_normal,
                      s.plane_active) + nbytes(rgba, depth))
    least = rgbd_least_ops(depth)
    k5_bound, k5_by = bound(n_bytes, least)
    exhaustive = rgbd_ops(cfg, ps, depth)
    ex_bound, _ = bound(n_bytes, exhaustive)
    log(f"K5 {ms:.4f} ms/launch at {WORLDS} worlds, plain {plain_ms:.3f} ms "
        f"at {k} worlds, bound {k5_bound:.5f} ms ({k5_by}: {n_bytes} B, "
        f"{least:.4g} least operations); every pixel testing every "
        f"primitive: {exhaustive:.4g} operations, {ex_bound:.5f} ms")
    return dict(state=ps, kernel=dict(
        launches=n_launch, max_abs_err=d_err, ms=ms, plain_ms=plain_ms,
        plain_at_worlds=k, bound_ms=k5_bound, bound_by=k5_by,
        library_ms=None, exhaustive_ops=exhaustive,
        exhaustive_bound_ms=ex_bound))


def frames_path(dev, gpu):
    """The pixel policy's training at FRAMES_WORLDS 2v2 worlds: the train
    CLI's ``build`` with ``--backbone impala_cnn`` (the env renders every
    agent's frame in ``init`` and in each step through K5's frames mode),
    ``init_training`` and one ``update_iter``, with K5's frames launches
    set to 0 just before: one at init and one a step. The last frames
    (the env's buffer, on the rollout's state) against the plain
    renderer's images of that state as frames: colours equal on every
    pixel, depth within 1e-3 absolute and 1e-4 relative in world units.
    Then K5's frames mode's ms a launch on that state and its bound from
    the launch's inputs and the frames it writes. Returns the kernels
    line's row."""
    import tempfile

    from marl_hideandseek_torch.config import FRAME_FOV, FRAME_MAX_DEPTH
    from marl_hideandseek_torch.ops import rgbd as R
    from marl_hideandseek_torch.viz import rgbd as plain

    R.RGBD_FRAMES.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        run = train_run(dev, train_args(
            tmp, dev.type, "--num-worlds", str(FRAMES_WORLDS),
            "--backbone", "impala_cnn"), 1)
    n_launch = R.RGBD_FRAMES.launches
    env, cfg, mgr = run["env"], run["cfg"], run["mgr"]
    cfg_env, ps = env.cfg, mgr.state.rollout.env_state
    require(cfg_env.render_frames and run["launches"]["rgbd"] == 0,
            "frames path: the env does not render frames, or the packed "
            "mode ran")
    require(n_launch == 1 + cfg.steps_per_update,
            f"frames path: K5 frames launches {n_launch}, expected one at "
            f"init and one for each of {cfg.steps_per_update} steps")
    finite_state("frames path", mgr)
    got = env._frames
    require(torch.equal(mgr.state.rollout.obs["rgbd"], got.flatten(0, 1)),
            "frames path: the rollout's frame is not the env's last render")
    hw = got.shape[-1]
    rgb_p, d_p = plain.render_rgbd_packed(cfg_env, ps, hw, hw, FRAME_FOV,
                                          FRAME_MAX_DEPTH)
    want = R.to_frames(rgb_p, d_p, FRAME_MAX_DEPTH)
    torch.cuda.synchronize()
    colour = (got[:, :, :3] == want[:, :, :3]).all(2)
    d_got, d_want = got[:, :, 3] * FRAME_MAX_DEPTH, d_p[..., 0]
    d_err = max_err(d_got, d_want)
    near = (d_got - d_want).abs() <= 1e-3 + 1e-4 * d_want.abs()
    log(f"frames path: {FRAMES_WORLDS} worlds x {cfg_env.max_agents} agents "
        f"at {hw}x{hw}, K5 frames launches {n_launch}; last frames vs plain: "
        f"colours equal on {colour.float().mean().item():.6f} of pixels, "
        f"depth max err {d_err:.3g}, hit share "
        f"{(d_want > 0).float().mean().item():.4f}")
    require(bool(colour.all()), "frames path: colours differ from the "
            "plain renderer's")
    require(bool(near.all()), f"frames path: depth beyond 1e-3 / 1e-4 of "
            f"the plain renderer's ({d_err})")

    ms = cuda_ms(lambda: R.render_rgbd_frames(
        cfg_env, ps, hw, hw, FRAME_FOV, FRAME_MAX_DEPTH, out=got), 10)
    b, s = ps.bodies, ps.statics
    n_bytes = (nbytes(b.pos, b.quat, b.half_ext, b.active, b.locked,
                      ps.agent_type, s.wall_pos, s.wall_half_ext,
                      s.wall_active, s.plane_point, s.plane_normal,
                      s.plane_active) + nbytes(got))
    least = rgbd_least_ops(got[:, :, 3])
    k5_bound, k5_by = bound(n_bytes, least)
    log(f"K5 frames {ms:.4f} ms/launch at {FRAMES_WORLDS} worlds, bound "
        f"{k5_bound:.5f} ms ({k5_by}: {n_bytes} B, {least:.4g} least "
        f"operations); {gpu}")
    del run, env, mgr
    return dict(train_launches=n_launch, max_abs_err=d_err, ms=ms,
                bound_ms=k5_bound, bound_by=k5_by, library_ms=None,
                at_worlds=FRAMES_WORLDS)


def compare_k5(rgb_k, d_k, rgb_p, d_p, label: str) -> float:
    """K5's RGBD against the plain renderer's (reference layout): depth
    within atol 1e-3 / rtol 1e-4, colours equal on >= 99.5 % of pixels,
    sky pixels exact. Returns the depth's largest error."""
    torch.cuda.synchronize()
    d_err = max_err(d_k, d_p)
    depth_ok = bool(torch.isclose(d_k, d_p, atol=1e-3, rtol=1e-4).all())
    same = (rgb_k == rgb_p).all(-1)
    frac = same.float().mean().item()
    sky = d_p[..., 0] == 0
    sky_ok = bool((same | ~sky).all())
    log(f"K5 vs plain on {label}: depth max err {d_err:.3g}, colours "
        f"equal on {frac:.6f} of pixels, sky exact {sky_ok}, hit share "
        f"{(~sky).float().mean().item():.4f}")
    require(depth_ok, f"K5 ({label}) depth beyond atol 1e-3 / rtol 1e-4 "
            f"({d_err})")
    require(frac >= 0.995, f"K5 ({label}) colours equal on {frac} < 0.995")
    require(sky_ok, f"K5 ({label}) sky pixels differ from the plain "
            f"renderer")
    return d_err


def classic_path(dev, random_actions, gpu):
    """HideAndSeekEnv at scripts/headless.py's configuration: CLASSIC_STEPS
    steps with random 11-bucket actions across the full reset, then
    CLASSIC_COMPACT_STEPS with 1 % external resets (some to debug levels
    2-8), through K3 and K1; then UNFUSED_STEPS of the unfused branch
    through K2 and K1. Returns the launches and the states for the K2/K3
    checks."""
    from marl_hideandseek_torch.config import EnvConfig, SimFlags
    from marl_hideandseek_torch.env.env import HideAndSeekEnv
    from marl_hideandseek_torch.ops import fused, physics, rays
    from marl_hideandseek_torch.ops import levelgen as LG
    from marl_hideandseek_torch.ops import threefry as tfk

    cfg = EnvConfig(num_worlds=WORLDS, min_hiders=3, max_hiders=3,
                    min_seekers=2, max_seekers=2,
                    sim_flags=SimFlags.Default, rand_seed=SEED)
    na = cfg.max_agents
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)

    def actions():
        return random_actions(na, 11).permute(2, 0, 1)       # [W, A, 5]

    rays.RAYCAST.launches = 0
    fused.FUSED.launches = 0
    physics.PHYSICS.launches = 0
    tfk.THREEFRY.launches = 0
    LG.LEVELGEN.launches = 0
    t0 = time.perf_counter()
    env = HideAndSeekEnv(cfg, device=dev)
    state, res = env.init()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    check_classic(state, res, cfg, "classic init")
    init_state = state.map(snapshot)
    moving = None
    t1 = time.perf_counter()
    for i in range(CLASSIC_STEPS):
        state, res = env.step(state, actions())
        if i + 1 == MOVING_AT:
            moving = state.map(snapshot)
        if (i + 1) % 125 == 0:
            check_classic(state, res, cfg, f"classic step {i + 1}")
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t1
    require(env.reset_counts["full"] >= 1, "classic: the full reset never "
            "ran")
    t2 = time.perf_counter()
    for _ in range(CLASSIC_COMPACT_STEPS):
        hit = torch.rand(WORLDS, generator=gen, device=dev) < RESET_FRACTION
        level = torch.randint(1, 9, (WORLDS,), generator=gen, device=dev)
        state, res = env.step(state, actions(),
                              torch.where(hit, level, 0).to(torch.int32))
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t2
    check_classic(state, res, cfg, "classic compact")
    require(env.reset_counts["compact"] >= 1, "classic: the compact reset "
            "never ran")
    launches = {"fused": fused.FUSED.launches,
                "raycast": rays.RAYCAST.launches,
                "threefry": tfk.THREEFRY.launches,
                "levelgen": LG.LEVELGEN.launches}
    require(launches["fused"] > 0 and launches["raycast"] > 0 and
            launches["threefry"] > 0 and
            launches["levelgen"] == 1 + sum(env.reset_counts.values()),
            f"kernel launches on the classic path: {launches} (K7: one at "
            f"init and one a reset step, {env.reset_counts})")
    log(f"classic path: init {t_init:.3f} s; {CLASSIC_STEPS} steps in "
        f"{t_steps:.3f} s = {CLASSIC_STEPS * WORLDS / t_steps:.1f} steps x "
        f"worlds / s; {CLASSIC_COMPACT_STEPS} steps with 1 % resets in "
        f"{t_compact:.3f} s = "
        f"{CLASSIC_COMPACT_STEPS * WORLDS / t_compact:.1f}; resets "
        f"{env.reset_counts}; launches {launches}; {gpu}")

    rays.RAYCAST.launches = 0
    physics.PHYSICS.launches = 0
    unfused = HideAndSeekEnv(cfg, device=dev, fused=False)
    t3 = time.perf_counter()
    for _ in range(UNFUSED_STEPS):
        state, res = unfused.step(state, actions())
    torch.cuda.synchronize()
    t_unfused = time.perf_counter() - t3
    check_classic(state, res, cfg, "classic unfused")
    launches["physics"] = physics.PHYSICS.launches
    require(launches["physics"] == UNFUSED_STEPS and
            rays.RAYCAST.launches >= 2 * UNFUSED_STEPS,
            f"unfused classic launches: physics {launches['physics']}, "
            f"raycast {rays.RAYCAST.launches}")
    log(f"classic path, unfused branch: {UNFUSED_STEPS} steps in "
        f"{t_unfused:.3f} s = {UNFUSED_STEPS * WORLDS / t_unfused:.1f} "
        f"steps x worlds / s; physics launches {launches['physics']}, "
        f"raycast {rays.RAYCAST.launches}; {gpu}")
    return dict(cfg=cfg, launches=launches, init=init_state, moving=moving)


def check_classic(state, res, cfg, where: str) -> None:
    check_finite(state, res, where)
    shapes = {k: tuple(v.shape) for k, v in res.obs.items()}
    na = cfg.max_agents
    require(shapes["box_data"] == (WORLDS, na, 9, 17) and
            shapes["agent_data"] == (WORLDS, na, 5, 14) and
            shapes["self_lidar"] == (WORLDS, na, 30) and
            shapes["vis_boxes_mask"] == (WORLDS, na, 9, 1) and
            tuple(res.rewards.shape) == (WORLDS, na, 1),
            f"classic observation shapes at {where}: {shapes}")


def pre_physics(cfg, ps, acts):
    """Movement and grab/lock on packed ``ps``: the K2/K3 inputs."""
    from marl_hideandseek_torch.env import packed as P

    ext_f, ext_t = P.movement_packed(cfg, ps, acts)
    ps = P.action_system_packed(cfg, ps, acts, ps.act_hit_t, ps.act_hit_id)
    return ps, ext_f, ext_t


def check_physics_kernels(classic, random_actions):
    """K2 and K3 against their plain versions on the classic init state
    (at rest; step set to 100 so that seekers act) and on the classic
    path's state after MOVING_AT steps; then each kernel's time, its plain
    version's, and its bound on one input from the moving state."""
    from marl_hideandseek_torch.ops import fused, physics
    from marl_hideandseek_torch.types import pack_state

    cfg = classic["cfg"]
    na = cfg.max_agents
    init = pack_state(classic["init"])
    init = init.replace(step=torch.full_like(init.step, 100))
    moving = pack_state(classic["moving"])
    acts_fn = lambda: random_actions(na, 11)
    out = {}
    for kind in ("physics", "fused"):
        err = 0.0
        for ps, label in ((init, "init"),
                          (moving, f"classic step {MOVING_AT}")):
            err = max(err, check_step_run(kind, cfg, ps, acts_fn, label))
        ps, ext_f, ext_t = pre_physics(cfg, moving, acts_fn())
        tally: dict = {}
        if kind == "physics":
            args = (cfg, ps.bodies, ps.statics, ps.grab, ext_f, ext_t)
            run = lambda: physics.physics_packed(*args)
            run_plain = lambda: physics.physics_plain(*args)
            physics.physics_plain(*args, tally=tally)
            ins = physics.physics_inputs(*args)
            outs = list(run().leaves())[:4]
            n_ops = physics_ops(cfg, ps, tally)
        else:
            run = lambda: fused.fused_step_packed(cfg, ps, ext_f, ext_t)
            run_plain = lambda: fused.fused_step_plain(cfg, ps, ext_f, ext_t)
            fused.fused_step_plain(cfg, ps, ext_f, ext_t, tally=tally)
            ins = fused.fused_inputs(cfg, ps, ext_f, ext_t)
            bk, sk = run()
            outs = [bk.pos, bk.quat, bk.vel, bk.omega, *sk]
            n_ops = physics_ops(cfg, ps, tally) + sweep_ops(cfg, ps)
        ms = cuda_ms(run, 10)
        plain_ms = cuda_ms(run_plain, 1)
        n_bytes = nbytes(*[t for t, _, _ in ins]) + nbytes(*outs)
        b_ms, b_by = bound(n_bytes, n_ops)
        log(f"{kind} {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}: {n_bytes} B, {n_ops:.4g} ops; physics "
            f"work per launch {tally})")
        out[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def check_step_run(kind, cfg, ps, acts_fn, label: str) -> float:
    """K4_CHECK_STEPS launches of K2 ('physics') or K3 ('fused') against
    the plain version, each from the kernel's previous output through
    movement and grab/lock; bodies as in ``check_bodies``, K3's sweep as
    K4's. Returns the largest body error seen."""
    from marl_hideandseek_torch.ops import fused, physics

    err = 0.0
    for i in range(K4_CHECK_STEPS):
        ps, ext_f, ext_t = pre_physics(cfg, ps, acts_fn())
        where = f"{kind} {label}, step {i}"
        if kind == "physics":
            args = (cfg, ps.bodies, ps.statics, ps.grab, ext_f, ext_t)
            bk, bp = physics.physics_packed(*args), physics.physics_plain(*args)
        else:
            bk, sk = fused.fused_step_packed(cfg, ps, ext_f, ext_t)
            bp, sp = fused.fused_step_plain(cfg, ps, ext_f, ext_t)
        torch.cuda.synchronize()
        e, notes = check_bodies(where, i, label, bk, bp)
        err = max(err, e)
        if kind == "fused":
            notes.append(check_sweep(where, sk, sp))
            require(frac_equal(sk.rew_seen, sp.rew_seen) >= 0.999,
                    f"{where} rew_seen")
            ps = ps.replace(act_hit_t=sk.act_t, act_hit_id=sk.act_id)
        log(f"{where}: {'; '.join(notes)}")
        ps = ps.replace(bodies=bk, step=ps.step + 1)
    return err


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
    the kernel's previous output: bodies as in ``check_bodies``, the
    sweep as in ``check_sweep``, and rewards, dones, locks, grabs and
    scores exact. ``tally`` gets the first plain step's physics work
    counts. Returns the largest body error seen."""
    err = 0.0
    for i in range(K4_CHECK_STEPS):
        acts = random_actions()
        rk = step.megastep_packed(cfg, ps, acts)
        rp = step.megastep_plain(cfg, ps, acts, tally=tally if i == 0
                                 else None)
        torch.cuda.synchronize()
        where = f"K4 {label}, step {i}"
        e, notes = check_bodies(where, i, label, rk[0].bodies, rp[0].bodies)
        err = max(err, e)
        notes.append(check_sweep(where, rk[1], rp[1]))
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
        log(f"{where}: {'; '.join(notes)}")
        ps = rk[0].replace(step=rk[0].step + 1, act_hit_t=rk[1].act_t,
                           act_hit_id=rk[1].act_id)
    return err


def check_bodies(where: str, i: int, label: str, bk, bp):
    """Launch i's bodies against the plain version's: the first at TIGHT
    (on every element of a state at rest, labelled "init"; on LIVE_SHARE
    of the live elements of a moving one, with at least MIN_LIVE live
    velocity and angular-velocity elements), later ones at JAX_BARS on
    >= 99.5 % of all elements. Returns (largest error, notes)."""
    err = 0.0
    notes = []
    for name, tol in TIGHT.items():
        a, p_ = getattr(bk, name), getattr(bp, name)
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
    return err, notes


def frac_equal(a, b) -> float:
    return (a == b).float().mean().item()


def check_sweep(where: str, sk, sp) -> str:
    """A launch's sweep against the plain one: visibility and grab/lock
    hit ids equal, and lidar within 1e-3, on >= 99.9 %."""
    vis_eq = frac_equal(sk.vis_seen, sp.vis_seen)
    aid_eq = frac_equal(sk.act_id, sp.act_id)
    lid = frac_close(sk.lidar, sp.lidar, 1e-3)
    require(vis_eq >= 0.999, f"{where} vis agree {vis_eq}")
    require(aid_eq >= 0.999, f"{where} act_id agree {aid_eq}")
    require(lid >= 0.999, f"{where} lidar agree {lid}")
    return f"vis {vis_eq:.6f} act_id {aid_eq:.6f} lidar {lid:.6f}"


def k4_outputs(rk) -> list:
    """The tensors one megastep launch writes."""
    ps2, sweep, rewards, dones, team_r = rk
    b, g = ps2.bodies, ps2.grab
    return [b.pos, b.quat, b.vel, b.omega, b.locked, b.owner, g.target,
            g.r2, g.rel_q, g.sep, *sweep, rewards, dones, team_r,
            ps2.running_scores, ps2.finished_scores]


def device_rows(prof) -> list:
    """(name, device time in us, calls) of the device's own events -
    kernels and copies - by device time. The operator rows that launched
    them are left out: they carry the same device time again."""
    from torch.autograd import DeviceType

    return sorted(((e.key, e.device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and
                   e.device_time_total > 0), key=lambda r: -r[1])


def profile_forward(fwd, reps: int) -> None:
    """torch.profiler over ``reps`` of the serve path's ensemble forward:
    device kernel time per forward and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows) / 1e3
    log(f"profile [serve forward] {reps} forwards: {wall / reps * 1e3:.3f} "
        f"ms wall each (under the profiler); device kernel time "
        f"{busy / reps:.3f} ms each")
    for key, t, n in rows[:15]:
        log(f"  {t / 1e3 / reps:9.4f} ms/fwd {n:7d} calls  {key[:90]}")


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
    rows = device_rows(prof)
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


def sweep_ops(cfg, ps) -> float:
    """Operations of the sweep on this state: per agent, the visibility
    targets, 30 lidar and 1 grab ray, each against every active primitive
    but the agent itself."""
    from marl_hideandseek_torch.env.observations import num_vis_targets
    from marl_hideandseek_torch.types import body_slot_ranges

    _, _, (al, ah) = body_slot_ranges(cfg)
    n_tgt = num_vis_targets(cfg)
    per_body = body_ray_ops(cfg, ps)
    per_ray = per_body.sum(0) + static_ray_ops(ps)               # [W]
    own = per_body[al:ah]                                        # [A, W]
    rays = (n_tgt + 30 + 1) * (per_ray[None] - own)
    return rays.sum().item() + cfg.max_agents * ps.step.numel() * (
        OPS_SWEEP_AGENT + n_tgt * OPS_VIS_RAY + 30 * OPS_LIDAR_RAY)


def physics_ops(cfg, ps, tally: dict) -> float:
    """Operations of the physics step on this state: the manifold build
    and the substeps' per-slot work, plus the refreshes, solves and
    joints the plain physics counted on the same input (``tally``)."""
    n_slot = cfg.num_dyn_bodies
    walls = ps.statics.wall_active.float().sum(0)
    active = ps.bodies.active.float().sum(0)
    manifold = (n_slot * (OPS_MANIFOLD_SLOT + OPS_PRESEL_WALL * walls) +
                OPS_PRESEL_BODY * active * (n_slot - 1)).sum().item()
    substeps = (cfg.num_physics_substeps * n_slot * OPS_SUBSTEP_SLOT *
                ps.step.numel())
    work = sum(OPS_REFRESH.get(k, 0) * v + OPS_TALLY.get(k, 0) * v
               for k, v in tally.items())
    return manifold + substeps + work


def megastep_ops(cfg, ps, tally: dict) -> float:
    """Operations of one K4 launch on this state: the sweep and the
    physics step (the movement, grab/lock and reward set-up is left
    out)."""
    return sweep_ops(cfg, ps) + physics_ops(cfg, ps, tally)


# K5 per pixel ray (csrc/rgbd.cu): the camera ray (2 rotations, the
# pixel offsets, the normalisation) 88; per hit pixel the shading (hit
# point, the face normal through 2 rotations, its normalisation, the
# light, 3 channels) about 100.
OPS_PIXEL_RAY, OPS_PIXEL_SHADE = 88, 100


def rgbd_ops(cfg, ps, depth: torch.Tensor) -> float:
    """Operations of one K5 launch on this state if every pixel ray
    tested every active primitive of its world but its agent's own body,
    and shaded its hit (``depth`` [A, P, W] > 0): the exhaustive count,
    which a kernel that culls may do less than."""
    from marl_hideandseek_torch.types import body_slot_ranges

    _, _, (al, ah) = body_slot_ranges(cfg)
    n_pix = depth.shape[1]
    per_body = body_ray_ops(cfg, ps)
    per_ray = per_body.sum(0) + static_ray_ops(ps)               # [W]
    tests = (per_ray[None] - per_body[al:ah]).sum().item() * n_pix
    hits = (depth > 0).sum().item()
    return tests + OPS_PIXEL_RAY * depth.numel() + OPS_PIXEL_SHADE * hits


def rgbd_least_ops(depth: torch.Tensor) -> float:
    """The least operations any kernel must do for one K5 launch: the
    camera ray of every pixel, and one primitive test (the cheapest, a
    plane's) and the shading of every hit pixel (``depth`` > 0). It errs
    low whatever a kernel culls."""
    hits = (depth > 0).sum().item()
    return (OPS_PIXEL_RAY * depth.numel() +
            (OPS_PIXEL_SHADE + OPS_RAY_PLANE) * hits)


# -- slice 9: the record/replay path, the viewer, tool use, NaN guards, entry --

def check_bodies_small(where: str, bk, bp) -> float:
    """One launch's bodies against the plain version's at a few worlds:
    TIGHT on >= LIVE_SHARE of all elements (too few for ``check_bodies``'s
    live-element floor). Returns the largest error."""
    err = 0.0
    for name, tol in TIGHT.items():
        a, p_ = getattr(bk, name), getattr(bp, name)
        err = max(err, max_err(a, p_))
        fr = frac_close(a, p_, tol)
        require(fr >= LIVE_SHARE, f"{where} {name}: {fr} within {tol}")
    return err


def check_k4_small(cfg, ps, acts, label: str) -> float:
    """One K4 launch against its plain version on packed ``ps``: bodies
    as in ``check_bodies_small``, the sweep as in ``check_sweep``,
    rewards, dones, locks, grabs and scores exact."""
    from marl_hideandseek_torch.ops import step

    rk = step.megastep_packed(cfg, ps, acts)
    rp = step.megastep_plain(cfg, ps, acts)
    torch.cuda.synchronize()
    where = f"K4 {label}"
    err = check_bodies_small(where, rk[0].bodies, rp[0].bodies)
    note = check_sweep(where, rk[1], rp[1])
    for i, name in ((2, "rewards"), (3, "dones")):
        require(bool((rk[i] == rp[i]).all()), f"{where} {name}")
    for name in ("locked", "owner"):
        require(torch.equal(getattr(rk[0].bodies, name),
                            getattr(rp[0].bodies, name)), f"{where} {name}")
    require(torch.equal(rk[0].grab.target, rp[0].grab.target) and
            torch.equal(rk[0].running_scores, rp[0].running_scores),
            f"{where} grabs or scores")
    log(f"{where}: body max err {err:.3g}; {note}")
    return err


def record_path(dev, gpu, work: str) -> dict:
    """infer.sh's run on the card, recorded, then replayed (module
    docstring). Returns the launches of the infer run and the replays."""
    from unittest import mock

    from marl_hideandseek_torch import bridge, infer, replay, replay3d
    from marl_hideandseek_torch.env.checkpoint import (
        pack_checkpoints,
        save_checkpoints,
    )
    from marl_hideandseek_torch.env.packed import PackedEnv
    from marl_hideandseek_torch.types import unpack_state
    from marl_hideandseek_torch.utils.ckptlog import CkptLogReader

    gen = torch.Generator().manual_seed(SEED + 11)
    policy, params = seeded_policy(dev, gen)
    norm = policy.obs_preprocess
    ckpt = os.path.join(work, "policies.pt")
    log_path = os.path.join(work, "record.bin")
    argv = ["--ckpt-path", ckpt, "--num-worlds", str(RECORD_WORLDS),
            "--num-steps", str(RECORD_STEPS), "--num-hiders", "2",
            "--num-seekers", "2", "--record-log", log_path, "--device",
            str(dev)]
    cfg = infer.infer_config(infer.parse_args(argv))
    small = PackedEnv(cfg, device=dev)
    stats = seeded_stats(norm, flat_obs(norm, small.init()[1].obs), gen)
    bridge.save_policy_checkpoint(ckpt, params, stats,
                                  [1500.0] * SERVE_POLICIES)
    held = {}
    run_inference = infer.run_inference

    def holding(env, *a, state_cb=None, **kw):
        held["env"] = env

        def cb(i, ps):
            state_cb(i, ps)
            if i in RECORD_CHECK or i == RECORD_MOVING:
                held[i] = ps.map(snapshot)
        return run_inference(env, *a, state_cb=cb, **kw)

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(infer, "run_inference", holding):
        require(infer.main(argv) == 0, "record path: infer main failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    env = held["env"]
    require(launches["megastep"] == RECORD_STEPS and
            launches["raycast"] > 0 and env.reset_counts["full"] == 2,
            f"record path: launches {launches}, resets {env.reset_counts}")
    with CkptLogReader(log_path) as r:
        shape = (r.num_frames, r.num_worlds, r.frame_bytes)
        require(shape == (RECORD_STEPS, RECORD_WORLDS, RECORD_BYTES),
                f"record path: log of {shape}")
        for i in RECORD_CHECK:
            want = pack_checkpoints(save_checkpoints(
                cfg, unpack_state(held[i]))).cpu().numpy()
            require((r.read(i) == want).all(), f"record path: frame {i} "
                    f"differs from the state the loop held")
        renv = replay.replay_env(r, 2, 2, dev)
        *_, (i_last, loaded) = replay.replay_states(r, renv,
                                                    RECORD_STEPS - 1)
    require(i_last == RECORD_STEPS - 1, f"record path: frame {i_last}")
    final = unpack_state(held[RECORD_STEPS - 1])
    require(all(same(a, b) for a, b in zip(
        [*loaded.bodies.leaves(), *loaded.statics.leaves(),
         *loaded.grab.leaves(), loaded.step, loaded.agent_type],
        [*final.bodies.leaves(), *final.statics.leaves(),
         *final.grab.leaves(), final.step, final.agent_type])),
        "record path: frame 499 does not load the run's bodies and statics")
    frame_mb = os.path.getsize(log_path) / 1e6
    log(f"record path: infer.sh's arguments, {RECORD_STEPS} steps x "
        f"{RECORD_WORLDS} worlds in {wall:.3f} s with the log "
        f"({frame_mb:.3f} MB, {RECORD_BYTES} B a world); frames "
        f"{RECORD_CHECK} equal the loop's states; frame "
        f"{RECORD_STEPS - 1} reloads bodies and statics bit for bit; resets "
        f"{env.reset_counts}; launches {launches}; {gpu}")

    # The replays, counted with the record run.
    out_png = os.path.join(work, "replay")
    out_html = os.path.join(work, "replay.html")
    t0 = time.perf_counter()
    require(replay.main([log_path, "--out", out_png, "--every",
                         str(REPLAY_EVERY), "--num-hiders", "2",
                         "--num-seekers", "2", "--device", str(dev)]) == 0,
            "replay failed")
    t_png = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(replay3d.main([log_path, "--out", out_html, "--every",
                           str(REPLAY3D_EVERY), "--num-hiders", "2",
                           "--num-seekers", "2", "--device", str(dev)]) == 0,
            "replay3d failed")
    t_html = time.perf_counter() - t0
    pngs = sorted(os.listdir(out_png))
    n_png = RECORD_STEPS // REPLAY_EVERY
    require(len(pngs) == n_png, f"replay wrote {len(pngs)} frames, "
            f"expected {n_png}")
    launches = read_counts()      # the infer run and the replays
    log(f"replay: {len(pngs)} PNG frames, "
        f"{sum(os.path.getsize(os.path.join(out_png, f)) for f in pngs)} B, "
        f"{t_png:.3f} s; replay3d: {os.path.getsize(out_html)} B of HTML, "
        f"{RECORD_STEPS // REPLAY3D_EVERY} frames, {t_html:.3f} s; "
        f"launches with the infer run {launches}")

    # K4 and K1 at 16 worlds against their plain versions.
    moving = held[RECORD_MOVING]
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    acts = torch.cat([
        torch.randint(0, 5, (cfg.max_agents, 3, RECORD_WORLDS), generator=g,
                      device=dev),
        torch.randint(0, 2, (cfg.max_agents, 2, RECORD_WORLDS), generator=g,
                      device=dev)], 1).to(torch.int32)
    k4_err = check_k4_small(cfg, moving, acts,
                            f"record step {RECORD_MOVING}, 16 worlds")
    k1 = check_k1(cfg, moving, f"record step {RECORD_MOVING}, 16 worlds")

    # The 16-world step with and without the log, in turns; in the
    # recording runs, the host time inside the log's callback as well.
    timed = {"plain": [], "recording": [], "callback": []}
    tenv = PackedEnv(cfg, device=dev)
    run_inference(tenv, policy, params, stats, 10)
    for kind in ("plain", "recording") * RECORD_PAIRS:
        cb, spent = None, [0.0]
        if kind == "recording":
            rec = infer.RecordLog(cfg, os.path.join(work, "timed.bin"))

            def cb(i, ps):
                t = time.perf_counter()
                rec(i, ps)
                spent[0] += time.perf_counter() - t
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_inference(tenv, policy, params, stats, RECORD_TIMED,
                      state_cb=cb)
        torch.cuda.synchronize()
        timed[kind].append((time.perf_counter() - t0) / RECORD_TIMED * 1e3)
        if cb is not None:
            rec.close()
            timed["callback"].append(spent[0] / RECORD_TIMED * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in timed.items()}
    log(f"record cost: a {RECORD_WORLDS}-world infer step (4 policies, "
        f"{RECORD_TIMED} steps a run, {RECORD_PAIRS} pairs in turns, wall "
        f"with a sync at the end) "
        f"{[round(x, 3) for x in timed['plain']]} ms without the log, "
        f"{[round(x, 3) for x in timed['recording']]} ms with it, of which "
        f"{[round(x, 3) for x in timed['callback']]} ms in the log's "
        f"callback (record, copy to the host, write); medians "
        f"{med['plain']:.3f} / {med['recording']:.3f} / "
        f"{med['callback']:.3f} ms: the callback is "
        f"{med['callback'] / med['plain'] * 100:.1f} % of a step without "
        f"the log; {gpu}")
    return dict(launches=launches, k4_err=k4_err, k1=k1, timed=med)


def viewer_path(dev, gpu, work: str) -> dict:
    """VIEWER_SCRIPT through the viewer with the follow camera at one world
    (module docstring). Returns the launches."""
    from marl_hideandseek_torch import viewer
    from marl_hideandseek_torch.ops import fused
    from marl_hideandseek_torch.ops import rgbd as R
    from marl_hideandseek_torch.types import pack_state
    from marl_hideandseek_torch.viz import rgbd as plain

    zero_counts()
    t0 = time.perf_counter()
    v = viewer.Viewer(os.path.join(work, "viewer"), follow=True, device=dev)
    saved, checked = None, None
    for cmd in VIEWER_SCRIPT.split():
        before = v.state
        v.command(cmd)
        if cmd == "m":
            saved = before.map(snapshot)
        if cmd == "n":
            checked = v.state.replace(hider_team_reward=saved.hider_team_reward)
            require(all(same(a, b) for a, b in zip(checked.leaves(),
                                                   saved.leaves())),
                    "viewer path: n did not restore the state saved at m")
        if cmd == "l":
            moving = v.state.map(snapshot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = sum(1 for c in VIEWER_SCRIPT.split() if c not in "mnfx")
    require(checked is not None, "viewer path: no load")
    require(launches["fused"] == steps and launches["raycast"] > 0 and
            launches["rgbd"] > 0,
            f"viewer path: launches {launches} for {steps} steps")
    log(f"viewer path: script {VIEWER_SCRIPT!r}, {len(v.written)} frames "
        f"written in {wall:.3f} s ({steps} steps, follow camera until 'f'); "
        f"'n' restored the state saved at 'm'; launches {launches}; {gpu}")

    # K3, K1 and K5 at one world against their plain versions.
    cfg = v.cfg
    ps = pack_state(moving)
    acts = torch.from_numpy(viewer.key_action("w", cfg.max_agents, 0)).to(
        dev).permute(1, 2, 0).contiguous()
    ps, ext_f, ext_t = pre_physics(cfg, ps, acts)
    bk, sk = fused.fused_step_packed(cfg, ps, ext_f, ext_t)
    bp, sp = fused.fused_step_plain(cfg, ps, ext_f, ext_t)
    torch.cuda.synchronize()
    k3_err = check_bodies_small("K3 viewer, 1 world", bk, bp)
    note = check_sweep("K3 viewer, 1 world", sk, sp)
    log(f"K3 viewer, 1 world: body max err {k3_err:.3g}; {note}")
    k1 = check_k1(cfg, ps, "viewer, 1 world")
    rgba, depth = R.render_rgbd_packed_fast(cfg, ps, RENDER_HW, RENDER_HW)
    rgb_k, d_k = R.to_reference_layout(cfg, rgba, depth, RENDER_HW,
                                       RENDER_HW)
    rgb_p, d_p = plain.render_rgbd_packed(cfg, ps, RENDER_HW, RENDER_HW)
    k5_err = compare_k5(rgb_k, d_k, rgb_p, d_p, "the viewer's 1 world")
    return dict(launches=launches, k3_err=k3_err, k1=k1, k5_err=k5_err)


def tooluse_path(dev, gpu, ckpt: str) -> dict:
    """``eval_tooluse`` at its defaults on the train path's checkpoint
    (module docstring). Returns the launches."""
    from marl_hideandseek_torch import eval_tooluse
    from marl_hideandseek_torch.config import EPISODE_LEN, NUM_PREP_STEPS

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eval_tooluse.eval_ckpt(ckpt, TOOLUSE_WORLDS, TOOLUSE_STEPS,
                                 device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    seek = TOOLUSE_WORLDS * sum(1 for i in range(TOOLUSE_STEPS)
                                if i % EPISODE_LEN >= NUM_PREP_STEPS - 1)
    fracs = {k: v for k, v in out.items() if k.endswith("_frac")}
    require(out["seek_steps"] == seek, f"tooluse path: {out['seek_steps']} "
            f"seek world-steps, the step counters give {seek}")
    require(len(fracs) == 5 and all(0.0 <= v <= 1.0 for v in fracs.values()),
            f"tooluse path: fractions {fracs}")
    require(launches["megastep"] == TOOLUSE_STEPS and launches["raycast"] > 0,
            f"tooluse path: launches {launches}")
    log(f"tooluse path: {os.path.basename(ckpt)}, {TOOLUSE_STEPS} steps x "
        f"{TOOLUSE_WORLDS} worlds in {wall:.3f} s; {out}; launches "
        f"{launches}; {gpu}")
    return dict(launches=launches)


def nan_guard(mgr) -> None:
    """One update of ``mgr`` with the NaN guards on passes; one from a
    state with a NaN planted in a parameter leaf raises naming it."""
    from marl_hideandseek_torch.utils import runtime

    leaf = "backbone.critic_encoder.rnn.layer_0_hh.kernel"
    runtime.enable_nan_guards(True)
    try:
        t0 = time.perf_counter()
        mgr.update_iter()
        torch.cuda.synchronize()
        t_on = time.perf_counter() - t0
        bad = dict(mgr.state.params)
        bad[leaf] = bad[leaf].clone()
        bad[leaf].view(-1)[123] = float("nan")
        try:
            mgr.replace(state=mgr.state.replace(params=bad)).update_iter()
        except FloatingPointError as e:
            msg = str(e)
        else:
            msg = ""
    finally:
        runtime.enable_nan_guards(False)
    require(f"params.{leaf} " in msg, f"nan_guard: the planted NaN raised "
            f"{msg!r}")
    log(f"nan_guard: one guarded update (anomaly detection on) in "
        f"{t_on:.3f} s; the planted NaN raised: {msg}")


def entry_phase(dev) -> None:
    """``entry()``'s forward on the card against the CPU at ENTRY_BAR,
    then ``dryrun_multichip(2)`` over 2 gloo ranks sharing the card."""
    from marl_hideandseek_torch import entry

    fn, args = entry.entry(dev)
    got = fn(*args)
    cfn, cargs = entry.entry("cpu")
    want = cfn(*cargs)
    flat = lambda o: [o[0], o[1], *[x for enc in o[2] for x in enc]]
    err = max(max_err(a.cpu(), b) for a, b in zip(flat(got), flat(want)))
    require(err <= ENTRY_BAR, f"entry: card vs CPU {err} > {ENTRY_BAR}")
    t0 = time.perf_counter()
    entry.dryrun_multichip(DP_RANKS, device=str(dev), backend="gloo")
    log(f"entry: forward on 8 agents, card vs CPU max abs err {err:.3g} "
        f"(TF32 off); dryrun_multichip({DP_RANKS}) over gloo ranks sharing "
        f"the card in {time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    sys.exit(main())

"""Training entry point (port of scripts/train.py).

    python -m marl_hideandseek_torch.train --ckpt-dir DIR --tb-dir DIR
        --run-name NAME --num-worlds 1024 --num-updates 100000
        [--steps-per-update 40] [--num-bptt-chunks 4] [--num-minibatches 1]
        [--num-epochs 2] [--lr 1e-4] [--gamma 0.998]
        [--entropy-loss-coef 0.01] [--value-loss-coef 1.0]
        [--clip-value-loss] [--fp16 | --bf16] [--pbt-ensemble-size 2]
        [--pbt-past-policies 2] [--num-hiders 3] [--num-seekers 3]
        [--eval-frequency 500] [--wandb]
        [--backbone pooled|attention|hash|openai_hns|impala_cnn]
        [--restore UPDATE] [--device cuda|cpu] [--data-parallel]
        [--distributed]

train.sh's recipe is ``--num-worlds 1024 --num-updates 100000
--pbt-ensemble-size 2 --pbt-past-policies 2 --num-hiders 2 --num-seekers 2
--bf16`` with the defaults above. The env runs ``RandomFlipTeams |
UseFixedWorld | ZeroAgentVelocity``, seed 5. ``--backbone openai_hns``
(Baker et al. 2019's policy, ``policy.OpenAIHnsNet``) brings its own
action heads (11, 11, 11, 2, 2), its plain value head on EMA-normalized
returns, and the env's force-based movement (no ``ZeroAgentVelocity``).
``--backbone impala_cnn`` (IMPALA's deep residual network,
``policy.ImpalaCnnNet``) trains from each agent's 64x64 RGBD view, which
the env renders every step (``EnvConfig.render_frames``), with the
flagship's buckets and movement and a plain value head. Updates run in
blocks of 10, each block followed by a log of the update count, the
training rate (steps x worlds / s), the ELOs and the ring-buffered
metrics; every
``--eval-frequency`` updates an ``eval_elo`` pass and a checkpoint,
``<ckpt-dir>/<run-name>/<update>.pt``, which ``--restore <update>``
resumes. ``--fp16`` and ``--bf16`` set the policy's compute dtype.
``--device cpu`` runs the plain PyTorch path.

Data parallel, one process per card:

    torchrun --nproc-per-node N -m marl_hideandseek_torch.train
        --data-parallel ...

``--data-parallel`` splits the worlds over the ranks of the process group
that torchrun describes (NCCL; gloo with ``--device cpu``), each rank on
``cuda:LOCAL_RANK``; ``--num-worlds`` is the global count and must divide
by the number of ranks. The ranks compute the update of one process with
all the worlds (``parallel/mesh.py``). Started without torchrun it is the
single-process run. ``--distributed`` asks for the process group even
where torchrun's variables are missing, and fails then: for runs across
nodes (``torchrun --nnodes``). Logs, prints and checkpoints come from rank
0; a checkpoint holds all the worlds and restores at any rank count.
"""

from __future__ import annotations

import argparse
import os
import sys
from time import time

import torch

from marl_hideandseek_torch.config import EnvConfig, SimFlags
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.parallel.mesh import LOCAL, make_mesh
from marl_hideandseek_torch.policy import (
    BACKBONES,
    backbone_recipe,
    make_policy,
)
from marl_hideandseek_torch.train import (
    ActionsConfig,
    PBTConfig,
    PPOConfig,
    ParamExplore,
    TensorboardWriter,
    TrainConfig,
    WandbWriter,
    eval_elo,
    init_training,
    print_elos,
    ring_scalar,
    stop_training,
)
from marl_hideandseek_torch.utils.runtime import (
    init_distributed,
    is_primary_host,
)

BLOCK = 10   # updates between logs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt-dir", type=str, required=True)
    p.add_argument("--tb-dir", type=str, required=True)
    p.add_argument("--run-name", type=str, required=True)
    p.add_argument("--restore", type=int)

    p.add_argument("--num-worlds", type=int, required=True)
    p.add_argument("--num-updates", type=int, required=True)
    p.add_argument("--steps-per-update", type=int, default=40)
    p.add_argument("--num-bptt-chunks", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=1)
    p.add_argument("--num-epochs", type=int, default=2)

    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gamma", type=float, default=0.998)
    p.add_argument("--entropy-loss-coef", type=float, default=0.01)
    p.add_argument("--value-loss-coef", type=float, default=1.0)
    p.add_argument("--clip-value-loss", action="store_true")

    p.add_argument("--fp16", action="store_true")
    p.add_argument("--bf16", action="store_true")

    p.add_argument("--pbt-ensemble-size", type=int, default=0)
    p.add_argument("--pbt-past-policies", type=int, default=0)

    p.add_argument("--num-hiders", type=int, default=3)
    p.add_argument("--num-seekers", type=int, default=3)
    p.add_argument("--eval-frequency", type=int, default=500)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--backbone", type=str, default="pooled",
                   choices=BACKBONES)
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-parallel", action="store_true",
                   help="split the worlds over torchrun's ranks, one card "
                        "each")
    p.add_argument("--distributed", action="store_true",
                   help="require torchrun's process group (runs across "
                        "nodes); with --data-parallel")
    return p.parse_args(argv)


def build(args):
    """(env, TrainConfig, policy) of scripts/train.py:98-184."""
    recipe = backbone_recipe(args.backbone)
    flags = SimFlags.RandomFlipTeams | SimFlags.UseFixedWorld
    if recipe.instant_velocity:
        flags |= SimFlags.ZeroAgentVelocity
    env = PackedEnv(EnvConfig(
        num_worlds=args.num_worlds,
        min_hiders=args.num_hiders, max_hiders=args.num_hiders,
        min_seekers=args.num_seekers, max_seekers=args.num_seekers,
        sim_flags=flags,
        rand_seed=5,
        num_pbt_policies=args.pbt_ensemble_size,
        render_frames=recipe.frames,
    ), device=args.device)
    if args.fp16:
        dtype = torch.float16
    elif args.bf16:
        dtype = torch.bfloat16
    else:
        dtype = torch.float32

    if args.pbt_ensemble_size != 0:
        pbt_cfg = PBTConfig(
            num_teams=2,
            team_size=max(args.num_hiders, args.num_seekers),
            num_train_policies=args.pbt_ensemble_size,
            num_past_policies=args.pbt_past_policies,
            self_play_portion=0.0,
            cross_play_portion=0.0,
            past_play_portion=1.0,
        )
        lr = ParamExplore(base=args.lr, min_scale=0.1, max_scale=10.0,
                          log10_scale=True)
        entropy = ParamExplore(base=args.entropy_loss_coef, min_scale=0.1,
                               max_scale=10.0, log10_scale=True)
    else:
        pbt_cfg = None
        lr = args.lr
        entropy = args.entropy_loss_coef

    cfg = TrainConfig(
        num_worlds=args.num_worlds,
        num_agents_per_world=args.num_hiders + args.num_seekers,
        num_updates=args.num_updates,
        actions=ActionsConfig(actions_num_buckets=recipe.action_buckets),
        steps_per_update=args.steps_per_update,
        num_bptt_chunks=args.num_bptt_chunks,
        lr=lr,
        gamma=args.gamma,
        gae_lambda=0.95,
        algo=PPOConfig(
            num_mini_batches=args.num_minibatches,
            clip_coef=0.2,
            value_loss_coef=args.value_loss_coef,
            entropy_coef=entropy,
            max_grad_norm=5,
            num_epochs=args.num_epochs,
            clip_value_loss=args.clip_value_loss,
        ),
        pbt=pbt_cfg,
        dreamer_v3_critic=recipe.dreamer_critic,
        compute_dtype=dtype,
        seed=5,
        metrics_buffer_size=10,
        # Grouped PPO holds only for fixed symmetric teams under pure
        # past-play (TrainConfig.ppo_group_trainable).
        ppo_group_trainable=(
            args.pbt_ensemble_size != 0
            and args.pbt_past_policies > 0
            and args.num_hiders == args.num_seekers),
    )
    policy = make_policy(dtype=dtype, backbone=args.backbone,
                         device=env.device)
    return env, cfg, policy


def setup_mesh(args):
    """The run's mesh: ``LOCAL`` unless ``--data-parallel`` runs under
    torchrun (or ``--distributed`` asks for the group); then the default
    process group, started here, with ``args.device`` set to the rank's
    card (or the CPU, under gloo)."""
    if args.distributed and not args.data_parallel:
        raise SystemExit("--distributed needs --data-parallel")
    if not args.data_parallel or not (args.distributed or
                                      "WORLD_SIZE" in os.environ):
        return LOCAL
    dev = init_distributed(device=None if args.device == "cuda"
                           else args.device)
    args.device = str(dev)
    mesh = make_mesh()
    if args.num_worlds % mesh.size != 0:
        raise SystemExit(f"--num-worlds {args.num_worlds} does not divide "
                         f"over {mesh.size} ranks")
    return mesh


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.eval_frequency % BLOCK != 0:
        raise SystemExit(f"--eval-frequency must be a multiple of {BLOCK}")
    mesh = setup_mesh(args)
    try:
        return run(args, mesh)
    finally:
        if mesh.group is not None:
            torch.distributed.destroy_process_group()


def run(args, mesh) -> int:
    """The training loop of ``main`` over ``mesh``."""
    primary = is_primary_host()
    env, cfg, policy = build(args)
    log_dir = os.path.join(args.tb_dir, args.run_name)
    if primary:
        writer = (WandbWriter(log_dir, args=args) if args.wandb
                  else TensorboardWriter(log_dir))
    ckpt_dir = os.path.join(args.ckpt_dir, args.run_name)
    restore = (os.path.join(ckpt_dir, f"{args.restore}.pt")
               if args.restore is not None else None)
    mgr = init_training(args.device, cfg, env, policy, restore_ckpt=restore,
                        mesh=mesh)
    if primary and mesh.size > 1:
        print(f"data parallel: {args.num_worlds} worlds over {mesh.size} "
              f"ranks ({mesh.backend})")
    last = {"time": time(), "update": mgr.update_idx}

    def log_block(m):
        st = m.state
        update_id = st.update_idx
        cur = time()
        print(f"Update: {update_id}")
        if update_id > last["update"]:
            fps = (args.num_worlds * args.steps_per_update *
                   (update_id - last["update"]) / (cur - last["time"]))
            print(f"  FPS: {fps:.0f}")
        last["time"], last["update"] = cur, update_id
        if args.pbt_ensemble_size > 0:
            elos = st.elo.cpu()
            print_elos(elos)
            for i, e in enumerate(elos):
                writer.scalar(f"p{i}/elo", float(e), update_id)
            lrs = st.hyper_params["lr"].cpu()
            ents = st.hyper_params["entropy_coef"].cpu()
            for i in range(len(lrs)):
                writer.scalar(f"p{i}/lr", float(lrs[i]), update_id)
                writer.scalar(f"p{i}/entropy_coef", float(ents[i]),
                              update_id)
        for k, v in st.metrics.items():
            # The ring's mean: its last slot aliases against the episode
            # cycle (train.manager.ring_scalar).
            writer.scalar(f"train/{k}", ring_scalar(v), update_id)

    n_outer = (args.num_updates - mgr.update_idx) // args.eval_frequency
    try:
        for _ in range(n_outer):
            for _ in range(args.eval_frequency // BLOCK):
                for _ in range(BLOCK):
                    mgr = mgr.update_iter()
                if primary:
                    log_block(mgr)
            mgr = eval_elo(mgr)
            mgr.save_ckpt(ckpt_dir)
            if primary:
                print(mgr.state.elo.cpu())
                writer.flush()
    finally:
        if primary:
            writer.flush()
            writer.close()
    stop_training(mgr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

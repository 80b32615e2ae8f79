"""What the window drivers share: the configuration's objects built in a
given package (the program's, or the frozen reference's, from the same file
and seed), the settings of a run, and small helpers."""

from __future__ import annotations

import importlib
import time

import torch

M32 = 0xFFFFFFFF
PROGRAM = "marl_hideandseek_torch"
FROZEN = "portbench.reference.frozen"


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def env_config(pkg: str, env: dict, flags, num_worlds: int, seed: int):
    """The package's ``EnvConfig`` of a configuration's ``env`` entry."""
    c = mod(pkg, "config")
    bits = 0
    for f in flags:
        bits |= int(getattr(c.SimFlags, f))
    return c.EnvConfig(
        num_worlds=num_worlds, min_hiders=env["num_hiders"],
        max_hiders=env["num_hiders"], min_seekers=env["num_seekers"],
        max_seekers=env["num_seekers"], max_boxes=env["max_boxes"],
        max_ramps=env["max_ramps"], max_walls=env["max_walls"],
        episode_len=env["episode_len"], sim_flags=c.SimFlags(bits),
        rand_seed=seed & M32)


def make_policy(pkg: str, conf: dict, num_policies: int, device):
    p = conf["policy"]
    return mod(pkg, "policy").make_policy(
        dtype=torch.float32, action_buckets=tuple(p["action_buckets"]),
        backbone=p["backbone"], num_rnn_channels=p["lstm_channels"],
        num_policies=num_policies, device=device)


def train_config(pkg: str, conf: dict, num_worlds: int, seed: int):
    """The package's ``TrainConfig`` of train.sh's recipe (the train CLI's
    ``build``) with this configuration's numbers and ``seed``."""
    c = mod(pkg, "train.cfg")
    t, pbt, env = conf["train"], conf["pbt"], conf["env"]
    lo, hi = pbt["explore_scale"]
    return c.TrainConfig(
        num_worlds=num_worlds,
        num_agents_per_world=env["num_hiders"] + env["num_seekers"],
        num_updates=1 << 30,
        actions=c.ActionsConfig(
            actions_num_buckets=tuple(conf["policy"]["action_buckets"])),
        steps_per_update=t["steps_per_update"],
        num_bptt_chunks=t["bptt_chunks"],
        lr=c.ParamExplore(base=t["lr"], min_scale=lo, max_scale=hi,
                          log10_scale=True),
        gamma=t["gamma"], gae_lambda=t["gae_lambda"],
        algo=c.PPOConfig(
            num_mini_batches=t["minibatches"], clip_coef=t["clip_coef"],
            value_loss_coef=t["value_loss_coef"],
            entropy_coef=c.ParamExplore(base=t["entropy_coef"],
                                        min_scale=lo, max_scale=hi,
                                        log10_scale=True),
            max_grad_norm=t["max_grad_norm"], num_epochs=t["epochs"]),
        pbt=c.PBTConfig(
            num_teams=2, team_size=max(env["num_hiders"], env["num_seekers"]),
            num_train_policies=pbt["train_policies"],
            num_past_policies=pbt["past_policies"], self_play_portion=0.0,
            cross_play_portion=0.0, past_play_portion=1.0),
        dreamer_v3_critic=conf["policy"]["critic"] == "dreamer_v3",
        compute_dtype=torch.float32, seed=seed & M32,
        metrics_buffer_size=t["metrics_buffer_size"],
        ppo_group_trainable=pbt["grouped_ppo"])


def float32_exact() -> None:
    """float32 with TF32 off, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_on() -> None:
    """The control's precision: TF32 in matrix products."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def to_cpu(x):
    """A tree of tensors (dicts, tuples, lists, the state types' ``map``)
    copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    if hasattr(x, "map"):
        return x.map(lambda t: t.cpu())
    return x


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample_ids(seed: int, salt: int, n: int, k: int) -> torch.Tensor:
    """``k`` distinct indices below ``n``, drawn on the host from the
    seed (and a salt per use)."""
    g = torch.Generator().manual_seed((seed * 1000003 + salt) & ((1 << 63) - 1))
    return torch.randperm(n, generator=g)[:min(k, n)].sort().values


def draw_int(seed: int, salt: int, lo: int, hi: int) -> int:
    g = torch.Generator().manual_seed((seed * 7919 + salt) & ((1 << 63) - 1))
    return int(torch.randint(lo, hi, (1,), generator=g))


class Spans:
    """Host-clock spans of the traced run, each closed by a synchronize."""

    def __init__(self, device):
        self.device = device
        self.spans = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def timed(self, name: str, fn, *args, **kwargs):
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(self.device)
        self.add(name, time.perf_counter() - t0)
        return out


class Run:
    """One run's settings: the configuration, the traffic mix, the seed,
    the device, whether it is traced, and what the check compares against
    (``control``: the reference in the precision below the configuration's;
    ``fault``: a planted fault, ``portbench/faults.py``)."""

    def __init__(self, conf: dict, mix: dict, seed: int, device,
                 trace: bool = False, control: bool = False,
                 fault: str = None):
        self.conf, self.mix, self.seed = conf, mix, int(seed)
        self.device = torch.device(device)
        self.trace, self.control, self.fault = trace, control, fault
        self.spans = Spans(self.device)

"""Checks shared by the card tests, ``chip_smoke.py`` and the CPU tests:
the rounding bars of a PPO update, the comparison of two updates at those
bars, the planted optimizer faults the bars must catch, a launcher of
ranks on one machine, drawn inputs of the observation assembly
(``observation_case``), and the naive ensemble forward that the routed
one is held to (``naive_ensemble``). No module of the training path
imports this one.

Rounding bars. Two runs of one PPO update that differ only in rounding
(the card's kernels against the CPU's, bf16 products, ranks' partial sums)
differ on each Adam-moment leaf by an amount a fixed bar cannot resolve:
a leaf whose moments sit at rounding level (an actor-encoder kernel whose
largest mu is 1e-8 of the update's largest) moves by 1e-4 of its largest
when every observation moves one float32 ulp. ``rounding_bars`` measures
that sensitivity on the update itself: two more updates from the same
inputs with every nonzero observation moved one ulp of its dtype up, then
down; a leaf's spread is the larger deviation of the two from the unmoved
update, over the leaf's largest moment, and its bar is ``max(fixed, K x
spread)``. K = 4: the card's update matched the up move to 1.003x on the
leaf that fails the fixed bar (``tools/ppo_rounding_witness.py``;
PERF.md), and a factor of 4 leaves
room for an order of summation that moves a leaf more than one ulp of
input does, while staying far under what a dropped bias correction, a
skipped gradient clip or a lost leaf update moves (``PLANTED_FAULTS``,
whose results are in CHANGES.md). The parameter bars (1e-6 on all but 0.1
% of a leaf, 2 x lr x epochs on all) and the loss bars (1e-6 + 1e-5 |x|)
are the CPU tests' and stay fixed in float32; in bf16, where one ulp is
2^-8, the parameter and loss bars are derived the same way (the
parameters' spread at the leaf's 99.9th percentile).
"""

from __future__ import annotations

import math
import socket
import time
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch.func import functional_call

from marl_hideandseek_torch.config import NUM_LIDAR_SAMPLES
from marl_hideandseek_torch.env.observations import num_vis_targets
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.train import ppo
from marl_hideandseek_torch.train.rollout import MethodCall

K = 4.0
FIXED_BARS = {"mu": 1e-4, "nu": 2e-4, "params": 1e-6}
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
LOSSES = ("loss", "action_loss", "value_loss", "entropy")
FLOAT32_KINDS = ("mu", "nu")
ALL_KINDS = ("mu", "nu", "params", "losses")


def ulp_moved(obs: Dict[str, torch.Tensor],
              up: bool) -> Dict[str, torch.Tensor]:
    """Every nonzero floating observation moved one ulp of its own dtype
    (float32 or bf16) up or down, through its integer bits."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    out = {}
    for k, v in obs.items():
        if v.is_floating_point():
            bits = v.view(ints[v.dtype])
            away = (v > 0) == up                   # |v| grows
            step = torch.where(away, 1, -1).to(bits.dtype)
            v = torch.where(v != 0, (bits + step).view(v.dtype), v)
        out[k] = v
    return out


def _leaf_ratio(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    big = float(b.abs().max())
    return float((a.cpu() - b.cpu()).abs().max()) / big if big > 0 else 0.0


def rounding_bars(update: Callable, obs: Dict[str, torch.Tensor],
                  kinds: Sequence[str] = FLOAT32_KINDS, k: float = K):
    """Run ``update(obs)`` (a ``ppo_update`` result) on ``obs`` and on
    ``obs`` moved one ulp up and down; returns (the unmoved result, the
    bars). Bars are keyed ``(kind, leaf)``: for ``mu`` and ``nu`` a share
    of the leaf's largest moment, for ``params`` an absolute bound on all
    but 0.1 % of the leaf, for ``losses`` an absolute bound; ``kinds``
    says which are derived from the spread (the others stay fixed)."""
    base = update(obs)
    moved = [update(ulp_moved(obs, up)) for up in (True, False)]
    bars = {}
    for name in ("mu", "nu"):
        for leaf, v in getattr(base[1], name).items():
            spread = max(_leaf_ratio(getattr(m[1], name)[leaf], v)
                         for m in moved)
            bars[(name, leaf)] = max(FIXED_BARS[name], k * spread
                                     if name in kinds else 0.0)
    for leaf, v in base[0].items():
        spread = max(float(torch.quantile(
            (m[0][leaf].cpu() - v.cpu()).abs().flatten().double(), 0.999))
            for m in moved)
        bars[("params", leaf)] = max(FIXED_BARS["params"], k * spread
                                     if "params" in kinds else 0.0)
    for name in LOSSES:
        v = base[3][name].cpu()
        fixed = LOSS_ATOL + LOSS_RTOL * v.abs()
        spread = torch.stack([(m[3][name].cpu() - v).abs()
                              for m in moved]).amax(0)
        bars[("losses", name)] = (torch.maximum(fixed, k * spread)
                                  if "losses" in kinds else fixed)
    return base, bars


def compare_updates(got, want, start_params: Dict[str, torch.Tensor],
                    bars: Dict[Tuple[str, str], object], lr: float,
                    epochs: int) -> dict:
    """Two ``ppo_update`` results at ``bars`` (``rounding_bars``):
    parameters within their bar on all but 0.1 % of each leaf (rounded
    up) and within 2 x lr x epochs on all, each moment leaf within its
    share of the leaf's largest, losses within their bars, counts and
    dropped fractions equal; and every parameter leaf of ``want`` moved
    from ``start_params``. Returns ``violations`` (a list of what failed)
    and ``worst``: each kind's largest error over its bar, with its leaf."""
    params_g, opt_g, _, met_g = got
    params_w, opt_w, _, met_w = want
    violations = []
    worst: Dict[str, Tuple[float, str]] = {}

    def note(kind, ratio, leaf):
        if ratio > worst.get(kind, (-1.0, ""))[0]:
            worst[kind] = (ratio, leaf)
        if ratio > 1.0:
            violations.append(f"{kind} {leaf}: {ratio:.4g} of its bar")

    step_bar = 2 * lr * epochs
    for leaf, v in params_w.items():
        d = (params_g[leaf].cpu() - v.cpu()).abs().flatten()
        bar = bars[("params", leaf)]
        allowed = math.ceil(0.001 * d.numel())
        kth = (float(torch.topk(d, allowed + 1).values[-1])
               if d.numel() > allowed else 0.0)
        note("params", kth / bar, leaf)
        note("params_max", float(d.max()) / step_bar, leaf)
        if float((v.cpu() - start_params[leaf].cpu()).abs().max()) == 0.0:
            violations.append(f"params {leaf}: the reference did not move")
    for name in ("mu", "nu"):
        for leaf, v in getattr(opt_w, name).items():
            note(name, _leaf_ratio(getattr(opt_g, name)[leaf], v)
                 / bars[(name, leaf)], leaf)
    for name in LOSSES:
        err = (met_g[name].cpu() - met_w[name].cpu()).abs()
        note("losses", float((err / bars[("losses", name)]).max()), name)
    if not torch.equal(opt_g.count.cpu(), opt_w.count.cpu()):
        violations.append("Adam counts differ")
    if not torch.equal(met_g["dropped_agent_frac"].cpu(),
                       met_w["dropped_agent_frac"].cpu()):
        violations.append("dropped fractions differ")
    return {"violations": violations, "worst": worst}


# -- planted faults ----------------------------------------------------------
# Replacements of ``ppo.clipped_adam`` (install with monkeypatch) that the
# bars must catch: built on the real function, so they differ from it in
# the planted fault alone.

_clipped_adam = ppo.clipped_adam


def adam_without_bias_correction(grads, state, max_grad_norm):
    """Adam's step ``mu / (sqrt(nu) + eps)``: the bias correction
    dropped."""
    _, new = _clipped_adam(grads, state, max_grad_norm)
    return {k: new.mu[k] / (torch.sqrt(new.nu[k]) + ppo.ADAM_EPS)
            for k in grads}, new


def adam_without_clip(grads, state, max_grad_norm):
    """Adam on the unclipped gradients."""
    return _clipped_adam(grads, state, math.inf)


def adam_zeroing(leaf: str):
    """Adam with ``leaf``'s update zeroed."""
    def fn(grads, state, max_grad_norm):
        updates, new = _clipped_adam(grads, state, max_grad_norm)
        updates[leaf] = torch.zeros_like(updates[leaf])
        return updates, new
    return fn


def grad_norms(grads, state, max_grad_norm, seen: list):
    """``clipped_adam`` that appends each call's per-policy gradient norm
    to ``seen`` (bind ``seen`` with functools.partial)."""
    p = state.count.shape[0]
    seen.append(torch.sqrt(sum(g.square().reshape(p, -1).sum(1)
                               for g in grads.values())).cpu())
    return _clipped_adam(grads, state, max_grad_norm)


PLANTED_FAULTS = ("bias_correction", "clip", "zero_leaf")


def planted_fault(name: str, leaf: str):
    """The ``clipped_adam`` replacement of a fault of ``PLANTED_FAULTS``
    (``leaf``: the leaf that ``zero_leaf`` zeroes)."""
    return {"bias_correction": adam_without_bias_correction,
            "clip": adam_without_clip,
            "zero_leaf": adam_zeroing(leaf)}[name]


# -- ranks on one machine --------------------------------------------------------

def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn: Callable, nprocs: int, args: tuple = (),
                timeout: float = 600.0) -> None:
    """Run ``fn(rank, nprocs, "localhost:<port>", *args)`` in ``nprocs``
    fresh processes (spawned: nothing of this process's state is shared)
    and wait for all of them. Raises if any rank raises or exits non-zero
    (the others are terminated) or if they are not done within
    ``timeout`` seconds (all are killed)."""
    import torch.multiprocessing as mp

    address = f"localhost:{free_port()}"
    ctx = mp.start_processes(fn, args=(nprocs, address) + tuple(args),
                             nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{nprocs} ranks not done in {timeout} s")


def observation_case(cfg, ps, seed: int):
    """Inputs of the observation assembly drawn from ``seed``, on the
    packed state's device and in its shapes: (state, vis_seen, lidar).
    Every field the assembly reads is redrawn: unit quaternions (world 0's
    bodies at pitch +90 degrees, where euler takes its clamp branch),
    positions, velocities and sizes; boxes and ramps locked by each team
    or by none; agents grabbing or not, active or not, hiders and
    seekers; as many active boxes and ramps as the slots or fewer; steps
    on both sides of the preparation phase; seen flags and lidar
    depths."""
    dev = ps.step.device
    g = torch.Generator(device=dev).manual_seed(seed)
    nb, na, w = cfg.num_dyn_bodies, cfg.max_agents, ps.step.shape[0]

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    quat = normal(nb, 4, w)
    quat = quat / quat.norm(dim=1, keepdim=True)
    quat[:, 0, 0] = quat[:, 2, 0] = 0.5 ** 0.5
    quat[:, 1, 0] = quat[:, 3, 0] = 0.0
    bodies = ps.bodies.replace(
        pos=10.0 * normal(nb, 3, w), quat=quat, vel=normal(nb, 3, w),
        omega=normal(nb, 3, w), half_ext=0.5 + normal(nb, 3, w).abs(),
        locked=ints(0, 2, nb, w).bool(), owner=ints(0, 4, nb, w))
    ps = ps.replace(
        bodies=bodies,
        grab=ps.grab.replace(target=ints(-1, nb - na, na, w)),
        agent_type=ints(0, 2, na, w),
        agent_active=ints(0, 5, na, w) > 0,
        num_active_boxes=ints(0, cfg.max_boxes + 1, w),
        num_active_ramps=ints(0, cfg.max_ramps + 1, w),
        step=ints(0, cfg.episode_len, w))
    vis = ints(0, 2, na, num_vis_targets(cfg), w).float()
    lidar = torch.where(ints(0, 4, na, NUM_LIDAR_SAMPLES, w) > 0,
                        50.0 * torch.rand((na, NUM_LIDAR_SAMPLES, w),
                                          generator=g, device=dev), 0.0)
    return ps, vis, lidar


def naive_ensemble(policy, all_params, rnn_states, obs,
                   assignments: torch.Tensor, num_policies: int,
                   num_train=None):
    """``apply_ensemble``'s outputs computed naively: every policy on
    every agent with the inputs shared (past policies, at index >=
    ``num_train``, actor-only: values 0, the critic's state passed
    through), then each agent's own policy's row picked out."""
    ac = policy.actor_critic
    nt = num_train if num_train and num_train < num_policies \
        else num_policies
    dists, critic_out, states = functional_call(
        ac, {k: v[:nt] for k, v in all_params.items()}, (rnn_states, obs),
        strict=True)
    logits, values = dists.logits, critic_out["value"][..., 0]
    if nt < num_policies:
        n_past = num_policies - nt
        dists, rnn_p = functional_call(
            MethodCall(ac, "act"),
            {f"ac.{k}": v[nt:] for k, v in all_params.items()},
            (rnn_states, obs), strict=True)
        logits = torch.cat([logits, dists.logits])
        values = torch.cat([values, values.new_zeros((n_past,) +
                                                     values.shape[1:])])
        states = tree_map(lambda a, b: torch.cat(
            [a, b.expand(n_past, *b.shape[1:])]), states, rnn_p)
    idx = assignments.to(torch.long)
    agents = torch.arange(idx.shape[0], device=idx.device)
    return (logits[idx, agents], values[idx, agents],
            tree_map(lambda x: x[idx, :, agents].movedim(0, 1), states))

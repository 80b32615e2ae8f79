"""The comparisons that decide ``correct``: what the timed path produced,
against the frozen plain reference (``reference/frozen``) given the same
inputs. The reference imports nothing of the program; the program's
outputs reach it only as tensors to be judged.

Every function returns ``{number: reading}``; the traffic mix's file
holds each number's limit. ``control=True`` computes the reference one
precision below the configuration's: TF32 in the policy's matrix
products (the flagship states float32 with TF32 off), and the
simulator's float32 state, which has no matrix products, held in
bfloat16 where the step takes it. Those are the readings that must fail.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.drivers import common
from portbench.reference.frozen import prng
from portbench.reference.frozen import types as ftypes

# One step of the kernel and its plain version from the same input: the
# port's one-step bars (tests/test_torch_step.py). Velocity is a position
# difference over h = 1/120 s, angular velocity 2/h times a quaternion
# difference, hence 120x and 240x the position bar.
TIGHT = {"pos": 1e-4, "quat": 1e-4, "vel": 1.2e-2, "omega": 2.4e-2}
# Every other float output (observations, grab state, hit distances,
# scores, rewards): absolute and relative.
FLOAT_TOL = 1e-3
# K5 against the plain renderer: depth (absolute, relative); colours equal.
DEPTH_TOL = (1e-3, 1e-4)


def close(got: torch.Tensor, want: torch.Tensor, atol=FLOAT_TOL,
          rtol=FLOAT_TOL) -> torch.Tensor:
    """Elementwise: floats within ``atol + rtol * |want|`` (NaN equal to
    NaN, infinities equal in sign), other types equal."""
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)} against "
                         f"{tuple(want.shape)}")
    if got.dtype == torch.uint32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if want.is_floating_point():
        return torch.isclose(got.float(), want.float(), atol=atol, rtol=rtol,
                             equal_nan=True)
    return got == want


class WorldTally:
    """Per probed world, whether any element it produced is out of
    tolerance (floats) or differs (integers, booleans, words)."""

    def __init__(self, n_worlds: int):
        self.bad = torch.zeros(n_worlds, dtype=torch.bool)

    def add(self, got, want, world_axis: int, atol=FLOAT_TOL,
            rtol=FLOAT_TOL) -> None:
        ok = torch.movedim(close(got, want, atol, rtol), world_axis, 0)
        self.bad |= ~ok.reshape(ok.shape[0], -1).all(1)


# -- the environment step -----------------------------------------------------

SUBTREES = {"bodies": ftypes.RigidBodies, "statics": ftypes.StaticGeom,
            "grab": ftypes.GrabState}


def frozen_state(ps, cls=ftypes.EnvState, fn=lambda x: x):
    """A program state (copied to the host) as the reference's type."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(ps, f.name)
        kw[f.name] = (frozen_state(v, SUBTREES[f.name], fn)
                      if f.name in SUBTREES else fn(v))
    return cls(**kw)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """The control: a float leaf held in bfloat16."""
    if x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def compare_state(t: WorldTally, got, want) -> None:
    """Every leaf of a packed state (world axis last)."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in SUBTREES:
            compare_state(t, a, b)
        elif f.name in TIGHT and isinstance(want, ftypes.RigidBodies):
            t.add(a, b, -1, atol=TIGHT[f.name], rtol=0.0)
        else:
            t.add(a, b, -1)


def env_numbers(records: list, env_cfg, control: bool) -> dict:
    """Each probed step again on the frozen plain env (CPU), from the
    probed worlds' state before it with the same actions, resets and world
    ids: the share of probed world-steps in which any element of the state
    after, the observations, rewards or dones is out of tolerance."""
    from portbench.reference.frozen.env.packed import PackedEnv

    env = PackedEnv(env_cfg, device="cpu")
    fn = bf16_round if control else (lambda x: x)
    bad = n = 0
    for r in records:
        ps = frozen_state(r["pre"], fn=fn)
        ps2, res = env.step(ps, r["actions"], r["resets"], r["base_key"],
                            world_ids=r["world_ids"])
        t = WorldTally(r["world_ids"].shape[0])
        compare_state(t, r["post"], ps2)
        for k, v in res.obs.items():
            t.add(r["obs"][k], v, 0)
        t.add(r["rewards"], res.rewards, -1)
        t.add(r["dones"], res.dones, -1)
        bad += int(t.bad.sum())
        n += t.bad.numel()
    return {"env_world_miss": bad / max(n, 1)}


def rgbd_numbers(records: list, env_cfg, hw, control: bool) -> dict:
    """K5's images of the probed worlds after each probed step against the
    frozen plain renderer on the same state: the share of pixels whose
    depth or colour differs."""
    from portbench.reference.frozen.ops import rgbd as R
    from portbench.reference.frozen.viz import rgbd as plain

    fn = bf16_round if control else (lambda x: x)
    bad = n = 0
    for r in records:
        ps = frozen_state(r["post"], fn=fn)
        rgb_k, d_k = R.to_reference_layout(env_cfg, r["rgba"], r["depth"],
                                           hw[0], hw[1])
        rgb_p, d_p = plain.render_rgbd_packed(env_cfg, ps, hw[0], hw[1])
        ok = torch.isclose(d_k, d_p, atol=DEPTH_TOL[0],
                           rtol=DEPTH_TOL[1]).all(-1) & (rgb_k == rgb_p).all(-1)
        bad += int((~ok).sum())
        n += ok.numel()
    return {"rgbd_pixel_miss": bad / max(n, 1)}


# -- the policy forward and the action draw -----------------------------------

def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference over the reference's largest magnitude (at
    least 1)."""
    got, want = got.float().cpu(), want.float().cpu()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def gumbel_rows(key: torch.Tensor, buckets, total: int,
                rows: torch.Tensor) -> list:
    """The Gumbel noise that ``DiscreteActionDistributions.sample(key)``
    adds to rows ``rows`` of a batch of ``total``: per action dim
    ``[len(rows), bucket]``."""
    keys = prng.split(key, len(buckets))
    g = prng.gumbel(keys, (max(buckets) * total,))
    out = []
    for i, b in enumerate(buckets):
        idx = rows[:, None] * b + torch.arange(b)[None]
        out.append(g[i][idx])
    return out


def draw_from(logits: torch.Tensor, noise: list, buckets) -> torch.Tensor:
    lgs = torch.split(logits.float().cpu(), list(buckets), -1)
    return torch.stack([torch.argmax(n + lg, -1) for n, lg in
                        zip(noise, lgs)], -1)


def run_inference_keys(step: int) -> torch.Tensor:
    """The key ``infer.run_inference`` samples step ``step`` with: ``key,
    sub = split(key)`` from ``PRNGKey(7)``, once a step."""
    key = prng.key(7)
    for _ in range(step + 1):
        key, sub = prng.split(key).unbind(0)
    return sub


def serve_numbers(records: list, conf: dict, params: dict, stats: dict,
                  total_agents: int, device, control: bool) -> dict:
    """The serve loop's forward at each probed step, for the probed
    agents, against the frozen policy on the same weights, statistics,
    observations and recurrent state (on the card, float32 with TF32 off;
    the control with TF32 on): the largest relative error of logits,
    values and recurrent state, and the share of actions that differ from
    the reference's draw with the loop's own key."""
    from portbench.reference.frozen.models.actor_critic import tree_map
    from portbench.reference.frozen.models.normalizer import NormalizerState
    from portbench.reference.frozen.train.rollout import apply_ensemble

    (common.tf32_on if control else common.float32_exact)()
    n_pol = conf["serve_policies"]
    policy = common.make_policy(common.FROZEN, conf, n_pol, device)
    norm = policy.obs_preprocess
    ac = policy.actor_critic
    buckets = tuple(conf["policy"]["action_buckets"])
    st = NormalizerState(mean={k: v.to(device) for k, v in stats["mean"].items()},
                         var={k: v.to(device) for k, v in stats["var"].items()},
                         count=stats["count"].to(device))
    p = {k: v.to(device) for k, v in params.items()}
    err, bad, n = 0.0, 0, 0
    with torch.no_grad():
        for r in records:
            obs = {k: v.to(device) for k, v in r["obs"].items()}
            rnn = tree_map(lambda x: x.to(device), r["rnn"])
            lg, val, new = apply_ensemble(
                policy, p, rnn, norm.normalize(st, obs),
                r["assignments"].to(device), n_pol)
            new = ac.clear_recurrent_state(new, r["done_agents"].to(device))
            err = max(err, rel_err(r["logits"], lg), rel_err(r["values"], val),
                      *(rel_err(a, b) for a, b in zip(
                          [x for e in r["rnn_next"] for x in e],
                          [x for e in new for x in e])))
            noise = gumbel_rows(run_inference_keys(r["step"]), buckets,
                                total_agents, r["agents"])
            want = draw_from(lg, noise, buckets)
            bad += int((r["actions"].cpu() != want).any(-1).sum())
            n += want.shape[0]
    common.float32_exact()
    return {"forward_rel_err": err, "action_miss": bad / max(n, 1)}

"""The training cell's comparison: the reference follows the program's
first three updates.

The rollout draws its actions from logits that rounding moves, and the
physics is chaotic, so no independent rollout reproduces the program's
buffers: the reference takes each update's buffer as the program made it
(observations, actions, rewards, dones, recurrent chunk starts) and checks
that stage on its own: the forward at every chunk start against the
buffer's values and log-probabilities, the action draw with the rollout's
own keys, and the env step on probed worlds (``env_numbers``). Everything
else it works out itself from the seed: the initial parameters,
hyperparameters and keys, the normalizer statistics, and three PPO
updates with their Adam states (frozen ``train/ppo.py`` on the card).

Numbers:

* ``start_err``: the program's initial parameters and hyperparameters
  against the reference's draws from the seed;
* ``loss_gap``: each update's loss per train policy, relative;
* ``moment_gap``: per leaf and policy, the gap between the norms of the
  program's and the reference's Adam first moment after the first update
  (the gradient as the optimizer holds it), over the larger of the
  reference's norm and the median leaf's;
* ``change_gap``: the same for the parameters' change over the three
  updates, leaves whose reference moment is under a thousandth of the
  median leaf's left out (their gradient is nought to rounding and Adam
  moves them by round-off alone);
* ``forward_rel_err`` and ``action_miss`` at the chunk starts, as in
  ``compare.serve_numbers``.
"""

from __future__ import annotations

import statistics

import torch

from portbench.drivers import common
from portbench.reference.compare import draw_from, gumbel_rows, rel_err

MOVED_FLOOR = 1e-3


def _norms(tree: dict) -> dict:
    """Per leaf and policy: the norm of ``tree[leaf][p]``."""
    return {(k, p): float(v[p].double().norm()) for k, v in tree.items()
            for p in range(v.shape[0])}


def _gaps(got: dict, want: dict, keep=None) -> float:
    med = statistics.median(want.values())
    gaps = [abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in want if keep is None or keep[k]]
    return max(gaps)


def train_numbers(rec: dict, conf: dict, num_worlds: int, seed: int,
                  device, control: bool) -> dict:
    from portbench.reference.frozen import prng
    from portbench.reference.frozen.models import DiscreteActionDistributions
    from portbench.reference.frozen.models.actor_critic import tree_map
    from portbench.reference.frozen.models.layers import draw_params
    from portbench.reference.frozen.train import pbt, ppo, rollout

    (common.tf32_on if control else common.float32_exact)()
    cfg = common.train_config(common.FROZEN, conf, num_worlds, seed)
    policy = common.make_policy(common.FROZEN, conf, 1, device)
    norm, ac = policy.obs_preprocess, policy.actor_critic
    n_train = cfg.num_train_policies
    n_past = cfg.total_policies - n_train
    buckets = tuple(conf["policy"]["action_buckets"])

    k_env, k_param, k_roll, k_hyper, k_state = prng.split(
        prng.key(cfg.seed, device), 5).unbind(0)
    k_roll, _ = prng.split(k_roll).unbind(0)
    params = draw_params(ac, prng.split(k_param.cpu(), n_train), device)
    hyper = pbt.init_hyper_params(cfg, k_hyper)
    start = max(rel_err(rec["params0"][k], params[k].cpu()) for k in params)
    start = max(start, *(rel_err(rec["hyper0"][k], hyper[k].cpu())
                         for k in hyper))
    params0 = {k: v.clone() for k, v in params.items()}
    past = {k: v[:1].expand(n_past, *v.shape[1:]).clone()
            for k, v in params.items()}
    opt = ppo.init_opt_state(params)
    value_stats = ppo.init_value_stats(cfg, device)
    obs_stats = None
    key, rkey = k_state, k_roll

    loss_gap = fwd_err = 0.0
    miss = n_draw = 0
    moment_gap = ref_mu = None
    if not rec["updates"]:
        common.float32_exact()
        return {"start_err": start, "loss_gap": float("inf"),
                "moment_gap": float("inf"), "change_gap": float("inf")}
    for u in rec["updates"]:
        buf = rollout.RolloutBuffer(**{
            k: tree_map(lambda x: x.to(device), v)
            for k, v in u["buffer"].items()})
        c, t, n = buf.log_probs.shape
        if obs_stats is None:
            obs_stats = norm.init_state({k: v[0, 0] for k, v in buf.obs.items()})
        agents = u["agents"].to(device)
        all_params = {k: torch.cat([v, past[k]], 0) for k, v in params.items()}
        rkey, sub = prng.split(rkey).unbind(0)
        step_keys = prng.split(prng.split(sub, cfg.steps_per_update))
        with torch.no_grad():
            for ci in range(c):
                obs = {k: v[ci, 0][agents] for k, v in buf.obs.items()}
                rnn = tree_map(lambda x: x[ci][:, agents], buf.rnn_start_states)
                lg, val, _ = rollout.apply_ensemble(
                    policy, all_params, rnn, norm.normalize(obs_stats, obs),
                    buf.assignments[ci, 0][agents], cfg.total_policies,
                    num_train=n_train)
                acts = buf.actions[ci, 0][agents]
                lp = DiscreteActionDistributions(buckets, lg).log_prob(acts)
                fwd_err = max(fwd_err, rel_err(buf.values[ci, 0][agents], val),
                              rel_err(buf.log_probs[ci, 0][agents], lp))
                k_act = step_keys[ci * t, 0].cpu()
                want = draw_from(lg, gumbel_rows(k_act, buckets, n,
                                                 agents.cpu()), buckets)
                miss += int((acts.cpu() != want).any(-1).sum())
                n_draw += want.shape[0]
        obs_stats = norm.update_state(obs_stats, {
            k: v.reshape((-1,) + v.shape[3:]) for k, v in buf.obs.items()})
        key, k_ppo, _ = prng.split(key, 3).unbind(0)
        params, opt, value_stats, metrics = ppo.ppo_update(
            cfg, policy, params, opt, obs_stats, value_stats, hyper, buf,
            k_ppo)
        loss = metrics["loss"].cpu()
        loss_gap = max(loss_gap, float(((u["loss"] - loss).abs() /
                                        loss.abs().clamp(min=1.0)).max()))
        if moment_gap is None:
            ref_mu = _norms({k: v.cpu() for k, v in opt.mu.items()})
            moment_gap = _gaps(_norms(u["mu"]), ref_mu)
        del buf
        torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None

    med = statistics.median(ref_mu.values())
    keep = {k: v >= MOVED_FLOOR * med for k, v in ref_mu.items()}
    want = _norms({k: (params[k] - params0[k]).cpu() for k in params})
    end = rec.get("params_end", rec["params0"])
    got = _norms({k: end[k] - rec["params0"][k] for k in params})
    common.float32_exact()
    return {"start_err": start, "loss_gap": loss_gap,
            "moment_gap": moment_gap, "change_gap": _gaps(got, want, keep),
            "forward_rel_err": fwd_err, "action_miss": miss / max(n_draw, 1),
            "leaves_left_out": " ".join(f"{k}[{p}]" for (k, p), v in
                                        keep.items() if not v)}

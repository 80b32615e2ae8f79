"""PPO update with BPTT sequence replay over a policy ensemble.

Port of ``marl_hideandseek_tpu/train/ppo.py``: GAE, the EMA return
statistics of the plain critic, the clipped surrogate with a Dreamer-V3
two-hot (or a plain, optionally clipped or Huber) value loss and an
entropy bonus, replayed through the stored LSTM chunk-start states, for
``num_epochs`` x ``num_mini_batches`` steps of a per-policy Adam.

All train policies update together: their parameters carry a leading
policy axis, one forward and one backward over the sum of their losses
give each policy its own gradient (no parameter is shared), and the
optimizer (``clip_by_global_norm`` then ``scale_by_adam``, ppo.py:31-37)
keeps per policy its gradient norm, its step count and its learning rate,
as JAX's ``vmap`` over the policies does. Under pure past-play PBT the
grouped path first gathers each train policy's own agents (about half
the batch), so each policy replays only those.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
from torch.func import functional_call

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.models import Policy
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.parallel.mesh import LOCAL, Mesh
from marl_hideandseek_torch.train.cfg import TrainConfig
from marl_hideandseek_torch.train.rollout import (
    MethodCall,
    RolloutBuffer,
    compute_gae,
)
from marl_hideandseek_torch.utils import tracing

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.scale_by_adam's


@dataclasses.dataclass
class AdamState:
    """Adam's moments per parameter (``[P, ...]``, flat names as the
    parameters) and its step count per policy (``[P]`` i32)."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor


def init_opt_state(params: Mapping[str, torch.Tensor]) -> AdamState:
    """Zero moments and counts for policy-stacked ``params``."""
    p = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=torch.zeros(p, dtype=torch.int32, device=dev))


def _per_policy(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``[P]`` vector shaped to broadcast over a ``[P, ...]`` leaf."""
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def clipped_adam(grads: Mapping[str, torch.Tensor], state: AdamState,
                 max_grad_norm: float):
    """``optax.chain(clip_by_global_norm(max_grad_norm), scale_by_adam())``
    for each policy of the stack: the norm is taken over one policy's
    gradients, ``where(norm < max, g, g / norm * max)``; then Adam with b1
    0.9, b2 0.999, eps 1e-8 and no eps_root, the count incremented before
    the bias correction, update ``mu_hat / (sqrt(nu_hat) + eps)``. Returns
    (updates, new state); the caller scales the updates by -lr."""
    p = state.count.shape[0]
    sq = sum(g.square().reshape(p, -1).sum(1) for g in grads.values())
    g_norm = torch.sqrt(sq)
    trigger = g_norm < max_grad_norm
    count = state.count + 1
    bc1 = 1.0 - ADAM_B1 ** count.to(torch.float32)
    bc2 = 1.0 - ADAM_B2 ** count.to(torch.float32)
    mu, nu, updates = {}, {}, {}
    for k, g in grads.items():
        g = torch.where(_per_policy(trigger, g), g,
                        g / _per_policy(g_norm, g) * max_grad_norm)
        mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
        nu[k] = (1.0 - ADAM_B2) * g.square() + ADAM_B2 * state.nu[k]
        mu_hat = mu[k] / _per_policy(bc1, g)
        nu_hat = nu[k] / _per_policy(bc2, g)
        updates[k] = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
    return updates, AdamState(mu=mu, nu=nu, count=count)


def init_value_stats(cfg: TrainConfig, device=None) -> Dict[str, torch.Tensor]:
    """Per-policy EMA return statistics of the plain critic (ppo.py:40-47),
    sized to the whole population; only the train entries move."""
    p = cfg.total_policies
    return {"mu": torch.zeros(p, device=device),
            "sigma": torch.ones(p, device=device)}


def update_value_stats(cfg: TrainConfig, value_stats, returns: torch.Tensor,
                       assignments: torch.Tensor, mesh: Mesh = LOCAL):
    """EMA update of each train policy's return mean and scale from this
    rollout's returns, masked by assignment (ppo.py:50-64). The Dreamer
    critic keeps none. Over ``mesh``, the masked sums are every rank's."""
    if cfg.dreamer_v3_critic:
        return value_stats
    d = cfg.value_normalizer_decay
    n_train = cfg.num_train_policies
    mu, sigma = value_stats["mu"].clone(), value_stats["sigma"].clone()
    masks = [(assignments == p).to(torch.float32) for p in range(n_train)]
    sums = mesh.all_sum(torch.stack(
        [torch.stack([m.sum(), (returns * m).sum()]) for m in masks]))
    denom = torch.clamp(sums[:, 0], min=1.0)
    mean = sums[:, 1] / denom
    var = mesh.all_sum(torch.stack(
        [(torch.square(returns - mean[p]) * m).sum()
         for p, m in enumerate(masks)])) / denom
    s = torch.sqrt(torch.clamp(var, min=1e-6))
    mu[:n_train] = d * mu[:n_train] + (1.0 - d) * mean
    sigma[:n_train] = d * sigma[:n_train] + (1.0 - d) * s
    return {"mu": mu, "sigma": sigma}


def _policy_loss(cfg: TrainConfig, policy: Policy,
                 params: Mapping[str, torch.Tensor], obs_stats, value_stats,
                 minibatch, policy_idx: torch.Tensor,
                 per_policy: bool = False, mesh: Mesh = LOCAL):
    """The losses of P policies over one minibatch (ppo.py:67-142, for
    each policy of the stack).

    params: flat dict, leading axis P. minibatch leaves: ``[C, T, M,
    ...]`` shared by every policy, or with ``per_policy`` ``[P, C, T, M,
    ...]`` (``rnn_start`` ``[(P,) C, L, M, H]``). policy_idx ``[P]``: the
    policy whose agents each loss is over (its assignment mask). The
    chunk axis joins the batch: sequences of length T, batch C * M.
    Advantage normalization and every mean are over each policy's mask.
    Returns (action_loss, value_loss, entropy), each ``[P]``, then the
    ratio and the mask ``[P, T, C * M]`` and the mask's count ``[P]``.
    Over ``mesh`` the minibatch is this rank's share: the mask's count
    and the advantages' mean and variance are the whole minibatch's, and
    each loss is this rank's sum over the whole count (the ranks' losses
    add up to the loss).
    """
    norm = policy.obs_preprocess
    ac = policy.actor_critic
    p = policy_idx.shape[0]
    lead = 1 if per_policy else 0
    c, t, m = minibatch["log_probs"].shape[lead:lead + 3]

    def merge(x):    # [(P,) C, T, M, ...] -> [(P,) T, C * M, ...]
        x = x.transpose(lead, lead + 1)
        return x.reshape(x.shape[:lead] + (t, c * m) + x.shape[lead + 3:])

    def merge_rnn(x):    # [(P,) C, L, M, H] -> [(P,) L, C * M, H]
        x = x.movedim(lead, -3)
        return x.reshape(x.shape[:-3] + (c * m,) + x.shape[-1:])

    def stacked(x):      # per-agent data with the policy axis in front
        return x if per_policy else x.expand(p, *x.shape)

    seq_obs = norm.normalize(obs_stats, {k: merge(v) for k, v in
                                         minibatch["obs"].items()})
    dists, critic_out = functional_call(
        MethodCall(ac, "sequence"), {f"ac.{k}": v for k, v in params.items()},
        (tree_map(merge_rnn, minibatch["rnn_start"]),
         merge(minibatch["dones"]), seq_obs), {"per_policy": per_policy},
        strict=True)

    actions = stacked(merge(minibatch["actions"]))
    old_lp = stacked(merge(minibatch["log_probs"]))
    advantages = stacked(merge(minibatch["advantages"]))
    returns = stacked(merge(minibatch["returns"]))
    old_values = stacked(merge(minibatch["values"]))
    pidx = policy_idx.reshape(p, 1, 1)
    mask = (stacked(merge(minibatch["assignments"])) == pidx).to(
        torch.float32)
    count, adv_sum = mesh.all_sum(torch.stack(
        [mask.sum((1, 2)), (advantages * mask).sum((1, 2))]))
    denom = torch.clamp(count, min=1.0)

    def masked_mean(x):
        return (x * mask).sum((1, 2)) / denom

    adv_mean = (adv_sum / denom).reshape(p, 1, 1)
    adv_var = (mesh.all_sum((torch.square(advantages - adv_mean) *
                             mask).sum((1, 2))) / denom).reshape(p, 1, 1)
    advantages = (advantages - adv_mean) * torch.rsqrt(adv_var + 1e-5)

    ratio = torch.exp(dists.log_prob(actions) - old_lp)
    clip = cfg.algo.clip_coef
    surr1 = ratio * advantages
    surr2 = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * advantages
    action_loss = -masked_mean(torch.minimum(surr1, surr2))

    if cfg.dreamer_v3_critic:
        v_losses = ac.critic.two_hot_loss(critic_out["logits"], returns)
    else:
        # The plain critic learns EMA-normalized returns; the buffer holds
        # true returns and values, mapped into that space here.
        mu_p = value_stats["mu"][policy_idx].reshape(p, 1, 1)
        sig_p = value_stats["sigma"][policy_idx].reshape(p, 1, 1)
        returns_n = (returns - mu_p) / sig_p
        old_values_n = (old_values - mu_p) / sig_p
        values = critic_out["value"][..., 0]

        def v_err(v):
            err = v - returns_n
            if cfg.algo.huber_value_loss:
                a = torch.abs(err)
                return torch.where(a <= 1.0, 0.5 * torch.square(err), a - 0.5)
            return torch.square(err)

        if cfg.algo.clip_value_loss:
            v_clipped = old_values_n + torch.clamp(values - old_values_n,
                                                   -clip, clip)
            v_losses = torch.maximum(v_err(values), v_err(v_clipped))
        else:
            v_losses = v_err(values)
    value_loss = masked_mean(v_losses)
    entropy = masked_mean(dists.entropy())
    return action_loss, value_loss, entropy, ratio, mask, denom


def use_grouped_ppo(cfg: TrainConfig) -> bool:
    """Whether the grouped path applies (ppo.py:151-165): only under pure
    past-play PBT, where every world is one train policy against one
    frozen past policy and half the agent slots carry trainable data.
    Any self-play or cross-play portion takes the masked path."""
    pbt = cfg.pbt
    return bool(cfg.ppo_group_trainable and pbt is not None
                and pbt.num_past_policies > 0
                and pbt.self_play_portion == 0.0
                and pbt.cross_play_portion == 0.0)


def group_gather_indices(n_train: int, n: int, start_assign: torch.Tensor):
    """``[P, cap]`` slot indices gathering each train policy's agents
    (ppo.py:168-192), keyed by each slot's assignment at the rollout's
    start: its slots first, in slot order (a stable sort), cut at ``cap``
    = min(n / 2, 1.25 x the even share rounded up to 128). A policy with
    more slots than ``cap`` drops the rest from this update's loss.
    Returns (g_idx, cap)."""
    n_group = n // 2
    if n_train > 1:
        share = n_group // n_train
        cap = min(n_group, ((share + share // 4) + 127) // 128 * 128)
    else:
        cap = n_group
    idx = [torch.argsort((start_assign != p).to(torch.int32),
                         stable=True)[:cap] for p in range(n_train)]
    return torch.stack(idx), cap


def grouped_dropped_frac(assignments: torch.Tensor, g_idx: torch.Tensor,
                         n_train: int, mesh: Mesh = LOCAL) -> torch.Tensor:
    """Per train policy, the share of its agent-steps that the grouped
    loss drops (ppo.py:195-211): slots beyond the cap, and steps whose
    assignment is the policy but whose slot was gathered into another
    policy's group or none (a mid-rollout switch). assignments ``[C, T,
    N]``; returns ``[P]``. Over ``mesh`` the assignments are this rank's
    agents, ``g_idx`` holds global slots, and the shares are of every
    rank's agent-steps."""
    n = assignments.shape[-1]
    first = mesh.rank * n
    dev = assignments.device
    # This rank's slots of each group; the others land in a spare column.
    local = (g_idx >= first) & (g_idx < first + n)
    member = torch.zeros((n_train, n + 1), dtype=torch.bool, device=dev)
    member.scatter_(1, torch.where(local, g_idx - first, n), True)
    member = member[:, :n]
    p_arr = torch.arange(n_train, device=dev)
    assign_is_p = assignments[None] == p_arr[:, None, None, None]
    dropped, total = mesh.all_sum(torch.stack([
        (assign_is_p & ~member[:, None, None, :]).sum((1, 2, 3)),
        assign_is_p.sum((1, 2, 3))]))
    return dropped / torch.clamp(total, min=1)


def _members(slots: torch.Tensor, first: int, n: int, seg: torch.Tensor,
             mesh: Mesh):
    """The positions ``seg`` ``[m]`` of each row of ``slots`` ``[Q, G]``
    (global agent slots by position) that hold one of this rank's ``n``
    agents from ``first``: their local agent indices ``[Q, K]``, in
    ``seg``'s order, padded with agent 0, and whether each is real ``[Q,
    K]``. K is the largest row's count (at least 1); in one process every
    position is real and K = m."""
    loc = slots[:, seg] - first
    if mesh.group is None:
        return loc, torch.ones_like(loc, dtype=torch.bool)
    real = (loc >= 0) & (loc < n)
    order = torch.argsort((~real).to(torch.int8), dim=1, stable=True)
    order = order[:, :max(int(real.sum(1).max()), 1)]
    real = torch.gather(real, 1, order)
    return torch.where(real, torch.gather(loc, 1, order), 0), real


def epoch_permutations(key: torch.Tensor, num_epochs: int,
                       n: int) -> torch.Tensor:
    """Each epoch's agent permutation ``[E, n]``: ``permutation(k, n)``
    for each k of ``split(key, num_epochs)`` (ppo.py:284,340)."""
    return prng.permutation(prng.split(key, num_epochs), n)


def ppo_update(cfg: TrainConfig, policy: Policy,
               all_params: Mapping[str, torch.Tensor],
               all_opt_states: AdamState, obs_stats, value_stats,
               hyper_params: Mapping[str, torch.Tensor],
               buffer: RolloutBuffer, key: torch.Tensor,
               mesh: Mesh = LOCAL):
    """The full PPO update: epochs x minibatches over the buffer
    (ppo.py:214-352).

    all_params / all_opt_states: the train policies, leading axis
    ``num_train_policies``; hyper_params: per-policy ``lr`` and
    ``entropy_coef`` ``[P]``. ``key`` splits into the epochs' keys, each
    drawing its epoch's agent permutation (``jax.random.permutation``,
    ppo.py:284,340) when there is more than one minibatch; with one, the
    update is deterministic given the buffer. Returns (params, opt_states,
    value_stats, metrics), the metrics ``[P]`` means over the epochs and
    minibatches, with ``dropped_agent_frac``.

    Over ``mesh`` the buffer holds this rank's agents. The groups and the
    minibatches are those of all the agents (the groups from every rank's
    start assignments, the permutations over all positions), each rank
    replaying its members of each; the gradients of every rank's share of
    the loss are summed in one all-reduce a minibatch, so every rank takes
    the same Adam step.
    """
    with tracing.span("ppo"):
        n_train = cfg.num_train_policies
        c, t, n = buffer.log_probs.shape
        dev = buffer.log_probs.device
        first = mesh.rank * n
        with tracing.span("ppo.gae"):
            advantages, returns = compute_gae(cfg, buffer)
            value_stats = update_value_stats(cfg, value_stats, returns,
                                             buffer.assignments, mesh)
        data = {
            "obs": buffer.obs,
            "actions": buffer.actions,
            "log_probs": buffer.log_probs,
            "values": buffer.values,
            "dones": buffer.dones,
            "assignments": buffer.assignments,
            "advantages": advantages,
            "returns": returns,
            "rnn_start": buffer.rnn_start_states,
        }

        # Every leaf has its agent axis at 2 ([C, T, N, ...]; rnn_start
        # [C, L, N, H]). slots: the global agent at each position of each
        # policy's group [P, cap] (grouped), or of the batch [1, N].
        grouped = use_grouped_ppo(cfg)
        with tracing.span("ppo.batch"):
            if grouped:
                g_idx, size = group_gather_indices(
                    n_train, n * mesh.size,
                    mesh.all_gather(buffer.assignments[0, 0], 0))
                dropped_agent_frac = grouped_dropped_frac(
                    buffer.assignments, g_idx, n_train, mesh)
                slots = g_idx
            else:
                size = n * mesh.size
                dropped_agent_frac = torch.zeros(n_train, device=dev)
                slots = torch.arange(size, device=dev)[None]

        def take(seg):
            """The minibatch of positions ``seg``: each leaf's members at
            ``[P,] C, T, K``, the padding out of every policy's mask."""
            with tracing.span("ppo.batch"):
                idx, real = _members(slots, first, n, seg, mesh)
                if grouped:
                    mb = tree_map(lambda x: x[:, :, idx].movedim(2, 0), data)
                    pad = ~real[:, None, None, :]
                else:
                    mb = tree_map(lambda x: x[:, :, idx[0]], data)
                    pad = ~real[0]
                mb["assignments"] = torch.where(pad, -1, mb["assignments"])
                return mb

        num_mb = cfg.algo.num_mini_batches
        if size % num_mb != 0:
            raise ValueError(f"{size} agents do not divide into {num_mb} "
                             f"minibatches")
        mb_size = size // num_mb
        params = {k: v.detach() for k, v in all_params.items()}
        opt = all_opt_states
        p_idx = torch.arange(n_train, device=dev)
        lr, ent_coef = hyper_params["lr"], hyper_params["entropy_coef"]
        aux = []
        if num_mb > 1:
            with tracing.span("ppo.batch"):
                perms = epoch_permutations(key, cfg.algo.num_epochs, size)
        else:
            # One minibatch: without groups, every rank's own agents in order.
            whole = (take(torch.arange(size, device=dev)) if grouped else data)
        for e in range(cfg.algo.num_epochs):
            for i in range(num_mb):
                mb = (whole if num_mb == 1 else
                      take(perms[e, i * mb_size:(i + 1) * mb_size]))
                with tracing.span("ppo.loss"):
                    leaves = {k: v.detach().requires_grad_() for k, v in
                              params.items()}
                    with torch.enable_grad():
                        a_l, v_l, ent, *_ = _policy_loss(
                            cfg, policy, leaves, obs_stats, value_stats, mb,
                            p_idx, per_policy=grouped, mesh=mesh)
                        total = (a_l + cfg.algo.value_loss_coef * v_l -
                                 ent_coef * ent)
                        grads = torch.autograd.grad(total.sum(),
                                                    list(leaves.values()))
                    grads = mesh.all_sum_many(grads)
                with tracing.span("ppo.adam"):
                    updates, opt = clipped_adam(dict(zip(leaves, grads)), opt,
                                                cfg.algo.max_grad_norm)
                    params = {k: params[k] + (-_per_policy(lr, u)) * u
                              for k, u in updates.items()}
                aux.append(torch.stack([total, a_l, v_l, ent]).detach())
        aux = mesh.all_sum(torch.stack(aux)).mean(0)          # [4, P]
        metrics = {"loss": aux[0], "action_loss": aux[1], "value_loss": aux[2],
                   "entropy": aux[3], "dropped_agent_frac": dropped_agent_frac}
        return params, opt, value_stats, metrics

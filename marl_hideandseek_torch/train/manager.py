"""Training manager: the actor-learner loop's state and its update.

Port of ``marl_hideandseek_tpu/train/manager.py``. ``TrainingManager``
holds the whole training state and ``update_iter`` runs one update: a
rollout on the packed env, the observation normalizer's update from it,
the PPO update of the train policies, ELO from the finished episodes and,
every ``explore_interval`` updates, PBT. ``eval_elo`` plays the whole
population round robin for a dedicated ELO pass. Checkpoints are the
port's ``torch.save`` files (``bridge.save_training_checkpoint``); a JAX
orbax training checkpoint converts to one (``bridge.
training_state_from_numpy``, README.md).

Data parallel (``parallel/mesh.py``): a manager with a ``mesh`` of R ranks
holds this rank's W / R worlds in its rollout and the replicated rest; its
update computes, with one all-reduce per reduction, what one process
computes with all W worlds. Checkpoints hold all the worlds: the primary
rank writes the gathered rollout, and a restore takes this rank's slice,
so a file moves between runs of any rank count.

JAX compiles an update into one program with ``aot_compile``; here each
update is eager PyTorch on the env's device, so ``aot_compile`` and
``cfg_jax_mem`` have no counterpart. The NaN guards that ``aot_compile``
turns on under ``MHS_NAN_GUARDS`` are ``utils/runtime.py``'s here: while
they are on, ``update_iter`` checks the state before and after
(``guard_state``) with the rollout's rewards, ``eval_elo`` the state
after, and the PPO update's backward runs under anomaly detection. Every draw comes from the state's
keys, split in the JAX version's order (``prng.py``), so the same seed
gives JAX's training state and draws.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from marl_hideandseek_torch import bridge, prng
from marl_hideandseek_torch.config import FRAME_KEY
from marl_hideandseek_torch.env.packed import PackedEnv
from marl_hideandseek_torch.models import Policy
from marl_hideandseek_torch.models.layers import draw_params
from marl_hideandseek_torch.models.normalizer import NormalizerState
from marl_hideandseek_torch.parallel.mesh import (
    LOCAL,
    Mesh,
    gather_rollout,
    shard_rollout,
    sharded_packed_init,
)
from marl_hideandseek_torch.policy import resolve_device
from marl_hideandseek_torch.train import elo as elo_mod
from marl_hideandseek_torch.train import pbt as pbt_mod
from marl_hideandseek_torch.train.cfg import TrainConfig
from marl_hideandseek_torch.train.ppo import (
    AdamState,
    init_opt_state,
    init_value_stats,
    ppo_update,
)
from marl_hideandseek_torch.train.rollout import (
    RolloutState,
    _resample_assignments,
    collect_rollout,
    initial_core_inputs,
)
from marl_hideandseek_torch.types import AGENT_HIDER
from marl_hideandseek_torch.utils import tracing
from marl_hideandseek_torch.utils.runtime import (
    anomaly_mode,
    check_finite,
    nan_guards_on,
    sync_hosts,
)

METRIC_KEYS = ("loss", "action_loss", "value_loss", "entropy",
               "dropped_agent_frac", "mean_reward", "hidden_frac",
               "lock_rate", "grab_rate", "ramp_lock_rate", "ramp_move_rate")


# State leaves that hold +inf by design: a ray's miss.
PLUS_INF_LEAVES = ("rollout.env_state.act_hit_t",)


def named_leaves(tree, prefix: str = "") -> dict:
    """Nested dicts, tuples and lists -> ``{"a.b.0": leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(named_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def ring_scalar(buf) -> float:
    """The scalar to log for one ring-buffered metric: the mean over every
    slot, not the last one (manager.py:30-44). With 240-step episodes (6
    updates) a 10-update log cadence aliases against the episode cycle,
    and every third last slot lies wholly in the prep phase."""
    return float(torch.as_tensor(buf, dtype=torch.float32).mean())


class TrainHooks:
    """Extension hooks of ``update_iter`` (manager.py:55-76).

    post_rollout(update_idx, buffer, metrics) -> metrics
        after the rollout, before the PPO update;
    post_update(update_idx, metrics, train_state) -> metrics
        at the end of the update; the returned dict's scalars go into the
        ring-buffered metrics under the keys that exist there.
    """

    def post_rollout(self, update_idx, buffer, metrics):
        return metrics

    def post_update(self, update_idx, metrics, train_state):
        return metrics


@dataclasses.dataclass
class TrainingState:
    """The whole training state (manager.py:97-112)."""

    params: Dict[str, torch.Tensor]       # leading axis: train policies
    opt_states: AdamState
    past_params: Dict[str, torch.Tensor]  # leading axis: past policies
    obs_stats: NormalizerState
    value_stats: Dict[str, torch.Tensor]  # plain critic's return stats
    rollout: RolloutState
    hyper_params: Dict[str, torch.Tensor]  # per train policy
    elo: torch.Tensor                     # [P_total]
    update_idx: int
    key: torch.Tensor                     # [2] u32: PPO and PBT draws
    metrics: Dict[str, torch.Tensor]      # ring buffers

    def replace(self, **kwargs) -> "TrainingState":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class TrainingManager:
    """The training state with the env, policy, config and hooks it runs
    with (manager.py:115-150): ``update_iter``, ``eval_elo``,
    ``save_ckpt`` / ``restore_ckpt`` and ``log_metrics_tensorboard``.
    ``env`` is configured for all the worlds; over ``mesh`` the rollout
    holds this rank's."""

    state: TrainingState
    env: PackedEnv
    policy: Policy
    cfg: TrainConfig
    hooks: Optional[TrainHooks] = None
    mesh: Mesh = LOCAL

    def replace(self, **kwargs) -> "TrainingManager":
        return dataclasses.replace(self, **kwargs)

    @property
    def update_idx(self) -> int:
        return self.state.update_idx

    def all_params(self) -> Dict[str, torch.Tensor]:
        """Train then past policies along the policy axis."""
        st = self.state
        if not st.past_params:
            return st.params
        return {k: torch.cat([v, st.past_params[k]], 0)
                for k, v in st.params.items()}

    def update_iter(self) -> "TrainingManager":
        """One training update (manager.py:152-247): rollout, the
        observation normalizer updated from the fresh buffer (so the
        loss normalizes with the new statistics), PPO, ELO from the
        rollout's finished episodes, then PBT on the incremented update
        count."""
        with tracing.span("update"):
            return self._update()

    def _update(self) -> "TrainingManager":
        cfg, st, mesh = self.cfg, self.state, self.mesh
        guard = nan_guards_on()
        if guard:
            self.guard_state(f"before update {st.update_idx}")
        norm = self.policy.obs_preprocess
        new_rollout, buffer, roll_metrics = collect_rollout(
            cfg, self.env, self.policy, self.all_params(), st.obs_stats,
            st.rollout, st.value_stats, mesh)
        if self.hooks is not None:
            roll_metrics = self.hooks.post_rollout(st.update_idx, buffer,
                                                   roll_metrics)
        with tracing.span("normalizer"):
            obs_stats = norm.update_state(st.obs_stats, {
                k: v.reshape((-1,) + v.shape[3:])
                for k, v in buffer.obs.items()}, mesh)
        key, k_ppo, k_pbt = prng.split(st.key, 3).unbind(0)
        with anomaly_mode():
            params, opt_states, value_stats, ppo_metrics = ppo_update(
                cfg, self.policy, st.params, st.opt_states, obs_stats,
                st.value_stats, st.hyper_params, buffer, k_ppo, mesh)

        with tracing.span("elo"):
            elo = elo_mod.update_elo_pairwise(
                st.elo, *elo_mod.matches_from_episode_results(
                    roll_metrics["episode_results"], roll_metrics["team_pol"],
                    roll_metrics["dones_w"]), mesh)
        update_idx = st.update_idx + 1
        past_params, hyper_params = st.past_params, st.hyper_params
        if cfg.pbt is not None and update_idx % cfg.pbt.explore_interval == 0:
            with tracing.span("pbt"):
                params, opt_states, hyper_params = pbt_mod.explore_exploit(
                    cfg, k_pbt, elo, params, opt_states, hyper_params)
                past_params, elo = pbt_mod.refresh_past_policies(
                    cfg, update_idx, params, past_params, elo)

        scalars = {k: v.mean() for k, v in ppo_metrics.items()}
        scalars.update({k: v for k, v in roll_metrics.items()
                        if k in METRIC_KEYS})
        new_state = st.replace(
            params=params, opt_states=opt_states, past_params=past_params,
            obs_stats=obs_stats, value_stats=value_stats,
            rollout=new_rollout, hyper_params=hyper_params, elo=elo,
            update_idx=update_idx, key=key)
        if self.hooks is not None:
            scalars = self.hooks.post_update(st.update_idx, scalars,
                                             new_state)
        slot = st.update_idx % cfg.metrics_buffer_size
        metrics = {k: v.clone() for k, v in st.metrics.items()}
        for k, v in scalars.items():
            if k in metrics:
                metrics[k][slot] = v
        out = self.replace(state=new_state.replace(metrics=metrics))
        if guard:
            out.guard_state(f"after update {update_idx}",
                            {"rollout.rewards": buffer.rewards})
        return out

    def eval_elo(self, num_steps: Optional[int] = None) -> "TrainingManager":
        """A dedicated ELO pass (manager.py:251-289): ``num_steps``
        (default 6 updates' worth) of the whole population in fresh round
        robin matchups (hiders play ``t0``, seekers ``t1``), frozen
        parameters, from the rollout's state and key; only the ELOs are
        kept. The matchups are keyed by global world ids, so ranks of a
        mesh play the matchups of one process."""
        cfg, st, mesh = self.cfg, self.state, self.mesh
        steps = num_steps or cfg.steps_per_update * 6
        n_pol = cfg.total_policies
        w_idx = mesh.world_ids(st.rollout.env_state.step.shape[0],
                               self.env.device)
        t0 = w_idx % n_pol
        t1 = (w_idx + 1 + w_idx // n_pol) % n_pol
        is_h = (st.rollout.env_state.agent_type == AGENT_HIDER).T   # [W, A]
        fresh = torch.where(is_h, t0[:, None], t1[:, None]).reshape(-1)
        eval_cfg = dataclasses.replace(cfg, steps_per_update=steps,
                                       num_bptt_chunks=1)
        _, _, metrics = collect_rollout(
            eval_cfg, self.env, self.policy, self.all_params(), st.obs_stats,
            st.rollout.replace(assignments=fresh.to(torch.int32)),
            st.value_stats, mesh, record_frames=False)
        elo = elo_mod.update_elo_pairwise(
            st.elo, *elo_mod.matches_from_episode_results(
                metrics["episode_results"], metrics["team_pol"],
                metrics["dones_w"]), mesh)
        out = self.replace(state=st.replace(elo=elo))
        if nan_guards_on():
            out.guard_state(f"after eval_elo at update {st.update_idx}",
                            {"eval.episode_results":
                             metrics["episode_results"]})
        return out

    def guard_state(self, where: str, extra=None) -> None:
        """Raise naming the first non-finite floating leaf of the state
        (``state_tree``'s names, ``act_hit_t``'s +inf on a miss allowed)
        or of ``extra`` (name -> tensor); one reduction each and one copy
        to the host. ``update_iter`` and ``eval_elo`` call it while the NaN
        guards are on."""
        leaves = named_leaves(self.state_tree())
        leaves.update(extra or {})
        check_finite(leaves, where, PLUS_INF_LEAVES)

    # -- checkpoints and logging ------------------------------------------

    def state_tree(self) -> dict:
        """The state as a nested dict of tensors, the training
        checkpoint's format (``bridge.save_training_checkpoint``); over a
        mesh, with this rank's rollout."""
        st = self.state
        ro = st.rollout
        return {
            "params": st.params, "past_params": st.past_params,
            "opt_states": {"mu": st.opt_states.mu, "nu": st.opt_states.nu,
                           "count": st.opt_states.count},
            "obs_stats": {"mean": st.obs_stats.mean, "var": st.obs_stats.var,
                          "count": st.obs_stats.count},
            "value_stats": st.value_stats, "hyper_params": st.hyper_params,
            "elo": st.elo, "update_idx": st.update_idx,
            "metrics": st.metrics, "key": st.key,
            "rollout": {"env_state": bridge.state_to_tree(ro.env_state),
                        "obs": ro.obs, "rnn_states": ro.rnn_states,
                        "assignments": ro.assignments, "key": ro.key},
        }

    def save_ckpt(self, ckpt_dir: str) -> str:
        """Write the training state to ``<ckpt_dir>/<update_idx>.pt``
        (reference: training_mgr.save_ckpt, jax_train.py:277); returns
        the path. Over a mesh every rank calls it: the rollout is gathered,
        the primary rank writes the file of one process, and the ranks
        wait for the write."""
        path = os.path.join(ckpt_dir, f"{self.state.update_idx}.pt")
        whole = self.replace(state=self.state.replace(
            rollout=gather_rollout(self.state.rollout, self.mesh)))
        if self.mesh.rank == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
            bridge.save_training_checkpoint(path, whole.state_tree())
        if self.mesh.group is not None:
            sync_hosts("save_ckpt")
        return path

    def restore_ckpt(self, path: str) -> "TrainingManager":
        """The state of a training checkpoint over this manager's, its
        rollout and keys included; the restored observations take the
        dtype of this manager's (a bf16 JAX run's resume in float32). One
        whose metric ring lacks newer keys keeps their current values.
        Over a mesh, each rank reads the file and keeps its worlds.
        Raises on parameters that do not fit the policy or the config's
        policy counts, on metric keys this code does not know, on a
        rollout of other world or agent counts than this env's, and on a
        checkpoint without threefry keys (torch generator states, from
        before the port drew JAX's streams)."""
        cfg, st = self.cfg, self.state
        dev = self.env.device
        tree = bridge.load_training_checkpoint(path, dev)
        n_train = bridge.check_policy_params(tree["params"], self.policy)
        n_past = (bridge.check_policy_params(tree["past_params"], self.policy)
                  if tree["past_params"] else 0)
        if (n_train, n_past) != (cfg.num_train_policies,
                                 cfg.total_policies - cfg.num_train_policies):
            raise ValueError(
                f"{path}: {n_train} train and {n_past} past policies, the "
                f"config has {cfg.num_train_policies} and "
                f"{cfg.total_policies - cfg.num_train_policies}")
        extra = set(tree["metrics"]) - set(st.metrics)
        if extra:
            raise ValueError(f"{path}: unknown metrics {sorted(extra)}")
        ro = tree["rollout"]
        if "key" not in tree or "key" not in ro:
            raise ValueError(f"{path}: no threefry keys (a checkpoint of "
                             f"torch generator states cannot resume)")
        got = (int(ro["env_state"]["step"].shape[-1]),
               int(ro["assignments"].shape[0]))
        want = (int(st.rollout.env_state.step.shape[-1]) * self.mesh.size,
                int(st.rollout.assignments.shape[0]) * self.mesh.size)
        if got != want:
            raise ValueError(
                f"{path}: a rollout of {got[0]} worlds and {got[1]} agents, "
                f"this run has {want[0]} worlds and {want[1]} agents")
        opt = tree["opt_states"]
        stats = tree["obs_stats"]
        new = st.replace(
            params=tree["params"], past_params=tree["past_params"],
            opt_states=AdamState(mu=opt["mu"], nu=opt["nu"],
                                 count=opt["count"]),
            obs_stats=NormalizerState(mean=stats["mean"], var=stats["var"],
                                      count=stats["count"]),
            value_stats=tree["value_stats"],
            hyper_params=tree["hyper_params"], elo=tree["elo"],
            update_idx=int(tree["update_idx"]),
            metrics={**st.metrics, **tree["metrics"]},
            key=prng.as_key(tree["key"], dev),
            rollout=shard_rollout(RolloutState(
                env_state=bridge.state_from_numpy(ro["env_state"], dev),
                obs={k: v.to(st.rollout.obs[k].dtype)
                     for k, v in ro["obs"].items()},
                rnn_states=ro["rnn_states"],
                assignments=ro["assignments"],
                key=prng.as_key(ro["key"], dev)), self.mesh))
        return self.replace(state=new)

    def log_metrics_tensorboard(self, writer) -> None:
        """Write the ring-buffered metrics to a metric writer
        (manager.py:340-348)."""
        step = self.state.update_idx
        n = min(step, self.cfg.metrics_buffer_size)
        for k, buf in self.state.metrics.items():
            vals = buf.cpu()
            for i in range(n):
                writer.scalar(f"train/{k}", float(vals[i]), step - n + i + 1)


def init_training(dev, cfg: TrainConfig, env: PackedEnv, policy: Policy,
                  restore_ckpt: Optional[str] = None,
                  hooks: Optional[TrainHooks] = None,
                  mesh: Mesh = LOCAL) -> TrainingManager:
    """Build the training state (manager.py:364-452): the env's initial
    worlds and observations, fresh normalizer statistics, the train
    policies drawn from the policy's initialisers, the past policies as
    copies of policy 0, zero Adam states, the PBT hyperparameters, ELO
    1,500 each, and the first matchups drawn with every world done (the
    grouped PPO path needs past-play matchups from the first rollout).
    The keys are JAX's (manager.py:376-424): ``k_env, k_param, k_roll,
    k_hyper, k_state = split(PRNGKey(cfg.seed), 5)``; the env starts from
    ``k_env``, policy ``i`` is drawn as flax draws it from
    ``split(k_param, P)[i]`` (on the CPU), ``k_roll, k_assign0 =
    split(k_roll)`` give the rollout's key and the first matchups, the
    hyperparameters come from ``k_hyper`` and the state keeps ``k_state``.
    So one seed gives JAX's initial state. ``dev`` must be the env's
    device: ``"cuda"`` for the card, ``"cpu"`` for the plain path. With
    ``restore_ckpt``, the state of that training checkpoint replaces the
    fresh one. Over ``mesh`` (every rank calls it) the env is configured
    for all the worlds and this rank builds its slice of the rollout: its
    worlds' init and its slice of the first matchups; the replicated state
    is drawn on every rank from the same keys, then broadcast from rank 0
    as a guard."""
    if resolve_device(dev, "init_training").type != env.device.type:
        raise ValueError(f"init_training(dev={dev!r}) with an env on "
                         f"{env.device}")
    device = env.device
    k_env, k_param, k_roll, k_hyper, k_state = prng.split(
        prng.key(cfg.seed, device), 5).unbind(0)
    k_roll, k_assign0 = prng.split(k_roll).unbind(0)

    lo, hi = mesh.world_range(env.cfg.num_worlds)
    w, a = hi - lo, env.cfg.max_agents
    n_agents = w * a
    norm = policy.obs_preprocess
    ac = policy.actor_critic
    env_state, result = sharded_packed_init(env, mesh, k_env)
    obs = {k: v.reshape((n_agents,) + v.shape[2:])
           for k, v in norm.prep(result.obs).items()}
    if FRAME_KEY in obs:
        # A frame of its own: the env's buffer is rendered over each step.
        obs[FRAME_KEY] = obs[FRAME_KEY].clone()
    if policy.core_inputs:
        obs.update(initial_core_inputs(
            n_agents, cfg.actions.actions_num_buckets, device))
    n_train = cfg.num_train_policies
    n_past = cfg.total_policies - n_train
    params = draw_params(ac, prng.split(k_param.cpu(), n_train), device)
    past_params = ({k: v[:1].expand(n_past, *v.shape[1:]).clone()
                    for k, v in params.items()} if n_past > 0 else {})
    assignments = _resample_assignments(
        k_assign0, torch.ones(w, dtype=torch.bool, device=device),
        torch.zeros(n_agents, dtype=torch.int32, device=device), cfg, w, a,
        env_state.agent_type.T, mesh)
    hyper_params = pbt_mod.init_hyper_params(cfg, k_hyper)
    if mesh.group is not None:
        tensors = [*params.values(), *past_params.values(),
                   *hyper_params.values(), k_roll, k_state]
        tensors = iter(mesh.broadcast_many(tensors))
        params = {k: next(tensors) for k in params}
        past_params = {k: next(tensors) for k in past_params}
        hyper_params = {k: next(tensors) for k in hyper_params}
        k_roll, k_state = next(tensors), next(tensors)
    state = TrainingState(
        params=params,
        opt_states=init_opt_state(params),
        past_params=past_params,
        obs_stats=norm.init_state(obs),
        value_stats=init_value_stats(cfg, device),
        rollout=RolloutState(env_state=env_state, obs=obs,
                             rnn_states=ac.init_recurrent_state(n_agents,
                                                                device),
                             assignments=assignments, key=k_roll),
        hyper_params=hyper_params,
        elo=torch.full((cfg.total_policies,), elo_mod.ELO_START,
                       device=device),
        update_idx=0,
        key=k_state,
        metrics={k: torch.zeros(cfg.metrics_buffer_size, device=device)
                 for k in METRIC_KEYS},
    )
    mgr = TrainingManager(state=state, env=env, policy=policy, cfg=cfg,
                          hooks=hooks, mesh=mesh)
    if restore_ckpt:
        mgr = mgr.restore_ckpt(restore_ckpt)
    return mgr


def stop_training(mgr: TrainingManager) -> None:
    """Tear-down hook (reference: madrona_learn.stop_training): nothing
    runs outside this process, so there is nothing to stop."""
    return None

"""Faults planted in the timed path, under the harness, to show that the
check catches them (``tests/test_portbench_faults.py`` on the CPU, and
``control.py`` on the card for the training cell's upper readings):

* ``unchanged``: a step returns its state unchanged;
* ``half_batch``: half of the batch left out (worlds not stepped; the PPO
  update on half of the agents, its mean taken over them);
* ``altered``: an answer altered where it is produced (an observation of every
  fourth world in the simulator, an action in the serve and training loops).

The exchange between chips has no fault here: every cell runs on one.
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def _env_fault(fault: str, step):
    def faulty(ps, actions, resets=None, base_key=None, world_ids=None):
        ps2, res = step(ps, actions, resets, base_key, world_ids)
        if fault == "unchanged":
            return ps, res
        if fault == "half_batch":
            w = ps.step.shape[-1]
            keep = torch.arange(w, device=ps.step.device) >= w // 2

            def pick(new, old):
                shape = (1,) * (new.dim() - 1) + (-1,)
                if new.dtype == torch.uint32:
                    new, old = new.view(torch.int32), old.view(torch.int32)
                    return torch.where(keep.reshape(shape), old,
                                       new).view(torch.uint32)
                return torch.where(keep.reshape(shape), old, new)
            return ps2.map2(ps, pick), res
        obs = dict(res.obs)
        k = "self_data" if "self_data" in obs else next(iter(obs))
        x = obs[k].clone()
        x[::4] += 1.0
        obs[k] = x
        return ps2, res._replace(obs=obs)
    return faulty


def plant_env(fault, env) -> None:
    """The simulator's faults, on one env instance."""
    if fault is None:
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    env.step = _env_fault(fault, env.step)


def plant_actions(fault) -> None:
    """``altered``: every eighth agent's first action dim moved to the
    next bucket, where the program draws it."""
    if fault != "altered":
        return
    from marl_hideandseek_torch.models import layers

    orig = layers.DiscreteActionDistributions.sample

    def sample(self, key, rows=None):
        out = orig(self, key, rows).clone()
        out[::8, 0] = (out[::8, 0] + 1) % self.buckets[0]
        return out
    layers.DiscreteActionDistributions.sample = sample


def plant_training(fault) -> None:
    """The training faults: ``unchanged`` (an update that returns its
    state), ``half_batch`` (PPO on the first half of the agents)."""
    from marl_hideandseek_torch.train import manager

    if fault == "unchanged":
        manager.TrainingManager.update_iter = lambda self: self
    elif fault == "half_batch":
        from marl_hideandseek_torch.models.actor_critic import tree_map
        from marl_hideandseek_torch.train.rollout import RolloutBuffer

        orig = manager.ppo_update

        def half(cfg, policy, params, opt, obs_stats, value_stats, hyper,
                 buffer, key, mesh=None):
            n = buffer.log_probs.shape[2] // 2
            cut = RolloutBuffer(
                obs={k: v[:, :, :n] for k, v in buffer.obs.items()},
                actions=buffer.actions[:, :, :n],
                log_probs=buffer.log_probs[:, :, :n],
                values=buffer.values[:, :, :n],
                rewards=buffer.rewards[:, :, :n],
                dones=buffer.dones[:, :, :n],
                assignments=buffer.assignments[:, :, :n],
                rnn_start_states=tree_map(lambda x: x[:, :, :n],
                                          buffer.rnn_start_states),
                bootstrap_value=buffer.bootstrap_value[:n])
            return orig(cfg, policy, params, opt, obs_stats, value_stats,
                        hyper, cut, key)
        manager.ppo_update = half
    else:
        plant_actions(fault)

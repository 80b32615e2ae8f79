"""The training window of the ``openai_hns`` policy: ``train.Driver``'s
loop, set-up and probes, with this architecture's counts, the actor's
visible-key tally and a check against the plain reference.

- ``layer_values``: the FLOPs of an update (``counts/openai_hns.py``) for
  ``train_mfu``, and the least time of the attention blocks that the
  ``model.attn`` spans of one update hold, for ``attn_roofline``.
- ``counters``: ``attn_visible_keys``, the mean keys an actor query may
  attend to over the run, read from the device once, after the traced
  stretch.
- ``check``: the frozen PPO and rollout of ``train.Driver.check`` with the
  plain reference (``reference/openai_hns.py``) in place of the frozen
  pooled policy: its initial parameters drawn as the program draws them,
  the reference's own normalizer rule for empty entity rows, and the
  chunk-start values denormalized with the reference's return statistics
  (the plain critic learns EMA-normalized returns; the rollout's buffer
  holds them denormalized).
- The fault ``no_vis_mask`` (``control.py --fault no_vis_mask``): the
  actor attends to every entity, visible or not.
"""

from __future__ import annotations

import math

from portbench.drivers import common, train


def plant(fault) -> None:
    """``no_vis_mask``: the actor's visibility masks all ones, so it
    attends to every entity slot."""
    if fault != "no_vis_mask":
        return
    import torch

    from marl_hideandseek_torch.policy import OpenAIHnsNet

    orig = OpenAIHnsNet.forward

    def forward(self, obs, train=False):
        if self.view == "actor":
            obs = dict(obs)
            for _, _, vis in self.GROUPS:
                obs[vis] = torch.ones_like(obs[vis])
        return orig(self, obs, train)
    OpenAIHnsNet.forward = forward


def draw_reference(ref, keys, device, buckets, lstm):
    """The reference's parameters for the policy keys ``keys [P, 2]``, as
    the program draws them (``models/layers.py``): each from flax's key
    for its module path and its index in the module."""
    from portbench.reference.frozen.models import layers as fl

    out, seen = {}, {}
    for name, (shape, in_dims, init) in ref.params(buckets, lstm).items():
        path, _ = name.rsplit(".", 1)
        i = seen[path] = seen.get(path, -1) + 1
        k = fl.param_key(keys, path.split("."), i)
        if init == "zeros":
            v = fl.zeros(k, shape)
        elif init == "ones":
            v = fl.ones(k, shape)
        else:
            n_in = math.prod(shape[:in_dims])
            v = fl.orthogonal(init[1])(k, (n_in, math.prod(shape) // n_in))
            v = v.reshape(keys.shape[0], *shape)
        out[name] = v.contiguous().to(device)
    return out


class Driver(train.Driver):
    def setup(self) -> None:
        plant(self.run.fault)
        super().setup()

    def layer_values(self) -> dict:
        from portbench.counts import openai_hns as counts
        from portbench.counts import peaks

        pol = self.run.conf["policy"]
        cfg = self.cfg
        steps, epochs = cfg.steps_per_update, cfg.algo.num_epochs
        n_train = cfg.num_train_policies
        n_past = cfg.total_policies - n_train
        assign = self.mgr.state.rollout.assignments
        n_tr = float((assign < n_train).sum())
        n_rest = self.n_agents - n_tr
        roll = (steps + 1) * counts.forward_flops(pol, n_tr, n_rest)
        ppo = counts.ppo_flops(pol, n_tr * steps, epochs)
        # The blocks in one update's model.attn spans: each rollout
        # forward's actor (every agent) and critic (the trained agents'),
        # in three calls (the train policies' two encoders, the past
        # policies' actor); each epoch's loss forward, both encoders, over
        # the trained agents' steps.
        blocks = ((steps + 1) * (self.n_agents + n_tr) +
                  epochs * 2 * n_tr * steps)
        calls = (steps + 1) * (2 * n_train + n_past) + epochs * 2 * n_train
        flops, n_bytes = counts.attn_work(pol, blocks, calls)
        return {"update_flops": roll + ppo,
                "window_flops": (roll + ppo) * self.updates,
                "attn_least_s": peaks.least_seconds(n_bytes, flops),
                "attn_flops": flops, "attn_bytes": n_bytes}

    def counters(self) -> dict:
        out = super().counters()
        net = self.mgr.policy.actor_critic.backbone.actor_encoder.net
        out["attn_visible_keys"] = net.visible_keys.read()
        return out

    def check(self) -> dict:
        from portbench.reference import openai_hns as ref
        from portbench.reference.frozen import policy as fpolicy
        from portbench.reference.frozen.models import Policy
        from portbench.reference.frozen.models import layers as flayers
        from portbench.reference.frozen.train import ppo as fppo
        from portbench.reference.frozen.train import rollout as frollout

        orig = (fpolicy.make_policy, flayers.draw_params, fppo.ppo_update,
                frollout.apply_ensemble)
        fcfg = common.train_config(common.FROZEN, self.run.conf, self.w,
                                   self.run.seed)
        stats = {}

        def make_policy(dtype, action_buckets, backbone, num_rnn_channels,
                        num_policies, device):
            base = orig[0](dtype=dtype, device=device)
            return Policy(
                actor_critic=ref.ActorCritic(num_policies, device,
                                             action_buckets,
                                             num_rnn_channels),
                obs_preprocess=ref.EntityRowNormalizer(base.obs_preprocess))

        def draw_params(module, keys, device=None):
            if not isinstance(module, ref.ActorCritic):
                return orig[1](module, keys, device)
            return draw_reference(ref, keys, device, module.buckets,
                                  module.leaf("actor.Dense_0.kernel").shape[1])

        def ppo_update(*args, **kwargs):
            out = orig[2](*args, **kwargs)
            stats["value"] = out[2]
            return out

        def apply_ensemble(policy, all_params, rnn, obs, assignments, *args,
                           **kwargs):
            lg, val, new = orig[3](policy, all_params, rnn, obs, assignments,
                                   *args, **kwargs)
            if "value" in stats:
                val = frollout.denormalize_values(fcfg, stats["value"], val,
                                                  assignments)
            return lg, val, new

        fpolicy.make_policy, flayers.draw_params = make_policy, draw_params
        fppo.ppo_update, frollout.apply_ensemble = ppo_update, apply_ensemble
        try:
            return super().check()
        finally:
            (fpolicy.make_policy, flayers.draw_params, fppo.ppo_update,
             frollout.apply_ensemble) = orig

"""The training window of the ``impala_cnn`` policy: ``train.Driver``'s
loop, set-up and probes on an env that renders each agent's frame in its
step, with this architecture's counts, the frame and torso tallies and a
check against the plain reference.

- ``layer_values``: the FLOPs of an update (``counts/impala_cnn.py``) for
  ``train_mfu``; the least time of the torso forwards that the
  ``model.torso`` spans of one update hold, for ``torso_roofline``; the
  least time of one launch of K5's frames mode on the last frames, for
  ``k5_roofline.train``.
- ``counters``: the frames rendered (K5's frames-mode launches times
  the agents) and the frames through the torso in the traced update, and
  K5's frames-mode launches.
- ``check``: the probed steps' frames against the frozen plain renderer
  on the same states (``frame_pixel_miss``); the first checked update's
  chunk-start forwards, where the program's parameters and statistics are
  still the seed's and the reference's are equal to them
  (``first_forward_rel_err``); the first checked update's loss alone
  (``first_loss_gap``: both sides start that update from the seed's
  parameters; ``loss_gap``, over all three, also holds how far the two
  PPO trajectories have parted); then the frozen PPO and rollout of
  ``train.Driver.check`` with the plain reference
  (``reference/impala_cnn.py``) in place of the frozen pooled policy:
  its initial parameters drawn as the program draws them, the frame and
  the previous action and reward passed through the normalizer, and the
  chunk-start values denormalized with the reference's return statistics
  (the plain critic learns EMA-normalized returns; the rollout's buffer
  holds them denormalized).
- The faults (``control.py --fault``): ``symmetric_pool``, the program's
  max pool padded on both sides as PyTorch's ``padding=1`` pads;
  ``stale_frame``, the policy fed the previous step's frame.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.drivers import common, train

FRAME = "rgbd"
PASS_THROUGH = (FRAME, "prev_action", "prev_reward")
# Frames against the plain renderer: colours equal; depth within the
# simulator cell's K5 bar (compare.DEPTH_TOL: 1e-3 absolute, 1e-4
# relative), taken on depth in world units (the frame holds depth / 200).
DEPTH_ABS, DEPTH_REL = 1e-3, 1e-4


def plant(fault) -> None:
    if fault == "symmetric_pool":
        import torch.nn.functional as F

        from marl_hideandseek_torch.models import layers

        layers.max_pool_same = lambda x: F.max_pool2d(x, 3, 2, padding=1)
    elif fault == "stale_frame":
        from marl_hideandseek_torch.env.packed import PackedEnv

        orig = PackedEnv._render_frames

        def stale(self, ps):
            prev = self.__dict__.get("_stale")
            now = orig(self, ps)
            self._stale = now.clone()
            return now if prev is None else prev
        PackedEnv._render_frames = stale


def with_frames(pkg_env_config):
    """``common.env_config`` with the program's frames switched on."""
    def env_config(pkg, env, flags, num_worlds, seed):
        cfg = pkg_env_config(pkg, env, flags, num_worlds, seed)
        if pkg == common.PROGRAM:
            cfg = cfg.replace(render_frames=bool(env["render_frames"]))
        return cfg
    return env_config


def draw_reference(ref, keys, device, buckets, lstm):
    """The reference's parameters for the policy keys ``keys [P, 2]``, as
    the program draws them (``models/layers.py``): each from flax's key
    for its module path and its index in the module; a convolution's
    orthogonal matrix over its ``[C_in x 3 x 3, C_out]`` fan-in, stored
    ``[C_out, C_in, 3, 3]``."""
    from portbench.reference.frozen.models import layers as fl

    out, seen = {}, {}
    p = keys.shape[0]
    for name, (shape, in_dims, init) in ref.params(buckets, lstm).items():
        path, _ = name.rsplit(".", 1)
        i = seen[path] = seen.get(path, -1) + 1
        k = fl.param_key(keys, path.split("."), i)
        if init == "zeros":
            v = fl.zeros(k, shape)
        elif init == "ones":
            v = fl.ones(k, shape)
        elif init[0] == "conv_orthogonal":
            n_in = math.prod(shape[1:])
            v = fl.orthogonal(init[1])(k, (n_in, shape[0]))
            v = v.transpose(1, 2).reshape(p, *shape)
        else:
            n_in = math.prod(shape[:in_dims])
            v = fl.orthogonal(init[1])(k, (n_in, math.prod(shape) // n_in))
            v = v.reshape(p, *shape)
        out[name] = v.contiguous().to(device)
    return out


def reference_frames(rgb: torch.Tensor, depth: torch.Tensor,
                     max_depth: float) -> torch.Tensor:
    """The frozen renderer's images (rgb ``[W, A, H, W, 4]`` u8, depth
    ``[W, A, H, W, 1]``) as frames ``[W, A, 4, H, W]``: colour / 255 and
    depth / max_depth."""
    chans = torch.cat([rgb[..., :3].to(torch.float64) / 255.0,
                       depth.to(torch.float64) / max_depth], -1)
    return chans.to(torch.float32).permute(0, 1, 4, 2, 3)


def frame_numbers(records: list, env_cfg, render: dict,
                  control: bool) -> dict:
    """The frames the policy got at each probed step (the probed worlds'
    ``rgbd`` observation) against the frozen plain renderer on the
    state after the step: the share of pixels whose colour differs or
    whose depth is out of tolerance."""
    from portbench.reference.compare import bf16_round, frozen_state
    from portbench.reference.frozen.viz import rgbd as plain

    fn = bf16_round if control else (lambda x: x)
    h, w, md = render["height"], render["width"], render["max_depth"]
    bad = n = 0
    for r in records:
        got = r["obs"][FRAME].float()
        rgb, depth = plain.render_rgbd_packed(
            env_cfg, frozen_state(r["post"], fn=fn), h, w,
            render["fov_deg"], md)
        want = reference_frames(rgb, depth, md)
        colour = (got[:, :, :3] == want[:, :, :3]).all(2)
        d_got, d_want = got[:, :, 3] * md, want[:, :, 3] * md
        near = (d_got - d_want).abs() <= DEPTH_ABS + DEPTH_REL * d_want.abs()
        ok = colour & near
        bad += int((~ok).sum())
        n += ok.numel()
    return {"frame_pixel_miss": bad / max(n, 1)}


class Driver(train.Driver):
    def first_forward(self) -> float:
        """``train_check``'s chunk-start forward on the first checked
        update alone: the reference with the parameters drawn from the
        seed and the initial normalizer statistics (the plain critic's
        value statistics are still the identity), against the buffer's
        values and log-probabilities of the probed agents. Later updates'
        forwards (``forward_rel_err``) also hold how far the two PPO
        trajectories have parted."""
        from portbench.reference.compare import rel_err
        from portbench.reference.frozen import prng
        from portbench.reference.frozen.models import (
            DiscreteActionDistributions,
        )
        from portbench.reference.frozen.models.actor_critic import tree_map
        from portbench.reference.frozen.models.layers import draw_params
        from portbench.reference.frozen.train import rollout

        run, conf, dev = self.run, self.run.conf, self.run.device
        (common.tf32_on if run.control else common.float32_exact)()
        cfg = common.train_config(common.FROZEN, conf, self.w, run.seed)
        policy = common.make_policy(common.FROZEN, conf, 1, dev)
        n_train = cfg.num_train_policies
        n_past = cfg.total_policies - n_train
        k_param = prng.split(prng.key(cfg.seed, dev), 5)[1]
        params = draw_params(policy.actor_critic,
                             prng.split(k_param.cpu(), n_train), dev)
        all_params = {k: torch.cat([v, v[:1].expand(n_past, *v.shape[1:])])
                      for k, v in params.items()}
        u = self.rec["updates"][0]
        buf, agents = u["buffer"], u["agents"]
        buckets = tuple(conf["policy"]["action_buckets"])
        norm = policy.obs_preprocess
        err = 0.0
        with torch.no_grad():
            for ci in range(buf["log_probs"].shape[0]):
                def at(x):
                    return x[ci, 0][agents].to(dev)
                obs = {k: at(v) for k, v in buf["obs"].items()}
                stats = norm.init_state(obs)
                rnn = tree_map(lambda x: x[ci][:, agents].to(dev),
                               buf["rnn_start_states"])
                lg, val, _ = rollout.apply_ensemble(
                    policy, all_params, rnn, norm.normalize(stats, obs),
                    at(buf["assignments"]), cfg.total_policies,
                    num_train=n_train)
                lp = DiscreteActionDistributions(buckets, lg).log_prob(
                    at(buf["actions"]))
                err = max(err, rel_err(at(buf["values"]), val),
                          rel_err(at(buf["log_probs"]), lp))
        common.float32_exact()
        return err

    def setup(self) -> None:
        plant(self.run.fault)
        orig = common.env_config
        common.env_config = with_frames(orig)
        try:
            super().setup()
        finally:
            common.env_config = orig

    def net(self):
        return self.mgr.policy.actor_critic.backbone.encoder.net

    def profile_segment(self, out: dict) -> None:
        from marl_hideandseek_torch.ops import rgbd

        before = (rgbd.RGBD_FRAMES.launches, self.net().torso_frames)
        super().profile_segment(out)
        n = self.mix["trace_updates"]
        # One launch of K5's frames mode renders every agent of every world.
        self.traced = {
            "frames_rendered": (rgbd.RGBD_FRAMES.launches - before[0]) *
            self.n_agents / n,
            "torso_frames": (self.net().torso_frames - before[1]) / n}

    def layer_values(self) -> dict:
        from portbench.counts import impala_cnn as counts
        from portbench.counts import peaks

        pol = self.run.conf["policy"]
        cfg = self.cfg
        steps, epochs = cfg.steps_per_update, cfg.algo.num_epochs
        n_train = cfg.num_train_policies
        assign = self.mgr.state.rollout.assignments
        n_tr = float((assign < n_train).sum())
        roll = (steps + 1) * counts.forward_flops(pol, self.n_agents)
        ppo = counts.ppo_flops(pol, n_tr * steps, epochs)
        # The frames in one update's model.torso spans, each agent once
        # through its own policy: every rollout forward's agents, and each
        # epoch's loss forward over the trained agents' steps; one call of
        # every policy a forward, of the train policies an epoch.
        frames = (steps + 1) * self.n_agents + epochs * n_tr * steps
        calls = (steps + 1) * cfg.total_policies + epochs * n_train
        flops, n_bytes = counts.torso_work(pol, frames, calls)
        vals = {"update_flops": roll + ppo,
                "window_flops": (roll + ppo) * self.updates,
                "torso_least_s": peaks.least_seconds(n_bytes, flops),
                "torso_flops": flops, "torso_bytes": n_bytes}
        last = self.env._frames
        if last is not None:
            md = self.run.conf["render"]["max_depth"]
            ps = self.mgr.state.rollout.env_state
            vals["k5_frames_least_s"] = peaks.least_seconds(
                counts.k5_frames_bytes(ps, last),
                counts.k5_frames_least_ops(last, md))
        return vals

    def counters(self) -> dict:
        from marl_hideandseek_torch.ops import rgbd

        out = super().counters()
        out["launches"]["rgbd_frames"] = rgbd.RGBD_FRAMES.launches
        out["launches"]["rgbd"] = rgbd.RGBD.launches
        out.update(getattr(self, "traced", {}))
        return out

    def check(self) -> dict:
        from portbench.reference import impala_cnn as ref
        from portbench.reference.frozen import policy as fpolicy
        from portbench.reference.frozen.models import Policy
        from portbench.reference.frozen.models import layers as flayers
        from portbench.reference.frozen.train import ppo as fppo
        from portbench.reference.frozen.train import rollout as frollout

        conf = self.run.conf
        fcfg = common.env_config(common.FROZEN, conf["env"],
                                 conf["env"]["train_flags"], self.w,
                                 self.run.seed)
        nums = frame_numbers(self.env_records, fcfg, conf["render"],
                             self.run.control)
        orig = (fpolicy.make_policy, flayers.draw_params, fppo.ppo_update,
                frollout.apply_ensemble)
        tcfg = common.train_config(common.FROZEN, conf, self.w, self.run.seed)
        stats = {}

        def make_policy(dtype, action_buckets, backbone, num_rnn_channels,
                        num_policies, device):
            base = orig[0](dtype=dtype, device=device).obs_preprocess
            norm = dataclasses.replace(
                base, skip_normalization=base.skip_normalization |
                frozenset(PASS_THROUGH))
            return Policy(
                actor_critic=ref.ActorCritic(num_policies, device,
                                             action_buckets,
                                             num_rnn_channels),
                obs_preprocess=norm)

        def draw_params(module, keys, device=None):
            if not isinstance(module, ref.ActorCritic):
                return orig[1](module, keys, device)
            return draw_reference(ref, keys, device, module.buckets,
                                  module.leaf("critic.Dense_0.kernel")
                                  .shape[1])

        def ppo_update(*args, **kwargs):
            out = orig[2](*args, **kwargs)
            stats["value"] = out[2]
            if "first_loss_gap" not in nums:
                got = self.rec["updates"][0]["loss"]
                want = out[3]["loss"].cpu()
                nums["first_loss_gap"] = float(
                    ((got - want).abs() / want.abs().clamp(min=1.0)).max())
            return out

        def apply_ensemble(policy, all_params, rnn, obs, assignments, *args,
                           **kwargs):
            lg, val, new = orig[3](policy, all_params, rnn, obs, assignments,
                                   *args, **kwargs)
            if "value" in stats:
                val = frollout.denormalize_values(tcfg, stats["value"], val,
                                                  assignments)
            return lg, val, new

        fpolicy.make_policy, flayers.draw_params = make_policy, draw_params
        fppo.ppo_update, frollout.apply_ensemble = ppo_update, apply_ensemble
        try:
            if self.rec["updates"]:
                nums["first_forward_rel_err"] = self.first_forward()
            nums.update(super().check())
        finally:
            (fpolicy.make_policy, flayers.draw_params, fppo.ppo_update,
             frollout.apply_ensemble) = orig
        return nums

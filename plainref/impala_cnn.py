"""Plain reference of the ``impala_cnn`` policy: the deep network of
Espeholt et al., *IMPALA: Scalable Distributed Deep-RL with Importance
Weighted Actor-Learner Architectures* (ICML 2018, arXiv:1802.01561,
Figure 3, right; the code's ``experiment.py``, ``Agent._torso``), on each
agent's rendered 64x64 RGBD frame, as the port's ``policy.ImpalaCnnNet``
computes it.

Torch alone, float32, TF32 off for matrix products and cuDNN (set when
this module is imported). Convolutions are ``F.conv2d`` with padding 1;
the SAME max pool is written as TensorFlow defines it: one row and one
column of -inf padded at the end (``F.pad``), then ``F.max_pool2d`` of
3 x 3 windows with stride 2 and no padding. The LSTM is written out in
its equations, one step at a time, one policy at a time.

The parameters are the program's, by name (``PARAMS``): a flat dict of
``[P, ...]`` tensors with the names of the program's
``ActorCritic.named_parameters()``, held by ``ActorCritic`` under the same
names so that ``torch.func.functional_call`` can swap them in. Inputs and
outputs follow the program's ``ActorCritic`` (``forward``, ``act``,
``sequence``) with one encoder shared by both heads: the observations as
normalized for the policy (the frame, the previous action and reward
pass the normalizer unchanged).

One agent, one policy, frame ``x`` ``[4, 64, 64]`` (RGB / 255, depth /
200):

- three sections of (16, 2), (32, 2), (32, 2) channels and residual
  blocks, each ``x = pool(conv(x))``, then per block ``x = x +
  conv(relu(conv(relu(x))))``; every conv 3 x 3, stride 1, padding 1,
  with a bias;
- ``t = relu(Dense_256(flatten(relu(x))))``, flattened channel-major
  (32 x 8 x 8 = 2,048);
- the core input ``[t, prev_reward, prev_action, prep_counter,
  self_data, self_type, self_lidar]``: 256 + 1 + 19 + 45 = 321;
- LSTM 256 (gates i, f, g, o; forget bias +1; no hidden bias), then
  LayerNorm with eps 1e-6 and the variance E[x^2] - E[x]^2 (flax's);
- the policy's logits over (5, 5, 5, 2, 2) and one value, both Dense
  from that.

The BPTT replay (``sequence``) clears the state after every step at an
episode's end. The torso has no state: it runs once over every step's
frames of a policy, under ``torch.utils.checkpoint`` where gradients are
taken (its activations recomputed in the backward rather than kept,
which changes no number and keeps a replay of tens of thousands of
frames within one card). Rendered frames hold flat regions, where a max
pool's window holds equal values in exact arithmetic and rounding picks
the one that gets the gradient; one batch of all the steps puts the
same shapes, so the same cuDNN algorithms and the same rounding, in
front of the pools as a batched program does.

Departures from Espeholt et al. and their code (the configuration's
``assumed``): a fourth input channel, depth / 200 (IMPALA reads RGB /
255); the instruction LSTM's slot holds the agent's own 45-feature
observation, EMA-normalized where the normalizer normalizes it; one
one-hot a bucket of the previous action (5 + 5 + 5 + 2 + 2) in place of
one over a single discrete action; multi-bucket policy heads; LayerNorm
after the LSTM (the port's recurrent encoder) and a forget-gate bias of
+1; the flattening is channel-major (PyTorch's layout; TensorFlow's is
channel-last); the port's initialisers (orthogonal, drawn as flax would:
sqrt 2 for the convolutions, over the ``[C_in x 3 x 3, C_out]`` fan-in
matrix, and the torso's Dense; 1 for the LSTM and the value; 0.01 for
the logits; zero biases, unit scales); PPO in place of V-trace.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SECTIONS = ((16, 2), (32, 2), (32, 2))
FRAME = "rgbd"
CHANNELS = 4
TORSO = 256
SELF_KEYS = ("prep_counter", "self_data", "self_type", "self_lidar")
SELF_FEATURES = 1 + 13 + 1 + 30
BUCKETS = (5, 5, 5, 2, 2)
SQRT2 = 2.0 ** 0.5


def _conv(name: str, c_in: int, c_out: int) -> dict:
    return {f"{name}.kernel": ((c_out, c_in, 3, 3), -3,
                               ("conv_orthogonal", SQRT2)),
            f"{name}.bias": ((c_out,), 0, "zeros")}


def params(buckets=BUCKETS, lstm: int = 256) -> dict:
    """The parameter tree: name -> (shape without the policy axis, the
    number of leading input dims, the initialiser the program draws it
    with: ``("orthogonal", scale)`` over ``[inputs, outputs]``,
    ``("conv_orthogonal", scale)`` over a kernel's ``[C_in x 3 x 3,
    C_out]`` fan-in matrix (its input dims the last three, marked -3),
    "zeros" or "ones")."""
    net = "backbone.encoder.net"
    out, c_in = {}, CHANNELS
    for i, (ch, blocks) in enumerate(SECTIONS):
        sec = f"{net}.ConvSection_{i}"
        out.update(_conv(f"{sec}.Conv2d_0", c_in, ch))
        for b in range(blocks):
            for k in range(2):
                out.update(_conv(f"{sec}.ConvResidualBlock_{b}.Conv2d_{k}",
                                 ch, ch))
        c_in = ch
    out[f"{net}.Dense_0.kernel"] = ((c_in * 8 * 8, TORSO), 1,
                                    ("orthogonal", SQRT2))
    out[f"{net}.Dense_0.bias"] = ((TORSO,), 0, "zeros")
    core = TORSO + 1 + sum(buckets) + SELF_FEATURES
    rnn = "backbone.encoder.rnn"
    out[f"{rnn}.layer_0_ih.kernel"] = ((core, 4 * lstm), 1,
                                       ("orthogonal", 1.0))
    out[f"{rnn}.layer_0_ih.bias"] = ((4 * lstm,), 0, "zeros")
    out[f"{rnn}.layer_0_hh.kernel"] = ((lstm, 4 * lstm), 1,
                                       ("orthogonal", 1.0))
    out["backbone.encoder.rnn_norm.scale"] = ((lstm,), 0, "ones")
    out["backbone.encoder.rnn_norm.bias"] = ((lstm,), 0, "zeros")
    out["actor.Dense_0.kernel"] = ((lstm, sum(buckets)), 1,
                                   ("orthogonal", 0.01))
    out["actor.Dense_0.bias"] = ((sum(buckets),), 0, "zeros")
    out["critic.Dense_0.kernel"] = ((lstm, 1), 1, ("orthogonal", 1.0))
    out["critic.Dense_0.bias"] = ((1,), 0, "zeros")
    return out


PARAMS = params()


# -- plain functions ------------------------------------------------------------

def flax_layer_norm(x, scale, bias, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (1.0 / torch.sqrt(var + eps) * scale) + bias


def dense(x, kernel, bias):
    return x @ kernel + bias


def conv3x3(x, kernel, bias):
    """3 x 3, stride 1, SAME (one zero row and column on every side)."""
    return F.conv2d(x, kernel, bias, stride=1, padding=1)


def pool_same(x):
    """TensorFlow's SAME 3 x 3 max pool, stride 2, on an even size: out
    ``n / 2``; padding ``max((n/2 - 1) * 2 + 3 - n, 0) = 1``, of which
    ``1 // 2 = 0`` before and 1 after, filled with -inf."""
    x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=0)


def torso(w, frames):
    """The torso for one policy: ``w(name)`` its parameter (``net.``
    names), frames ``[R, 4, 64, 64]`` -> ``[R, 256]``."""
    x = frames
    for i, (_, blocks) in enumerate(SECTIONS):
        sec = f"ConvSection_{i}"
        x = pool_same(conv3x3(x, w(f"{sec}.Conv2d_0.kernel"),
                              w(f"{sec}.Conv2d_0.bias")))
        for b in range(blocks):
            blk = f"{sec}.ConvResidualBlock_{b}"
            y = conv3x3(torch.relu(x), w(f"{blk}.Conv2d_0.kernel"),
                        w(f"{blk}.Conv2d_0.bias"))
            y = conv3x3(torch.relu(y), w(f"{blk}.Conv2d_1.kernel"),
                        w(f"{blk}.Conv2d_1.bias"))
            x = x + y
    x = torch.relu(x).reshape(x.shape[0], -1)
    return torch.relu(dense(x, w("Dense_0.kernel"), w("Dense_0.bias")))


def core_input(t, obs):
    """The torso's output joined to the previous reward and action and
    the agent's own observation, rows ``[R, ..]``."""
    return torch.cat([t, obs["prev_reward"], obs["prev_action"]] +
                     [obs[k] for k in SELF_KEYS], -1)


def lstm_step(w, h, c, x):
    gates = (dense(x, w("rnn.layer_0_ih.kernel"), w("rnn.layer_0_ih.bias")) +
             h @ w("rnn.layer_0_hh.kernel"))
    n = h.shape[-1]
    i = torch.sigmoid(gates[:, :n])
    f = torch.sigmoid(gates[:, n:2 * n] + 1.0)
    g = torch.tanh(gates[:, 2 * n:3 * n])
    o = torch.sigmoid(gates[:, 3 * n:])
    c = f * c + i * g
    return o * torch.tanh(c), c


class Dists:
    """Factored categorical over ``buckets`` of ``logits [.., sum]``."""

    def __init__(self, buckets, logits):
        self.buckets, self.logits = tuple(buckets), logits

    def _log_softmax(self):
        out, lo = [], 0
        for b in self.buckets:
            lg = self.logits[..., lo:lo + b]
            mx = lg.max(-1, keepdim=True).values
            z = torch.log(torch.exp(lg - mx).sum(-1, keepdim=True)) + mx
            out.append(lg - z)
            lo += b
        return out

    def log_prob(self, actions):
        total = 0.0
        for i, lp in enumerate(self._log_softmax()):
            a = actions[..., i:i + 1].long()
            total = total + torch.gather(lp, -1, a)[..., 0]
        return total

    def entropy(self):
        total = 0.0
        for lp in self._log_softmax():
            total = total - (torch.exp(lp) * lp).sum(-1)
        return total


# -- the actor-critic -----------------------------------------------------------

class ActorCritic(nn.Module):
    """The program's ``ActorCritic`` of the ``impala_cnn`` policy, plain:
    ``num_policies`` policies, parameters ``[P, ...]`` under the names of
    ``params()``; the recurrent state ``((h, c),)``, one encoder's."""

    def __init__(self, num_policies: int, device=None, buckets=BUCKETS,
                 lstm: int = 256):
        super().__init__()
        self.buckets = tuple(buckets)
        for name, (shape, _, _) in params(buckets, lstm).items():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(torch.zeros(
                (num_policies, *shape), device=device)))

    def leaf(self, name: str) -> torch.Tensor:
        mod = self
        for part in name.split("."):
            mod = getattr(mod, part)
        return mod

    def _weights(self, p: int):
        return lambda name: self.leaf(f"backbone.encoder.{name}")[p]

    def _torso(self, p: int, frames):
        w = self._weights(p)
        names = [n for n in PARAMS if n.startswith("backbone.encoder.net.")]
        leaves = [w(n[len("backbone.encoder."):]) for n in names]

        def run(x, *vals):
            table = dict(zip(names, vals))
            return torso(lambda n: table["backbone.encoder.net." + n], x)

        if torch.is_grad_enabled():
            return checkpoint(run, frames, *leaves, use_reentrant=False)
        return run(frames, *leaves)

    def _features(self, p, obs, h, c, ends=None):
        """The encoder of one policy over obs ``[T, N, ..]`` (or ``[N,
        ..]``) from state ``(h, c)`` ``[N, C]``: the normalized LSTM
        outputs ``[T, N, C]`` and the state after the last step (cleared
        after each step where ``ends [T, N]``)."""
        w = self._weights(p)
        if obs[FRAME].dim() == 4:
            obs = {k: v[None] for k, v in obs.items()}
        frames = obs[FRAME]
        feats = self._torso(p, frames.reshape(-1, *frames.shape[2:]))
        feats = feats.reshape(*frames.shape[:2], -1)
        outs = []
        for t in range(frames.shape[0]):
            step = {k: v[t] for k, v in obs.items()}
            x = core_input(feats[t], step)
            h, c = lstm_step(w, h, c, x)
            outs.append(flax_layer_norm(h, w("rnn_norm.scale"),
                                        w("rnn_norm.bias")))
            if ends is not None:
                keep = 1.0 - ends[t].to(torch.float32)[:, None]
                h, c = h * keep, c * keep
        return torch.stack(outs), (h, c)

    def _heads(self, p, feat, critic: bool = True):
        lg = dense(feat, self.leaf("actor.Dense_0.kernel")[p],
                   self.leaf("actor.Dense_0.bias")[p])
        val = None
        if critic:
            val = dense(feat, self.leaf("critic.Dense_0.kernel")[p],
                        self.leaf("critic.Dense_0.bias")[p])
        return lg, val

    def _num_policies(self):
        return self.leaf("actor.Dense_0.bias").shape[0]

    def init_recurrent_state(self, n, device=None):
        z = torch.zeros((1, n, self.leaf("backbone.encoder.rnn_norm.scale")
                         .shape[-1]), device=device)
        return ((z, z.clone()),)

    def clear_recurrent_state(self, states, should_clear):
        keep = 1.0 - should_clear.reshape(-1, 1).to(torch.float32)
        return tuple((h * keep, c * keep) for h, c in states)

    def _step(self, rnn_states, obs, critic: bool):
        logits, values, st = [], [], []
        ((h, c),) = rnn_states
        for p in range(self._num_policies()):
            f, s = self._features(p, obs, h[0], c[0])
            lg, val = self._heads(p, f[0], critic)
            logits.append(lg)
            values.append(val)
            st.append(s)
        new = ((torch.stack([s[0] for s in st])[:, None],
                torch.stack([s[1] for s in st])[:, None]),)
        return Dists(self.buckets, torch.stack(logits)), values, new

    def forward(self, rnn_states, obs, train: bool = False):
        """One step of every policy on the same agents: (dists ``[P, N,
        ..]``, ``{"value": [P, N, 1]}``, states ``[P, 1, N, C]``)."""
        dists, values, new = self._step(rnn_states, obs, True)
        return dists, {"value": torch.stack(values)}, new

    def act(self, rnn_states, obs, train: bool = False):
        """The actor alone (the shared encoder's full step)."""
        dists, _, new = self._step(rnn_states, obs, False)
        return dists, new

    def sequence(self, start_states, seq_ends, seq_obs, train: bool = True,
                 per_policy: bool = False):
        """BPTT replay over ``[T, N, ..]`` sequences (``[P, T, N, ..]``
        with ``per_policy``): (dists ``[P, T, N, ..]``, ``{"value": [P, T,
        N, 1]}``)."""
        logits, values = [], []
        for p in range(self._num_policies()):
            def mine(x):
                return x[p] if per_policy else x
            obs = {k: mine(v) for k, v in seq_obs.items()}
            ((h, c),) = [tuple(mine(x) for x in s) for s in start_states]
            f, _ = self._features(p, obs, h[0], c[0], mine(seq_ends))
            lg, val = self._heads(p, f)
            logits.append(lg)
            values.append(val)
        return (Dists(self.buckets, torch.stack(logits)),
                {"value": torch.stack(values)})

"""Plain reference of the ``openai_hns`` policy: the hide-and-seek policy of
Baker et al., *Emergent Tool Use From Multi-Agent Autocurricula* (ICLR
2020, arXiv:1909.07528, appendix B; the code's ``ma_policy/layers.py``:
``circ_conv1d``, ``residual_sa_block``, ``self_attention``, masked entity
pooling), as the port's ``policy.OpenAIHnsNet`` computes it.

Torch alone, float32, TF32 off for matrix products and cuDNN (set when
this module is imported). Every loop is written out: the lidar
convolution over positions and taps, the attention over heads, queries
and keys, the LSTM over time, one policy at a time; the rows of a batch
(agents, time steps) are the only thing computed together. Dense layers
are ``x @ W + b``.

The parameters are the program's, by name (``PARAMS``): a flat dict of
``[P, ...]`` tensors with the names of the program's
``ActorCritic.named_parameters()``, held by ``ActorCritic`` under the same
names so that ``torch.func.functional_call`` can swap them in. Inputs and
outputs follow the program's ``ActorCritic`` (``forward``, ``act``,
``sequence``): the observations as normalized for the policy, with the
packed env's flat entity layout.

One agent, one policy (``LN`` eps 1e-5 with the exact variance):

- self token: ``c[i, f] = ReLU(b_f + sum_t w[t, f] lidar[(i + t - 1) mod
  30])``, ``x_0 = ReLU([prep, self_data, self_type, c (position-major)]
  W + b)``, 285 -> 128;
- ``x_j = ReLU(e_j W_type + b_type)`` for 5 agents (14 features), 9
  boxes (17) and 2 ramps (14);
- key mask ``m``: ``m_0 = 1``; actor ``m_j = vis_j``; critic ``m_j = 1``
  where ``e_j`` is not all zero (the slot holds an entity);
- ``y = LN_0(x)``, per head ``q, k, v = y W + b`` (4 heads of 32),
  ``a_ij = q_i . k_j / sqrt(32)`` where ``m_j``, else -inf, ``p =
  softmax_j a``, ``o_i = sum_j p_ij v_j``; ``x'_i = LN_1(x_i + o_i W_o +
  b_o)``;
- ``g = sum_i m_i x'_i / sum_i m_i``; ``h = LN(ReLU(g W_d + b_d))``, 256;
- LSTM 256 (gates i, f, g, o; forget bias +1; no hidden bias), then
  LayerNorm with eps 1e-6 and the variance E[x^2] - E[x]^2 (flax's);
- actor logits over (11, 11, 11, 2, 2); critic one value.

Departures from the paper and its code (the configuration's
``assumed``): LayerNorm before the products and after the residual; no
MLP after the attention (the code's ``n_mlp`` 1); each entity embedded
from its own features only (the code also joins the agent's own); the
port's initialisers (orthogonal, drawn as flax would) in place of the
code's; the critic's entities are the slots that hold one (the code
reads a separate observation of which entities exist; the env here zeroes
an empty slot's features instead, and the normalizer keeps such rows
zero, ``EntityRowNormalizer``); the prep counter, self data and type as
the env's observations give them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NUM_LIDAR = 30
NUM_FILTERS = 9
WIDTH = 3
EMBED = 128
HEADS = 4
HEAD_DIM = EMBED // HEADS
OUT = 256
# (entity type, data key, visibility key, features per entity)
ENTITIES = (("agents", "agent_data", "vis_agents_mask", 14),
            ("boxes", "box_data", "vis_boxes_mask", 17),
            ("ramps", "ramp_data", "vis_ramps_mask", 14))
SELF_IN = 1 + 13 + 1 + NUM_FILTERS * NUM_LIDAR
BUCKETS = (11, 11, 11, 2, 2)
SQRT2 = 2.0 ** 0.5


def _encoder_params(prefix: str, lstm: int) -> dict:
    """name -> (shape, input dims, initialiser) of one encoder, in the
    order the program creates them (a kernel before its bias)."""
    net = prefix + ".net"
    out = {
        f"{net}.lidar_conv.kernel": ((WIDTH, 1, NUM_FILTERS), 2,
                                     ("orthogonal", SQRT2)),
        f"{net}.lidar_conv.bias": ((NUM_FILTERS,), 0, "zeros"),
        f"{net}.embed_self.kernel": ((SELF_IN, EMBED), 1,
                                     ("orthogonal", SQRT2)),
        f"{net}.embed_self.bias": ((EMBED,), 0, "zeros"),
    }
    for name, _, _, f in ENTITIES:
        out[f"{net}.embed_{name}.kernel"] = ((f, EMBED), 1,
                                             ("orthogonal", SQRT2))
        out[f"{net}.embed_{name}.bias"] = ((EMBED,), 0, "zeros")
    attn = f"{net}.attn"
    out[f"{attn}.LayerNorm_0.scale"] = ((EMBED,), 0, "ones")
    out[f"{attn}.LayerNorm_0.bias"] = ((EMBED,), 0, "zeros")
    for w in ("query", "key", "value"):
        out[f"{attn}.SelfAttention_0.{w}.kernel"] = (
            (EMBED, HEADS, HEAD_DIM), 1, ("orthogonal", 1.0))
        out[f"{attn}.SelfAttention_0.{w}.bias"] = ((HEADS, HEAD_DIM), 0,
                                                   "zeros")
    out[f"{attn}.SelfAttention_0.out.kernel"] = ((HEADS, HEAD_DIM, EMBED), 2,
                                                 ("orthogonal", 1.0))
    out[f"{attn}.SelfAttention_0.out.bias"] = ((EMBED,), 0, "zeros")
    out[f"{attn}.LayerNorm_1.scale"] = ((EMBED,), 0, "ones")
    out[f"{attn}.LayerNorm_1.bias"] = ((EMBED,), 0, "zeros")
    out[f"{net}.Dense_0.kernel"] = ((EMBED, OUT), 1, ("orthogonal", SQRT2))
    out[f"{net}.Dense_0.bias"] = ((OUT,), 0, "zeros")
    out[f"{net}.LayerNorm_0.scale"] = ((OUT,), 0, "ones")
    out[f"{net}.LayerNorm_0.bias"] = ((OUT,), 0, "zeros")
    rnn = prefix + ".rnn"
    out[f"{rnn}.layer_0_ih.kernel"] = ((OUT, 4 * lstm), 1, ("orthogonal", 1.0))
    out[f"{rnn}.layer_0_ih.bias"] = ((4 * lstm,), 0, "zeros")
    out[f"{rnn}.layer_0_hh.kernel"] = ((lstm, 4 * lstm), 1,
                                       ("orthogonal", 1.0))
    out[f"{prefix}.rnn_norm.scale"] = ((lstm,), 0, "ones")
    out[f"{prefix}.rnn_norm.bias"] = ((lstm,), 0, "zeros")
    return out


def params(buckets=BUCKETS, lstm: int = OUT) -> dict:
    """The parameter tree: name -> (shape without the policy axis, the
    number of leading input dims, the initialiser the program draws it
    with: ``("orthogonal", scale)`` over ``[inputs, outputs]``, "zeros" or
    "ones")."""
    out = {}
    out.update(_encoder_params("backbone.actor_encoder", lstm))
    out.update(_encoder_params("backbone.critic_encoder", lstm))
    out["actor.Dense_0.kernel"] = ((lstm, sum(buckets)), 1,
                                   ("orthogonal", 0.01))
    out["actor.Dense_0.bias"] = ((sum(buckets),), 0, "zeros")
    out["critic.Dense_0.kernel"] = ((lstm, 1), 1, ("orthogonal", 1.0))
    out["critic.Dense_0.bias"] = ((1,), 0, "zeros")
    return out


PARAMS = params()


# -- plain functions ------------------------------------------------------------

def layer_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def flax_layer_norm(x, scale, bias, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (1.0 / torch.sqrt(var + eps) * scale) + bias


def dense(x, kernel, bias, in_dims: int = 1):
    """``x @ W + b``, the kernel's first ``in_dims`` axes its inputs."""
    n_in = math.prod(kernel.shape[:in_dims])
    return x @ kernel.reshape(n_in, -1) + bias.reshape(-1)


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


class EntityRowNormalizer:
    """A normalizer (``init_state``, ``update_state``, ``normalize``,
    ``prep``) whose ``normalize`` leaves an entity row that is all zero
    before normalization (an empty slot) all zero, as the program's
    ``ObservationsEMANormalizer(entity_rows=...)`` does."""

    def __init__(self, base):
        self.base = base

    def prep(self, obs):
        return self.base.prep(obs)

    def init_state(self, obs):
        return self.base.init_state(obs)

    def update_state(self, state, obs, *args):
        return self.base.update_state(state, obs, *args)

    def normalize(self, state, obs):
        out = self.base.normalize(state, obs)
        for _, data, _, f in ENTITIES:
            raw = obs[data]
            rows = raw.reshape(*raw.shape[:-1], -1, f)
            filled = (rows != 0).any(-1, keepdim=True)
            out[data] = (out[data].reshape(rows.shape) * filled).reshape(
                raw.shape)
        return out


# -- the encoder ----------------------------------------------------------------

def encode(w, obs, view: str):
    """One encoder's net for one policy: ``w(name)`` its parameter
    (``net.`` names), obs leaves ``[R, F]``; returns ``[R, 256]``."""
    lidar = obs["self_lidar"]
    cols = []
    for i in range(NUM_LIDAR):
        acc = w("lidar_conv.bias")
        for t in range(WIDTH):
            x = lidar[:, (i + t - 1) % NUM_LIDAR, None]
            acc = acc + x * w("lidar_conv.kernel")[t, 0]
        cols.append(torch.relu(acc))                        # [R, 9]
    self_in = torch.cat([obs["prep_counter"], obs["self_data"],
                         obs["self_type"]] + cols, -1)
    tokens = [torch.relu(dense(self_in, w("embed_self.kernel"),
                               w("embed_self.bias")))]
    mask = [torch.ones_like(lidar[:, 0], dtype=torch.bool)]
    for name, data, vis, f in ENTITIES:
        rows = obs[data].reshape(obs[data].shape[0], -1, f)
        for j in range(rows.shape[1]):
            tokens.append(torch.relu(dense(rows[:, j], w(f"embed_{name}.kernel"),
                                           w(f"embed_{name}.bias"))))
            mask.append(obs[vis][:, j] != 0 if view == "actor"
                        else (rows[:, j] != 0).any(-1))

    def a(name):
        return w("attn." + name)

    ys = [layer_norm(x, a("LayerNorm_0.scale"), a("LayerNorm_0.bias"))
          for x in tokens]
    proj = {}
    for kind in ("query", "key", "value"):
        proj[kind] = [dense(y, a(f"SelfAttention_0.{kind}.kernel"),
                            a(f"SelfAttention_0.{kind}.bias")) for y in ys]
    scale = math.sqrt(HEAD_DIM)
    outs = []
    for i in range(len(tokens)):
        heads = []
        for h in range(HEADS):
            cut = slice(h * HEAD_DIM, (h + 1) * HEAD_DIM)
            q = proj["query"][i][:, cut] / scale
            scores = []
            for j in range(len(tokens)):
                s = (q * proj["key"][j][:, cut]).sum(-1)
                scores.append(torch.where(mask[j], s, float("-inf")))
            top = scores[0]
            for s in scores[1:]:
                top = torch.maximum(top, s)
            exps = [torch.exp(s - top) for s in scores]
            total = exps[0]
            for e in exps[1:]:
                total = total + e
            o = 0.0
            for j in range(len(tokens)):
                o = o + (exps[j] / total)[:, None] * proj["value"][j][:, cut]
            heads.append(o)
        o = dense(torch.cat(heads, -1), a("SelfAttention_0.out.kernel"),
                  a("SelfAttention_0.out.bias"), in_dims=2)
        outs.append(layer_norm(tokens[i] + o, a("LayerNorm_1.scale"),
                               a("LayerNorm_1.bias")))
    num, den = 0.0, 0.0
    for x, m in zip(outs, mask):
        m = m.to(x.dtype)[:, None]
        num, den = num + m * x, den + m
    g = num / den
    return layer_norm(torch.relu(dense(g, w("Dense_0.kernel"),
                                       w("Dense_0.bias"))),
                      w("LayerNorm_0.scale"), w("LayerNorm_0.bias"))


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


# -- the actor-critic -----------------------------------------------------------

class ActorCritic(nn.Module):
    """The program's ``ActorCritic`` of the ``openai_hns`` policy, plain:
    ``num_policies`` policies, parameters ``[P, ...]`` under the names of
    ``params()``."""

    def __init__(self, num_policies: int, device=None, buckets=BUCKETS,
                 lstm: int = OUT):
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

    def _weights(self, p: int, prefix: str):
        return lambda name: self.leaf(f"{prefix}.{name}")[p]

    def _features(self, p, prefix, view, obs, h, c, ends=None):
        """Encoder of one policy over obs ``[T, N, ..]`` (or ``[N, ..]``)
        from state ``(h, c)`` ``[N, C]``: the normalized LSTM outputs
        ``[T, N, C]`` and the state after each step (cleared where
        ``ends [T, N]``)."""
        w = self._weights(p, prefix)
        lead = obs["self_lidar"].shape[:-1]
        flat = {k: v.reshape(-1, v.shape[-1]) for k, v in obs.items()}
        x = encode(lambda n: w("net." + n), flat, view).reshape(*lead, -1)
        if x.dim() == 2:
            x = x[None]
        outs = []
        for t in range(x.shape[0]):
            h, c = lstm_step(w, h, c, x[t])
            outs.append(flax_layer_norm(h, w("rnn_norm.scale"),
                                        w("rnn_norm.bias")))
            if ends is not None:
                keep = 1.0 - ends[t].to(torch.float32)[:, None]
                h, c = h * keep, c * keep
        return torch.stack(outs), (h, c)

    def _heads(self, p, a_feat, c_feat):
        lg = dense(a_feat, self.leaf("actor.Dense_0.kernel")[p],
                   self.leaf("actor.Dense_0.bias")[p])
        val = None
        if c_feat is not None:
            val = dense(c_feat, self.leaf("critic.Dense_0.kernel")[p],
                        self.leaf("critic.Dense_0.bias")[p])
        return lg, val

    def _num_policies(self):
        return self.leaf("actor.Dense_0.bias").shape[0]

    def init_recurrent_state(self, n, device=None):
        z = torch.zeros((1, n, self.leaf("backbone.actor_encoder.rnn_norm"
                                         ".scale").shape[-1]), device=device)
        return ((z, z.clone()), (z.clone(), z.clone()))

    def clear_recurrent_state(self, states, should_clear):
        keep = 1.0 - should_clear.reshape(-1, 1).to(torch.float32)
        return tuple((h * keep, c * keep) for h, c in states)

    def forward(self, rnn_states, obs, train: bool = False):
        """One step of every policy on the same agents: (dists ``[P, N,
        ..]``, ``{"value": [P, N, 1]}``, states ``[P, 1, N, C]``)."""
        logits, values, a_st, c_st = [], [], [], []
        for p in range(self._num_policies()):
            (ah, ac), (ch, cc) = rnn_states
            a, a_s = self._features(p, "backbone.actor_encoder", "actor",
                                    obs, ah[0], ac[0])
            c, c_s = self._features(p, "backbone.critic_encoder", "critic",
                                    obs, ch[0], cc[0])
            lg, val = self._heads(p, a[0], c[0])
            logits.append(lg)
            values.append(val)
            a_st.append(a_s)
            c_st.append(c_s)
        return (Dists(self.buckets, torch.stack(logits)),
                {"value": torch.stack(values)},
                (tuple(torch.stack([s[k] for s in a_st])[:, None]
                       for k in range(2)),
                 tuple(torch.stack([s[k] for s in c_st])[:, None]
                       for k in range(2))))

    def act(self, rnn_states, obs, train: bool = False):
        """The actor alone; the critic's state passes through."""
        logits, a_st = [], []
        for p in range(self._num_policies()):
            (ah, ac), _ = rnn_states
            a, a_s = self._features(p, "backbone.actor_encoder", "actor",
                                    obs, ah[0], ac[0])
            logits.append(self._heads(p, a[0], None)[0])
            a_st.append(a_s)
        critic = tuple(x[None] for x in rnn_states[1])
        return (Dists(self.buckets, torch.stack(logits)),
                (tuple(torch.stack([s[k] for s in a_st])[:, None]
                       for k in range(2)), critic))

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
            ends = mine(seq_ends)
            (ah, ac), (ch, cc) = [tuple(mine(x) for x in s)
                                  for s in start_states]
            a, _ = self._features(p, "backbone.actor_encoder", "actor", obs,
                                  ah[0], ac[0], ends)
            c, _ = self._features(p, "backbone.critic_encoder", "critic",
                                  obs, ch[0], cc[0], ends)
            lg, val = self._heads(p, a, c)
            logits.append(lg)
            values.append(val)
        return (Dists(self.buckets, torch.stack(logits)),
                {"value": torch.stack(values)})

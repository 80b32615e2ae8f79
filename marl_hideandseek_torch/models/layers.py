"""Core layers: dense, LayerNorm, MLP, entity attention, actor/critic heads.

Port of ``marl_hideandseek_tpu/models/layers.py``. Every parameter is
stacked on a leading policy axis P - a dense kernel is ``[P, in, out]``
(flax's ``[in, out]`` layout per policy), its bias ``[P, out]`` - so one
module holds a whole ensemble and each layer runs as one batched product
over all P policies. Activations carry the same leading axis, of size P,
or of size 1 where every policy sees the same tensor (the observations
and recurrent state going in): a layer broadcasts that axis. Parameters
are float32; dense layers compute in the module's ``dtype`` (flax's
``Dense(dtype=...)`` casts both input and kernel), and LayerNorm
statistics are float32 whatever that dtype is.

Parameter names mirror the flax tree (``Dense_0.kernel``,
``LayerNorm_0.scale``, ``embed_boxes``, ...), so a flax checkpoint loads by
name (``bridge.policy_params_from_numpy``). Initialisers draw as flax's
do, from the keys flax derives (``param_key``): policy ``p``'s parameter
at module path ``a.b.c`` is drawn from ``fold_in(keys[p], h)``, ``h`` the
first four bytes of a SHA-1 of the path's names and the parameter's
index in its module (flax/core/scope.py, ``LazyRng``), with JAX's
threefry (``prng.py``): the same keys give flax's initial parameters, to
float32 rounding of the orthogonal initialiser's QR.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.utils import tracing

# init(keys [P, 2] u32, shape) -> [P, *shape] float32 on the keys' device:
# one slice per policy key.
Init = Callable[[torch.Tensor, Tuple[int, ...]], torch.Tensor]


def orthogonal(scale: float = 2.0 ** 0.5) -> Init:
    """jax.nn.initializers.orthogonal(scale), column axis last: the Q of
    a QR of a normal matrix, signs fixed by R's diagonal
    (``prng.orthogonal``)."""

    def init(keys: torch.Tensor, shape) -> torch.Tensor:
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        q = prng.orthogonal(keys, n_rows, n_cols)
        return torch.tensor(scale, dtype=torch.float32) * q.reshape(
            keys.shape[0], *shape)

    return init


def zeros(keys: torch.Tensor, shape) -> torch.Tensor:
    return torch.zeros((keys.shape[0], *shape), device=keys.device)


def ones(keys: torch.Tensor, shape) -> torch.Tensor:
    return torch.ones((keys.shape[0], *shape), device=keys.device)


def normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal."""
    return prng.normal(keys, shape)


def he_normal(keys: torch.Tensor, shape) -> torch.Tensor:
    """jax.nn.initializers.he_normal: a normal truncated at 2 standard
    deviations, variance 2 / fan_in (fan_in = the second-to-last axis
    times the receptive field)."""
    fan_in = math.prod(shape[:-1])
    var = torch.tensor(2.0 / fan_in, dtype=torch.float32)
    std = torch.sqrt(var) / torch.tensor(.87962566103423978,
                                         dtype=torch.float32)
    return prng.truncated_normal(keys, -2.0, 2.0, shape) * std


def param_key(keys: torch.Tensor, path: Sequence[str],
              index: int) -> torch.Tensor:
    """flax's key for the ``index``-th parameter (from 0) a module at
    ``path`` creates, for each policy key of ``keys [P, 2]``: the path's
    names and the parameter's count (from 1) folded in as the first four
    bytes of their SHA-1 (flax/core/scope.py:87-135, with
    ``flax_fix_rng_separator`` off, as flax sets it)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    count = index + 1
    m.update(count.to_bytes((count.bit_length() + 7) // 8, byteorder="big"))
    return prng.fold_in(keys, int.from_bytes(m.digest()[:4], "big"))


class Stacked(nn.Module):
    """A leaf module whose parameters carry the policy axis P. Records
    each parameter's initialiser, in creation order (flax's order: a
    kernel before its bias, a scale before its bias); ``reset_parameters``
    draws every policy's slice."""

    def __init__(self, num_policies: int, device=None):
        super().__init__()
        self.num_policies = num_policies
        self._device = device
        self._inits: Dict[str, Init] = {}

    def add(self, name: str, shape: Sequence[int], init: Init,
            dtype=torch.float32) -> None:
        t = torch.empty((self.num_policies, *shape), dtype=dtype,
                        device=self._device)
        self.register_parameter(name, nn.Parameter(t))
        self._inits[name] = init

    def draw(self, path: Sequence[str], keys: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """Fresh slices of every parameter for the policy keys ``keys
        [P, 2]``, as flax draws them for a module at ``path``, on the
        keys' device."""
        out = {}
        for i, (name, init) in enumerate(self._inits.items()):
            p = getattr(self, name)
            out[name] = init(param_key(keys, path, i),
                             tuple(p.shape[1:])).to(p.dtype).contiguous()
        return out

    @torch.no_grad()
    def reset_parameters(self, path: Sequence[str],
                         keys: torch.Tensor) -> None:
        for name, v in self.draw(path, keys).items():
            getattr(self, name).copy_(v)


def init_params(module: nn.Module, keys: torch.Tensor) -> None:
    """Draw every parameter of ``module`` as flax's ``init`` draws it,
    one policy per key of ``keys [P, 2]`` (CPU keys)."""
    for prefix, m in module.named_modules():
        if isinstance(m, Stacked):
            m.reset_parameters(prefix.split(".") if prefix else [], keys)


def draw_params(module: nn.Module, keys: torch.Tensor,
                device=None) -> Dict[str, torch.Tensor]:
    """Fresh parameters of ``module``'s layout, one policy per key of
    ``keys [P, 2]``, drawn as ``init_params`` draws them, as a flat dict
    keyed like ``named_parameters`` on ``device``."""
    out = {}
    for prefix, m in module.named_modules():
        if isinstance(m, Stacked):
            path = prefix.split(".") if prefix else []
            for name, v in m.draw(path, keys).items():
                out[f"{prefix}.{name}" if prefix else name] = v.to(device)
    return out


def _policy_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A [P, C] parameter viewed to broadcast against a [P|1, ..., C]
    activation of ``ndim`` dims."""
    return t.reshape((t.shape[0],) + (1,) * (ndim - 2) + (t.shape[-1],))


class Dense(Stacked):
    """flax ``nn.Dense`` / ``nn.DenseGeneral`` over a policy axis: kernel
    ``[P, *in_shape, *out_shape]``, bias ``[P, *out_shape]``. Contracts the
    trailing ``in_shape`` dims of x ``[P|1, ..., *in_shape]`` as one batched
    product over P (``torch.baddbmm``)."""

    def __init__(self, num_policies: int, in_shape, out_shape,
                 use_bias: bool = True, kernel_init: Init = orthogonal(),
                 bias_init: Init = zeros, dtype=torch.float32,
                 device=None):
        super().__init__(num_policies, device)
        self.in_shape = tuple(in_shape) if isinstance(in_shape, Sequence) \
            else (in_shape,)
        self.out_shape = tuple(out_shape) if isinstance(out_shape, Sequence) \
            else (out_shape,)
        self.dtype = dtype
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        shape = self.in_shape + self.out_shape

        def flat_init(keys, _shape):
            # flax's DenseGeneral draws the kernel as [in, out] matrix.
            return kernel_init(keys, (n_in, n_out)).reshape(
                keys.shape[0], *shape)

        self.add("kernel", shape, flat_init)
        if use_bias:
            self.add("bias", self.out_shape, bias_init)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor,
                add: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``add`` (``[P, ..., *out_shape]`` in the compute dtype, for a
        layer without a bias): the product accumulates into it, in place
        (one pass over it, where a separate sum takes three)."""
        p = self.kernel.shape[0]
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[1:x.dim() - len(self.in_shape)]
        x2 = x.to(self.dtype).reshape(x.shape[0], -1, n_in)
        if x2.shape[0] != p:
            x2 = x2.expand(p, -1, -1)
        k = self.kernel.to(self.dtype).reshape(p, n_in, n_out)
        if add is not None:
            y = add.view(p, -1, n_out).baddbmm_(x2, k)
        elif self.bias is None:
            y = torch.bmm(x2, k)
        else:
            y = torch.baddbmm(self.bias.to(self.dtype).reshape(p, 1, n_out),
                              x2, k)
        return y.reshape(p, *lead, *self.out_shape)


class LayerNorm(Stacked):
    """LayerNorm with float32 statistics whatever the compute dtype
    (layers.py:23-40): the exact variance, ``eps`` 1e-5, output cast back
    to the input's dtype. ``torch.var_mean`` takes both statistics in one
    reduction (Welford's update: as stable as JAX's two-pass ``jnp.var``,
    unlike the fast E[x^2] - E[x]^2), and one ``addcmul`` applies the
    policy's scale and bias."""

    def __init__(self, num_policies: int, num_features: int,
                 eps: float = 1e-5, device=None):
        super().__init__(num_policies, device)
        self.eps = eps
        self.add("scale", (num_features,), ones)
        self.add("bias", (num_features,), zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var, mean = torch.var_mean(x32, -1, correction=0, keepdim=True)
        normed = (x32 - mean) * torch.rsqrt(var + self.eps)
        n = x.dim()
        out = torch.addcmul(_policy_view(self.bias, n), normed,
                            _policy_view(self.scale, n))
        return out.to(x.dtype)


class FlaxLayerNorm(Stacked):
    """flax ``nn.LayerNorm()`` with its defaults (the recurrent encoder's
    ``rnn_norm``, actor_critic.py:51): ``epsilon`` 1e-6 and the fast
    variance E[x^2] - E[x]^2 clamped at 0, statistics in float32,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. The output is
    float32, the promotion of the input with the float32 parameters."""

    def __init__(self, num_policies: int, num_features: int,
                 eps: float = 1e-6, device=None):
        super().__init__(num_policies, device)
        self.eps = eps
        self.add("scale", (num_features,), ones)
        self.add("bias", (num_features,), zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mu = x32.mean(-1, keepdim=True)
        mu2 = torch.square(x32).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - torch.square(mu), min=0.0)
        n = x.dim()
        mul = torch.rsqrt(var + self.eps) * _policy_view(self.scale, n)
        return (x32 - mu) * mul + _policy_view(self.bias, n)


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` with JAX's gradient at 0: flax writes the function
    as ``where(x >= 0, x, 0.01 * x)``, whose slope at 0 is 1, where
    PyTorch's is 0.01. A zero input is common: a masked entity's embedding
    is exactly 0 while the biases are 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.leaky_relu(x, 0.01)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, 0.01 * grad)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.leaky_relu``: slope 0.01, and 1 at 0."""
    return _LeakyReLU.apply(x)


class MLP(nn.Module):
    """Stack of Dense + LayerNorm + leaky-relu blocks (layers.py:43-62)."""

    def __init__(self, num_policies: int, in_features: int,
                 num_channels: int, num_layers: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"Dense_{i}", Dense(
                num_policies, in_features if i == 0 else num_channels,
                num_channels, dtype=dtype, device=device))
            setattr(self, f"LayerNorm_{i}", LayerNorm(
                num_policies, num_channels, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = getattr(self, f"LayerNorm_{i}")(x)
            x = leaky_relu(x)
        return x


class EmbedBlock(nn.Module):
    """Dense + LayerNorm + leaky-relu entity embedding (layers.py:65-77)."""

    def __init__(self, num_policies: int, in_features: int,
                 num_channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.Dense_0 = Dense(num_policies, in_features, num_channels,
                             dtype=dtype, device=device)
        self.LayerNorm_0 = LayerNorm(num_policies, num_channels,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.LayerNorm_0(self.Dense_0(x)))


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention`` without dropout, written out as products
    and a softmax: query, key and value kernels ``[P, C, H, D]`` with
    biases ``[P, H, D]``, the query divided by sqrt(D), and the out kernel
    ``[P, H, D, C_out]``. Without a mask every token attends to every
    token; a key mask ``[P|1, ..., T]`` (True where a token may be
    attended to) sets the other keys' scores to -inf before the softmax,
    which subtracts the row's largest score (every row needs one key)."""

    def __init__(self, num_policies: int, in_features: int, num_heads: int,
                 qkv_features: int, out_features: int, dtype=torch.float32,
                 kernel_init: Init = orthogonal(1.0), device=None):
        super().__init__()
        head_dim = qkv_features // num_heads
        self.dtype = dtype
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(
                num_policies, in_features, (num_heads, head_dim),
                kernel_init=kernel_init, dtype=dtype, device=device))
        self.out = Dense(num_policies, (num_heads, head_dim), out_features,
                         kernel_init=kernel_init, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [.., T, H, D]
        depth = q.shape[-1]
        q = q / torch.sqrt(torch.tensor(float(depth))).to(q.dtype)
        w = torch.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask[..., None, None, :], float("-inf"))
        w = torch.softmax(w, dim=-1).to(q.dtype)
        y = torch.einsum("...hqk,...khd->...qhd", w, v)
        return self.out(y)


class EntitySelfAttentionNet(nn.Module):
    """Per-entity embed -> multi-head self attention over the entity axis
    -> mean-pool -> output Dense + LayerNorm + leaky-relu (layers.py:80-119).

    ``in_features`` maps each input group to its feature count; ``self``
    is the agent's own vector ``[.., F]``, every other group ``[.., N_i,
    F_i]``. Tokens go self first, then the groups sorted by name."""

    def __init__(self, num_policies: int, in_features: Mapping[str, int],
                 num_embed_channels: int = 128, num_out_channels: int = 256,
                 num_heads: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        self.groups = sorted(k for k in in_features if k != "self")
        c = num_embed_channels
        self.EmbedBlock_0 = EmbedBlock(num_policies, in_features["self"], c,
                                       dtype, device)
        for name in self.groups:
            setattr(self, f"embed_{name}", EmbedBlock(
                num_policies, in_features[name], c, dtype, device))
        self.SelfAttention_0 = SelfAttention(num_policies, c, num_heads, c, c,
                                             dtype=dtype, device=device)
        self.LayerNorm_0 = LayerNorm(num_policies, c, device=device)
        self.Dense_0 = Dense(num_policies, c, num_out_channels, dtype=dtype,
                             device=device)
        self.LayerNorm_1 = LayerNorm(num_policies, num_out_channels,
                                     device=device)

    def forward(self, obs: Mapping[str, torch.Tensor],
                train: bool = False) -> torch.Tensor:
        tokens = [self.EmbedBlock_0(obs["self"]).unsqueeze(-2)]
        for name in self.groups:
            tokens.append(getattr(self, f"embed_{name}")(obs[name]))
        seq = torch.cat(tokens, dim=-2)                       # [P, .., T, C]
        seq = self.LayerNorm_0(seq + self.SelfAttention_0(seq))
        pooled = seq.mean(dim=-2)
        return leaky_relu(self.LayerNorm_1(self.Dense_0(pooled)))


class ResidualSelfAttention(nn.Module):
    """A residual self-attention block with LayerNorm before the
    products and after the residual (Baker et al. 2019's
    ``residual_sa_block`` with one layer, no MLP after it):
    ``LayerNorm_1(x + SelfAttention_0(LayerNorm_0(x), mask))``. Each
    forward is the span ``model.attn``."""

    def __init__(self, num_policies: int, num_channels: int, num_heads: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(num_policies, num_channels,
                                     device=device)
        self.SelfAttention_0 = SelfAttention(
            num_policies, num_channels, num_heads, num_channels,
            num_channels, dtype=dtype, device=device)
        self.LayerNorm_1 = LayerNorm(num_policies, num_channels,
                                     device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with tracing.span("model.attn"):
            y = self.SelfAttention_0(self.LayerNorm_0(x), mask)
            return self.LayerNorm_1(x + y)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of x ``[.., T, C]`` over the tokens where mask ``[.., T]``
    is set (at least one a row)."""
    m = mask.to(x.dtype)
    return (x * m[..., None]).sum(-2) / m.sum(-1, keepdim=True)


class CircularConv1d(Dense):
    """flax ``nn.Conv`` over one spatial axis with circular padding and
    stride 1, stacked over policies: kernel ``[P, width, C_in, C_out]``,
    bias ``[P, C_out]``. x ``[P|1, ..., L, C_in]`` -> ``[P, ..., L,
    C_out]``: each position's window wraps around the ends, and one
    batched product contracts every window. The kernel is drawn as the
    Dense kernel ``[width * C_in, C_out]`` it is."""

    def __init__(self, num_policies: int, in_channels: int,
                 out_channels: int, width: int, dtype=torch.float32,
                 device=None):
        super().__init__(num_policies, (width, in_channels), out_channels,
                         dtype=dtype, device=device)
        self.width = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.width // 2
        wrapped = torch.cat([x[..., x.shape[-2] - half:, :], x,
                             x[..., :self.width - 1 - half, :]], dim=-2)
        windows = wrapped.unfold(-2, self.width, 1)      # [.., L, C_in, w]
        return super().forward(windows.transpose(-1, -2))


def conv_orthogonal(scale: float = 2.0 ** 0.5) -> Init:
    """``orthogonal(scale)`` over a convolution kernel's fan-in matrix
    ``[C_in * k * k, C_out]`` (the input channel, then the row and column
    of the window), stored as PyTorch's ``[C_out, C_in, k, k]``."""

    def init(keys: torch.Tensor, shape) -> torch.Tensor:
        n_in = math.prod(shape[1:])
        q = orthogonal(scale)(keys, (n_in, shape[0]))
        return q.transpose(1, 2).reshape(keys.shape[0], *shape)

    return init


@contextlib.contextmanager
def ieee_convolutions():
    """cuDNN's float32 convolutions without TF32 inside the block (PyTorch
    allows TF32 there by default), the setting as it was after it."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


class _Float32Conv(torch.autograd.Function):
    """``F.conv2d`` with stride 1 whose forward and backward both run
    under ``ieee_convolutions``: autograd runs the backward after the
    forward has returned, outside any block around the forward."""

    @staticmethod
    def forward(ctx, x, kernel, bias, padding: int):
        ctx.save_for_backward(x, kernel)
        ctx.padding = padding
        with ieee_convolutions():
            return F.conv2d(x, kernel, bias, padding=padding)

    @staticmethod
    def backward(ctx, grad):
        x, kernel = ctx.saved_tensors
        pad = ctx.padding
        with ieee_convolutions():
            gx, gk, gb = torch.ops.aten.convolution_backward(
                grad, x, kernel, [kernel.shape[0]], [1, 1], [pad, pad],
                [1, 1], False, [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return gx, gk, gb, None


class Conv2d(Stacked):
    """A k x k convolution with stride 1 and SAME padding (k // 2 on every
    side) over a policy axis: kernel ``[P, C_out, C_in, k, k]``, bias
    ``[P, C_out]``. ``forward(x, p)`` runs policy ``p``'s on x ``[B, C_in,
    H, W]`` (one policy's frames, contiguous): the caller loops over the
    policies, so each convolution is one cuDNN call on a whole policy's
    batch, with no transpose into a grouped layout. In float32 it computes
    in float32, forward and backward, whatever the process's TF32
    setting (``_Float32Conv``)."""

    def __init__(self, num_policies: int, in_channels: int,
                 out_channels: int, size: int = 3, dtype=torch.float32,
                 device=None):
        super().__init__(num_policies, device)
        self.dtype = dtype
        self.size = size
        self.add("kernel", (out_channels, in_channels, size, size),
                 conv_orthogonal())
        self.add("bias", (out_channels,), zeros)

    def forward(self, x: torch.Tensor, p: int) -> torch.Tensor:
        args = (x.to(self.dtype), self.kernel[p].to(self.dtype),
                self.bias[p].to(self.dtype))
        if self.dtype == torch.float32:
            return _Float32Conv.apply(*args, self.size // 2)
        return F.conv2d(*args, padding=self.size // 2)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """TensorFlow's SAME 3 x 3 max pool with stride 2 on an even H and W:
    window i covers rows (and columns) 2i .. 2i + 2, so the one padded row
    or column, -inf, lies at the end. PyTorch's ``ceil_mode`` windows
    without padding are those (the last one stops at the edge); its
    ``padding=1`` would pad both ends and shift every window by one."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


class ConvResidualBlock(nn.Module):
    """IMPALA's residual block (Espeholt et al. 2018, Figure 3):
    ``x + Conv2d_1(relu(Conv2d_0(relu(x))))``, channels unchanged."""

    def __init__(self, num_policies: int, channels: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.Conv2d_0 = Conv2d(num_policies, channels, channels, dtype=dtype,
                               device=device)
        self.Conv2d_1 = Conv2d(num_policies, channels, channels, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor, p: int) -> torch.Tensor:
        y = self.Conv2d_0(torch.relu(x), p)
        return x + self.Conv2d_1(torch.relu(y), p)


class ConvSection(nn.Module):
    """One section of IMPALA's deep torso: a 3 x 3 convolution to
    ``channels``, the SAME max pool (``max_pool_same``), then ``blocks``
    residual blocks."""

    def __init__(self, num_policies: int, in_channels: int, channels: int,
                 blocks: int, dtype=torch.float32, device=None):
        super().__init__()
        self.blocks = blocks
        self.Conv2d_0 = Conv2d(num_policies, in_channels, channels,
                               dtype=dtype, device=device)
        for i in range(blocks):
            setattr(self, f"ConvResidualBlock_{i}", ConvResidualBlock(
                num_policies, channels, dtype, device))

    def forward(self, x: torch.Tensor, p: int) -> torch.Tensor:
        x = max_pool_same(self.Conv2d_0(x, p))
        for i in range(self.blocks):
            x = getattr(self, f"ConvResidualBlock_{i}")(x, p)
        return x


@dataclasses.dataclass(frozen=True)
class DiscreteActionDistributions:
    """Factored categorical distribution over independent action dims
    (layers.py:122-167). ``logits [.., sum(buckets)]``."""

    buckets: Tuple[int, ...]
    logits: torch.Tensor

    def _split(self):
        return [lg.to(torch.float32)
                for lg in torch.split(self.logits, list(self.buckets), -1)]

    def sample(self, key: torch.Tensor,
               rows: Optional[Tuple[int, int]] = None):
        """One draw per action dim from ``key`` ``[2]`` u32, as JAX draws
        them (layers.py:138-142): ``split(key, len(buckets))``, then
        ``jax.random.categorical`` with each bucket's key over the whole
        batch of its logits. The Gumbel noise of every bucket comes from
        one launch: a bucket's draws are the first of its key's. With
        ``rows = (first, total)`` the logits ``[N, ..]`` are rows ``first``
        to ``first + N`` of a batch of ``total`` (a rank's agents), and
        draw what those rows draw in the whole batch."""
        lgs = self._split()
        keys = prng.split(key, len(lgs))
        first, total = rows or (0, lgs[0].shape[0])
        n = max(lg.numel() // lg.shape[0] * total for lg in lgs)
        g = prng.gumbel(keys, (n,))
        out = []
        for i, lg in enumerate(lgs):
            lo = first * (lg.numel() // lg.shape[0])
            noise = g[i, lo:lo + lg.numel()].reshape(lg.shape)
            out.append(torch.argmax(noise + lg, dim=-1))
        return torch.stack(out, dim=-1)

    def best(self):
        """Per dim the first maximum, as ``jnp.argmax``."""
        return torch.stack([torch.argmax(lg, dim=-1) for lg in self._split()],
                           dim=-1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        # A gather where JAX contracts with a one-hot: equal for finite
        # log-probabilities (a -inf one turns the one-hot's 0 * -inf into
        # NaN there, and stays -inf here).
        lps = []
        for i, lg in enumerate(self._split()):
            logp = torch.log_softmax(lg, dim=-1)
            a = actions[..., i:i + 1].to(torch.long)
            lps.append(torch.gather(logp, -1, a)[..., 0])
        return torch.stack(lps, dim=-1).sum(-1)

    def entropy(self) -> torch.Tensor:
        ents = []
        for lg in self._split():
            logp = torch.log_softmax(lg, dim=-1)
            ents.append(-(torch.exp(logp) * logp).sum(-1))
        return torch.stack(ents, dim=-1).sum(-1)


class DenseLayerDiscreteActor(nn.Module):
    """One dense head emitting factored categorical logits
    (layers.py:170-185)."""

    def __init__(self, num_policies: int, in_features: int,
                 buckets: Sequence[int], dtype=torch.float32, device=None):
        super().__init__()
        self.buckets = tuple(buckets)
        self.Dense_0 = Dense(num_policies, in_features, sum(self.buckets),
                             kernel_init=orthogonal(0.01), dtype=dtype,
                             device=device)

    def forward(self, features: torch.Tensor) -> DiscreteActionDistributions:
        return DiscreteActionDistributions(self.buckets, self.Dense_0(features))


class DenseLayerCritic(nn.Module):
    """Plain scalar value head, float32 out (layers.py:188-197), as
    ``{"value": [.., 1]}``: the rollout and the PPO loss read a critic's
    value by that key (JAX's returns the array, and no JAX path uses
    it)."""

    def __init__(self, num_policies: int, in_features: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.Dense_0 = Dense(num_policies, in_features, 1,
                             kernel_init=orthogonal(1.0), dtype=dtype,
                             device=device)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"value": self.Dense_0(features).to(torch.float32)}


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class DreamerV3Critic(nn.Module):
    """Categorical critic over symlog-spaced bins with two-hot targets
    (layers.py:213-259). ``forward`` returns ``{"logits": [.., bins],
    "value": [.., 1]}``, the value the symexp of the expected bin."""

    def __init__(self, num_policies: int, in_features: int,
                 dtype=torch.float32, num_bins: int = 255, lo: float = -20.0,
                 hi: float = 20.0, device=None):
        super().__init__()
        self.num_bins, self.lo, self.hi = num_bins, lo, hi
        self.Dense_0 = Dense(num_policies, in_features, num_bins,
                             kernel_init=zeros, dtype=dtype, device=device)

    def bin_centers(self, device=None) -> torch.Tensor:
        """``jnp.linspace(lo, hi, num_bins)`` in float32 as XLA computes
        it on the CPU: ``fma(i, hi / div, lo * (1 - i * (1 / div)))`` with
        div = num_bins - 1 and float32 constants (the fused multiply-add
        taken in float64, where i * (hi / div) is exact), then exactly
        hi."""
        f32 = torch.float32
        div = self.num_bins - 1
        i = torch.arange(div, dtype=f32)
        inv = torch.tensor(1.0 / div, dtype=f32)
        hi_step = torch.tensor(self.hi, dtype=f32) * inv
        lo_part = self.lo * (1.0 - i * inv)
        c = (i.double() * hi_step.double() + lo_part.double()).to(f32)
        with tracing.span("host_read.bin_centers"):
            return torch.cat([c, torch.tensor([self.hi])]).to(device)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = self.Dense_0(features).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        value = symexp((probs * self.bin_centers(logits.device)).sum(-1))
        return {"logits": logits, "value": value[..., None]}

    def two_hot_loss(self, logits: torch.Tensor,
                     target_values: torch.Tensor) -> torch.Tensor:
        """Cross-entropy against the two-hot encoding of symlog targets."""
        target = torch.clamp(symlog(target_values), self.lo, self.hi)
        idx = (target - self.lo) / (self.hi - self.lo) * (self.num_bins - 1)
        lo_idx = torch.clamp(torch.floor(idx).to(torch.long), 0,
                             self.num_bins - 1)
        hi_idx = torch.clamp(lo_idx + 1, 0, self.num_bins - 1)
        hi_w = idx - lo_idx.to(torch.float32)
        lo_w = 1.0 - hi_w
        logp = torch.log_softmax(logits, dim=-1)
        lp_lo = torch.gather(logp, -1, lo_idx[..., None])[..., 0]
        lp_hi = torch.gather(logp, -1, hi_idx[..., None])[..., 0]
        return -(lo_w * lp_lo + hi_w * lp_hi)

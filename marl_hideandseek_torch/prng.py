"""JAX's random streams in PyTorch: the same key gives the same numbers.

Re-implements ``jax.random`` for the threefry2x32 generator with
``jax_threefry_partitionable`` on (the default of JAX 0.9; a key from a
run with the flag off draws other numbers). A key is a u32 tensor of
shape ``[..., 2]``, the words of ``jax.random.key_data``; a batch of keys
(one per world, say) is a key tensor with leading axes, and every
function maps over them as ``jax.vmap`` would: a draw of ``shape`` from
keys ``[*B, 2]`` is ``[*B, *shape]``, each key's slice what JAX draws
from that key alone. Draws run on the keys' device, each through one or
two launches of the threefry kernel (``ops/threefry.py``). Python
numbers (seeds, bounds, data folded in) stay on the host side of each
operation: a tensor made from them on the card would be a host-to-device
copy, and PyTorch waits for the card to finish its queue before each such
copy.

Numbers against ``jax.random`` on the same keys: key words, bits and
integers are equal; ``uniform`` is equal bit for bit (a scaled range
with XLA's fused multiply-add); ``normal`` and ``gumbel`` differ by the
last bits of ``log`` and ``log1p`` (``erf_inv`` here is XLA's float32
polynomial in XLA's operation order).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from marl_hideandseek_torch.ops import threefry as tf
from marl_hideandseek_torch.utils import tracing

M32 = tf.M32
_F32 = torch.float32
TINY = float(np.finfo(np.float32).tiny)

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default,
    and the JAX package's): the seed narrows to int32, so the words are
    [0, seed & 0xFFFFFFFF]."""
    k = torch.zeros(2, dtype=torch.int32, device=device)
    with tracing.span("host_read.key"):
        k[1] = _signed(int(seed) & M32)
    return u32(k)


def _signed(w: int) -> int:
    """A u32 word as the int32 of the same bits."""
    return (w ^ 0x80000000) - 0x80000000


def as_key(words, device="cpu") -> torch.Tensor:
    """Key words from anything numpy reads (a JAX key's ``key_data``, a
    checkpoint's u32 array) as a u32 tensor on ``device``."""
    if isinstance(words, torch.Tensor):
        if words.dtype == torch.uint32:
            return words.to(device)
        return tf.to_u32(words.to(device).long())
    a = np.asarray(words).astype(np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device).view(torch.uint32)


def i32(keys: torch.Tensor) -> torch.Tensor:
    """The int32 view of u32 key words: PyTorch implements few operations
    on u32 (on the card, not indexing or concatenation), so keys are
    moved, indexed and joined as their int32 views."""
    return keys.view(torch.int32)


def u32(words: torch.Tensor) -> torch.Tensor:
    """Inverse of ``i32``."""
    return words.view(torch.uint32)


def _flat(keys: torch.Tensor):
    if keys.shape[-1] != 2:
        raise ValueError(f"keys: shape {tuple(keys.shape)}, expected [..., 2]")
    return u32(i32(keys).reshape(-1, 2).contiguous()), keys.shape[:-1]


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[*B, 2]`` -> ``[*B, num, 2]``."""
    flat, lead = _flat(keys)
    out = tf.threefry(flat, None, num, tf.PAIRS)
    return out.reshape(tuple(lead) + (num, 2))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the counter (0, data);
    ``data`` an int, or an integer tensor of the keys' batch shape (or
    any shape, for one key)."""
    flat, lead = _flat(keys)
    dev = keys.device
    if isinstance(data, int):
        ctr = torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)
        ctr[..., 1] = _signed(data & M32)
        out = tf.threefry(flat, u32(ctr), mode=tf.PAIRS)
        return out.reshape(tuple(lead) + (2,))
    data = tf.words(data.to(dev))
    ctr = torch.stack([torch.zeros_like(data), data], -1)
    if math.prod(lead) == 1:
        # One key, many counters: one row of counters.
        out = tf.threefry(flat, tf.to_u32(ctr.reshape(1, -1, 2)),
                          mode=tf.PAIRS)
        return out.reshape(tuple(data.shape) + (2,))
    ctr = ctr.expand(tuple(lead) + (2,)).reshape(-1, 1, 2)
    out = tf.threefry(flat, tf.to_u32(ctr), mode=tf.PAIRS)
    return out.reshape(tuple(lead) + (2,))


def bits(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): ``[*B, *shape]`` u32."""
    shape = _shape(shape)
    flat, lead = _flat(keys)
    n = math.prod(shape)
    out = tf.threefry(flat, None, n, tf.BITS)
    return out.reshape(tuple(lead) + shape)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


def uniform(keys: torch.Tensor, shape: Shape = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``[*B, *shape]`` in [minval,
    maxval); bounds are floats or tensors broadcasting to the result."""
    shape = _shape(shape)
    flat, lead = _flat(keys)
    u = tf.threefry(flat, None, math.prod(shape), tf.UNIFORM).reshape(
        tuple(lead) + shape)
    if (isinstance(minval, float) and isinstance(maxval, float)
            and minval == 0.0 and maxval == 1.0):
        return u
    return uniform_scale(u, minval, maxval)


def uniform_scale(u: torch.Tensor, minval, maxval) -> torch.Tensor:
    """``jax.random.uniform``'s map of a [0, 1) draw to [minval, maxval):
    max(minval, u * (maxval - minval) + minval), the multiply and add
    fused and rounded once, as XLA computes it (in float64 the product
    of two floats is exact)."""
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        lo = torch.as_tensor(minval, dtype=_F32, device=u.device)
        hi = torch.as_tensor(maxval, dtype=_F32, device=u.device)
        fma = (u.double() * (hi - lo).double() + lo.double()).to(_F32)
        return torch.maximum(lo, fma)
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    out = (u.double() * span + float(lo)).to(_F32)
    return torch.clamp(out, min=float(lo))


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 words in [0, 2**32) (b a tensor or an
    int), without overflowing int64: b is split into 16-bit halves."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval,
                      maxval) -> torch.Tensor:
    """``jax.random.randint``'s map from its two 32-bit draws (int64
    words) to [minval, maxval) in int32 semantics; int64 out. Lets a
    caller draw the bits before the bounds are known."""
    def clip(v):
        if isinstance(v, torch.Tensor):
            return torch.clamp(v.long(), _I32_MIN, _I32_MAX)
        return min(max(int(v), _I32_MIN), _I32_MAX)

    minval, maxval = clip(minval), clip(maxval)
    if isinstance(minval, int) and isinstance(maxval, int):
        span = maxval - minval if maxval > minval else 1
        mult = (((1 << 16) % span) ** 2 & M32) % span
        if span <= 1 << 16:
            # Both terms stay below 2**32: no wraparound to reproduce.
            return minval + ((higher % span) * mult + lower % span) % span
    else:
        span = torch.where(maxval <= minval, 1, maxval - minval)
        mult = (1 << 16) % span
        mult = _mul32(mult, mult) % span
    off = (_mul32(higher % span, mult) + lower % span) & M32
    return minval + off % span


def randint_bits(keys: torch.Tensor, shape: Shape = ()):
    """The two 32-bit draws ``jax.random.randint`` makes from each key
    (int64 words ``[*B, *shape]`` each), in one launch."""
    shape = _shape(shape)
    b = bits(split(keys), shape)                  # [*B, 2, *shape]
    nb = keys.dim() - 1
    return tf.words(b.select(nb, 0)), tf.words(b.select(nb, 1))


def randint(keys: torch.Tensor, shape: Shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` (int32 semantics, int64 out): ``[*B,
    *shape]`` in [minval, maxval); bounds broadcast to the result."""
    return randint_from_bits(*randint_bits(keys, shape), minval, maxval)


def bernoulli(keys: torch.Tensor, p=0.5, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli``: uniform < p."""
    u = uniform(keys, shape)
    return u < p


def gumbel(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): -log(-log(u)), u uniform in
    [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: argmax of logits
    plus Gumbel noise. ``keys [*B, 2]`` with ``B`` a prefix of
    ``logits.shape[:-1]``; each key draws the noise of the logits under
    it. int64 out."""
    nb = keys.dim() - 1
    g = gumbel(keys, tuple(logits.shape[nb:]))
    return torch.argmax(g + logits, dim=-1)


def _shuffle_rounds(n: int) -> int:
    """``jax.random.permutation``'s sort rounds (random.py, _shuffle)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: arange(n) sorted (stably) by
    fresh 32-bit draws, as many rounds as JAX's _shuffle takes. ``[*B,
    n]`` int64."""
    lead = keys.shape[:-1]
    x = torch.arange(n, device=keys.device).expand(*lead, n)
    for _ in range(_shuffle_rounds(n)):
        ks = split(keys)
        keys, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.argsort(tf.words(bits(sub, (n,))), dim=-1, stable=True)
        x = torch.gather(x, -1, order)
    return x


# XLA's float32 erf_inv (the polynomial of M. Giles, "Approximating the
# erfinv function"), coefficients highest degree first, as XLA writes it.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, in its operation order."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(_F32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b).to(_F32) + p * w
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) erf_inv(u), u uniform in
    (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * erf_inv(uniform(keys, shape, lo, 1.0))


def truncated_normal(keys: torch.Tensor, lower: float, upper: float,
                     shape: Shape = ()) -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32."""
    dev = keys.device
    lo, hi = _f32(lower, dev), _f32(upper, dev)
    a = torch.erf(lo / _SQRT2)
    b = torch.erf(hi / _SQRT2)
    out = _SQRT2 * erf_inv(uniform(keys, shape, a, b))
    return torch.clamp(out, torch.nextafter(lo, _f32(math.inf, dev)),
                       torch.nextafter(hi, _f32(-math.inf, dev)))


def orthogonal(keys: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """``jax.random.orthogonal(key, n, (), float32, m)``: ``[*B, n, m]``,
    the Q of a QR of a normal matrix with R's diagonal signs folded in
    (transposed when n < m)."""
    z = normal(keys, (max(n, m), min(n, m)))
    q, r = torch.linalg.qr(z)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    x = q * torch.sign(d).unsqueeze(-2)
    return x.mT if n < m else x

"""Random draws for episode set-up and level generation.

Two sources, behind one call (``uniform``):

* a ``torch.Generator`` - one stream for the whole batch, so a world's
  draws depend on the other worlds drawn with it;
* a ``KeyedRNG`` - counter-based draws keyed per world by its two u32
  key words, so a world's draws depend on its key alone, whatever batch
  it is drawn in. The episode draws run on it (``episode_rng``: keyed by
  seed, world id and episode counter), and so does the level generator
  by default, so a level regenerates exactly from a checkpoint's level
  key, as the JAX package's threefry-keyed generator does. The hash is
  not threefry: the same key gives other numbers than JAX's.

Every draw takes a shape whose first axis is the batch of worlds.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without overflowing
    int64: c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply, 'lowbias32')."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class KeyedRNG:
    """Uniform draws for ``k`` worlds keyed by ``key [2, k]`` u32.

    Draw ``n`` of a world is ``hash(key, n)``; each call takes the next
    ``prod(shape[1:])`` draws of every world, so a world's numbers follow
    from its key and the sequence of draw shapes only. Bits are hashed in
    blocks of ``BLOCK`` draws per world, a few launches per block.
    """

    BLOCK = 256

    def __init__(self, key: torch.Tensor):
        k = key.view(torch.int32).long() & _M32              # [2, k]
        self.k0 = k[0][:, None]
        self.k1 = k[1][:, None]
        self._buf = torch.empty((k.shape[1], 0), dtype=torch.long,
                                device=key.device)
        self._next = 0

    def _take(self, m: int) -> torch.Tensor:
        while self._buf.shape[1] < m:
            n = torch.arange(self._next, self._next + self.BLOCK,
                             device=self.k0.device)
            h = _mix32(_mix32(_mix32(n)[None] ^ self.k0) ^ self.k1)
            self._buf = torch.cat([self._buf, h], dim=1)
            self._next += self.BLOCK
        out, self._buf = self._buf[:, :m], self._buf[:, m:]
        return out

    def bits(self, shape) -> torch.Tensor:
        """The next draws of ``shape`` as int64 bits in [0, 2**32)."""
        if shape[0] != self.k0.shape[0]:
            raise ValueError(f"KeyedRNG of {self.k0.shape[0]} worlds asked "
                             f"for draws of shape {tuple(shape)}")
        return self._take(math.prod(shape[1:])).reshape(shape)

    def rand(self, shape, dtype=torch.float32) -> torch.Tensor:
        bits = self.bits(shape)
        if dtype == torch.float64:
            return bits.to(torch.float64) * 2.0 ** -32
        return (bits >> 8).to(dtype) * 2.0 ** -24


def uniform(gen, shape, device, dtype=torch.float32) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` from a Generator or a KeyedRNG."""
    if isinstance(gen, KeyedRNG):
        return gen.rand(shape, dtype)
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def randint(gen, lo, hi, shape, device) -> torch.Tensor:
    """Uniform integers in [lo, hi) with per-element tensor bounds (i64)."""
    lo = torch.as_tensor(lo, device=device, dtype=torch.long)
    hi = torch.as_tensor(hi, device=device, dtype=torch.long)
    u = uniform(gen, shape, device, torch.float64)
    span = torch.clamp(hi - lo, min=1)
    return lo + torch.minimum(torch.floor(u * span).long(), span - 1)


def random_u32(gen, shape, device) -> torch.Tensor:
    """Uniform u32 words of ``shape`` from a Generator or a KeyedRNG."""
    if isinstance(gen, KeyedRNG):
        x = gen.bits(shape)
    else:
        x = torch.randint(0, 2 ** 32, shape, generator=gen, device=device,
                          dtype=torch.long)
    return x.to(torch.uint32)


def episode_rng(seed: int, world_ids: torch.Tensor,
                episode_counter: torch.Tensor) -> KeyedRNG:
    """The per-world stream of one episode's draws: key word 0 hashes
    (seed, world id), key word 1 the episode counter, so a world's
    episode follows from (seed, id, counter) alone, whatever batch draws
    it (JAX: fold_in(fold_in(base_key, world_id), episode_counter))."""
    seed_w = torch.full_like(world_ids.long(), seed & _M32)
    k0 = _mix32(_mix32(seed_w) ^ (world_ids.long() & _M32))
    k1 = _mix32(episode_counter.long() & _M32)
    return KeyedRNG(torch.stack([k0, k1]).to(torch.uint32))

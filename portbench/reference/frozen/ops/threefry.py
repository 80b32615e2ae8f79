# Frozen copy of marl_hideandseek_torch/ops/threefry.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""The threefry2x32-20 kernel: one launch hashes a batch of keys with a
batch of counters.

``threefry`` launches ``csrc/threefry.cu`` for CUDA tensors and runs the
plain PyTorch version (``threefry_plain``: int64 words under a 32-bit
mask) for CPU tensors. Every random draw of the port goes through it
(``prng.py``). It has no Pallas counterpart: it replaces XLA's lowering
of ``threefry2x32`` (jax/_src/prng.py, ``_threefry2x32_lowering``),
which JAX fuses into the programs that draw, and it was added so that
the port's draws are JAX's and each draw is one launch instead of the
plain version's ~150 int64 passes. Integer operations bound it on the
card (about 80 an item against 4-8 bytes written): one thread per item
keeps the 20 rounds in registers, and neighbouring threads write
neighbouring words.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from portbench.reference.frozen.ops.build import CudaKernel
from portbench.reference.frozen.ops.common import INT, PTR, stream_ptr

LL = ctypes.c_longlong
THREEFRY = CudaKernel("threefry", "mhs_threefry",
                      [PTR, PTR, LL, LL, LL, INT, PTR, PTR])

# Output modes (csrc/threefry.cu).
PAIRS, BITS, UNIFORM = 0, 1, 2

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def words(x: torch.Tensor) -> torch.Tensor:
    """u32 (or i32) words as int64 in [0, 2**32)."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.long() & M32


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) as a u32 tensor."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32).view(
        torch.uint32)


def hash_words(k0, k1, x0, x1):
    """threefry2x32-20 on int64 words (broadcasting): (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def finish(y0: torch.Tensor, y1: torch.Tensor, mode: int) -> torch.Tensor:
    """The output of ``mode`` from the two hashed int64 words."""
    if mode == PAIRS:
        return to_u32(torch.stack([y0, y1], -1))
    v = y0 ^ y1
    if mode == BITS:
        return to_u32(v)
    fb = ((v >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def threefry_plain(keys: torch.Tensor, counters: Optional[torch.Tensor],
                   n: int, mode: int) -> torch.Tensor:
    """Plain PyTorch version of ``threefry``."""
    kw = words(keys)
    k0, k1 = kw[:, 0, None], kw[:, 1, None]
    if counters is None:
        j = torch.arange(n, device=keys.device, dtype=torch.long)
        x0, x1 = (j >> 32)[None], (j & M32)[None]
    else:
        cw = words(counters)
        x0, x1 = cw[..., 0], cw[..., 1]
    y0, y1 = hash_words(k0, k1, x0, x1)
    shape = (keys.shape[0], n)
    return finish(y0.expand(shape), y1.expand(shape), mode)


def threefry(keys: torch.Tensor, counters: Optional[torch.Tensor] = None,
             n: Optional[int] = None, mode: int = PAIRS) -> torch.Tensor:
    """threefry2x32-20 of every key with each of its ``n`` counters.

    ``keys [k, 2]`` u32; ``counters [k or 1, n, 2]`` u32, or None for the
    counters (0, j), j < n. Returns ``[k, n, 2]`` u32 (``PAIRS``), ``[k,
    n]`` u32 (``BITS``: the two words xor-ed) or ``[k, n]`` f32
    (``UNIFORM``: those bits as JAX's uniform float in [0, 1)). CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if counters is not None:
        n = counters.shape[1]
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys: shape {tuple(keys.shape)}, expected [k, 2]")
    if counters is not None and (
            counters.dim() != 3 or counters.shape[2] != 2
            or counters.shape[0] not in (1, keys.shape[0])):
        raise ValueError(f"counters: shape {tuple(counters.shape)}, expected "
                         f"[1 or {keys.shape[0]}, n, 2]")
    if True:  # frozen: always the plain version
        return threefry_plain(keys, counters, n, mode)
    dev = keys.device
    k = keys.shape[0]
    keys = _u32_contiguous(keys, dev)
    ctr_ptr, stride = None, 0
    if counters is not None:
        counters = _u32_contiguous(counters, dev)
        ctr_ptr = counters.data_ptr()
        stride = 2 * n if counters.shape[0] == k and k > 1 else 0
    if mode == PAIRS:
        out = torch.empty((k, n, 2), dtype=torch.uint32, device=dev)
    else:
        out = torch.empty((k, n), device=dev, dtype=(
            torch.uint32 if mode == BITS else torch.float32))
    THREEFRY(keys.data_ptr(), ctr_ptr, stride, k, n, mode, out.data_ptr(),
             stream_ptr(dev))
    return out


def _u32_contiguous(t: torch.Tensor, dev) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"threefry: a tensor on {t.device}, keys on {dev}")
    if t.dtype != torch.uint32:
        raise ValueError(f"threefry: dtype {t.dtype}, expected torch.uint32")
    return t.view(torch.int32).contiguous().view(torch.uint32)

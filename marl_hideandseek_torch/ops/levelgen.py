"""K7: level-1 generation in one launch (``csrc/levelgen.cu``).

``training_world_kernel`` maps a batch of worlds' draws
(``env/levelgen.py::level_draws``) and episode draws to every leaf of
their packed level-1 state, as ``env/levelgen.py::generate_training_world``
computes it op by op. It runs on CUDA tensors only; the caller,
``env/levelgen.py::training_world_packed``, takes the plain version for
CPU tensors. The kernel replaces no Pallas kernel: the JAX package's
generator is jnp that XLA fuses (``marl_hideandseek_tpu/env/levelgen.py``,
``geometry.py``), and the plain version's ~40,000 small launches a call
left the card waiting on the host.

``LEVELGEN.launches`` and ``LEVELGEN.worlds`` count the launches and the
worlds they generated, so a run can show that every level-1 world on the
card went through K7.
"""

from __future__ import annotations

import functools
import itertools

import torch

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.env import geometry
from marl_hideandseek_torch.ops.build import CudaKernel
from marl_hideandseek_torch.ops.common import ARRAY_ENTRY, check, launch_arrays
from marl_hideandseek_torch.types import EnvState, pack_state

LEVELGEN = CudaKernel("levelgen", "mhs_levelgen", ARRAY_ENTRY)
LEVELGEN.worlds = 0

N_TRIALS = 21                 # levelgen.MAX_REJECTIONS + 1


@functools.lru_cache(maxsize=None)
def _packed_schema(cfg: EnvConfig) -> EnvState:
    """One packed world of ``env/levelgen.py::empty_world`` on the meta
    device: every leaf's shape and dtype, with no storage."""
    # env/levelgen.py imports this module to launch K7.
    from marl_hideandseek_torch.env.levelgen import empty_world

    return pack_state(empty_world(cfg, 1, "meta"))


def level1_outputs(cfg: EnvConfig, w: int, device) -> EnvState:
    """The packed level-1 state K7 writes: the leaves of ``empty_world``'s
    schema with W worlds, uninitialised, as contiguous views of one
    allocation (one call to the caching allocator, not 37), each starting
    on a 16-byte boundary."""
    schema = _packed_schema(cfg)
    sizes = [-(-x.numel() * x.element_size() * w // 16) * 16
             for x in schema.leaves()]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    starts = itertools.accumulate([0] + sizes)

    def view(x):
        at = next(starts)
        n = x.numel() * x.element_size() * w
        return buf[at:at + n].view(x.dtype).view(x.shape[:-1] + (w,))

    return schema.map(view)


def levelgen_params(cfg: EnvConfig, draws, level_key, ep_key, num_hiders,
                    num_seekers, seekers_first, out: EnvState):
    """K7's pointers and ints for ``draws`` (a ``LevelDraws`` of G = W
    worlds, or of one world under ``UseFixedWorld``) and the episode
    draws of W worlds (``level_key, ep_key [2, W]`` u32, team sizes
    ``[W]`` i64, ``seekers_first [W]`` bool), writing into ``out``
    (``level1_outputs``). Raises on what the kernel does not take."""
    w = num_hiders.shape[0]
    dev = num_hiders.device
    g = 1 if cfg.use_fixed_world else w
    n_ent = cfg.num_dyn_bodies
    u32, i32, f32 = torch.uint32, torch.int32, torch.float32
    wd = draws.walls

    def words(t, name, shape):
        if t.dtype != u32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {u32}")
        return check(t.view(i32), name, shape, i32, dev)

    ptrs = [
        words(wd.bits, "wall bits", (g, geometry.N_WALL_BITS, 2)),
        check(wd.u, "wall uniforms", (g, geometry.N_WALL_U), f32, dev),
        words(draws.counts, "count bits", (g, 2, 2)),
        check(draws.pose_u, "pose uniforms", (g, n_ent, 2, 2 * N_TRIALS),
              f32, dev),
        words(ep_key, "ep_key", (2, w)),
        words(level_key, "level_key", (2, w)),
        check(num_hiders, "num_hiders", (w,), torch.int64, dev),
        check(num_seekers, "num_seekers", (w,), torch.int64, dev),
        check(seekers_first, "seekers_first", (w,), torch.bool, dev),
    ]
    ptrs += [t.data_ptr() for t in out.leaves()]
    return ptrs, [w, g, cfg.max_boxes, cfg.max_ramps, cfg.max_agents]


def training_world_kernel(cfg: EnvConfig, draws, level_key, ep_key,
                          num_hiders, num_seekers,
                          seekers_first) -> EnvState:
    """Level 1 for W worlds, PACKED, in one K7 launch (arguments as
    ``levelgen_params``); CUDA tensors only."""
    dev = num_hiders.device
    if dev.type != "cuda":
        raise ValueError(f"K7 runs on CUDA tensors, got {dev}; the plain "
                         "generator is env/levelgen.py's")
    w = num_hiders.shape[0]
    out = level1_outputs(cfg, w, dev)
    ptrs, ip = levelgen_params(cfg, draws, level_key, ep_key, num_hiders,
                               num_seekers, seekers_first, out)
    launch_arrays(LEVELGEN, ptrs, ip, [], dev)
    LEVELGEN.worlds += w
    return out

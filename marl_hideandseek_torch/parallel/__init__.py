"""Data parallelism over ranks of ``torch.distributed`` (port of
``marl_hideandseek_tpu.parallel``)."""

from marl_hideandseek_torch.parallel.mesh import (
    LOCAL,
    Mesh,
    make_mesh,
    make_sharded_packed_step,
    sharded_packed_init,
)

__all__ = ["LOCAL", "Mesh", "make_mesh", "make_sharded_packed_step",
           "sharded_packed_init"]

# Frozen copy of marl_hideandseek_torch/parallel/__init__.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Data parallelism over ranks of ``torch.distributed`` (port of
``marl_hideandseek_tpu.parallel``)."""

from portbench.reference.frozen.parallel.mesh import (
    LOCAL,
    Mesh,
    make_mesh,
    make_sharded_packed_step,
    sharded_packed_init,
)

__all__ = ["LOCAL", "Mesh", "make_mesh", "make_sharded_packed_step",
           "sharded_packed_init"]

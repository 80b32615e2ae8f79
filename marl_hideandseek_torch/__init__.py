"""PyTorch + CUDA port of the hide-and-seek batch simulator.

A second package beside ``marl_hideandseek_tpu`` (the JAX reference, left
unchanged). It imports torch and never JAX. The main path is
``env.packed.PackedEnv``: ``init`` / ``step`` over packed state (world axis
last), with hand-written CUDA kernels for the megastep
(``ops/step.py``) and the raycast (``ops/rays.py``) and plain PyTorch
versions of both for CPU tensors.
"""

__version__ = "0.1.0"

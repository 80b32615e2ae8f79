"""PyTorch + CUDA port of the hide-and-seek batch simulator.

A second package beside ``marl_hideandseek_tpu`` (the JAX reference, left
unchanged). It imports torch and never JAX. The main path is
``env.packed.PackedEnv``: ``init`` / ``step`` over packed state (world axis
last) on the megastep kernel (``ops/step.py``). The classic
``env.env.HideAndSeekEnv`` is a world-major front over the same core: it
packs at entry, steps on the fused physics + sweep kernel
(``ops/fused.py``) and unpacks at exit, and renders RGBD with its own
kernel (``ops/rgbd.py``); the raycast (``ops/rays.py``) re-sweeps reset worlds in
both, and the physics step alone (``ops/physics.py``) serves the classic
env's unfused branch. Every kernel is hand-written CUDA with a plain
PyTorch version that CPU tensors take.
"""

__version__ = "0.1.0"

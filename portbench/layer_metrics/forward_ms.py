"""forward_ms: ``infer.run_inference(timing=True)``'s CUDA-event
milliseconds per step of the forward (normalize, the ensemble through
``train/rollout.py::apply_ensemble`` and ``models/``, the action draw),
mean over the traced window's steps."""


def read(ctx):
    return ctx["values"].get("forward_ms")

"""env_ms.serve: ``infer.run_inference(timing=True)``'s CUDA-event
milliseconds per step of ``env/packed.py::PackedEnv.step``, mean over the
traced window's steps."""


def read(ctx):
    return ctx["values"].get("env_ms")

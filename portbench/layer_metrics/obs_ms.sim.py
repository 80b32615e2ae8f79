"""obs_ms.sim: device-clock milliseconds of observation assembly (the
``env.observations`` spans of ``env/packed.py``, around
``env/observations.py::build_observations_packed``) per ``env.step`` span
of the traced stretch."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per(ctx, "env.observations", "env.step")

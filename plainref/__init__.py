"""Plain float32 references of the port's model configurations, in torch
alone: no JAX, nothing of ``marl_hideandseek_torch``, no kernel."""

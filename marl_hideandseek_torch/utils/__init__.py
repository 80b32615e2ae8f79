"""Runtime helpers of the PyTorch port (port of
``marl_hideandseek_tpu.utils``)."""

# Frozen copy of marl_hideandseek_torch/utils/__init__.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Runtime helpers of the PyTorch port (port of
``marl_hideandseek_tpu.utils``)."""

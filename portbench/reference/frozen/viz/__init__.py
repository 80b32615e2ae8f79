# Frozen copy of marl_hideandseek_torch/viz/__init__.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Visualisation: the plain per-agent RGBD renderer."""

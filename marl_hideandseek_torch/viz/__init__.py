"""Visualisation: the plain per-agent RGBD renderer."""

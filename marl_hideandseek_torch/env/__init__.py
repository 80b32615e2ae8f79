"""Environment: state systems, physics, rays, observations, level generation."""

"""Chunk program: device kernels a step in the profiled stretch."""

from portbench.readers import kernels_per_step as read  # noqa: F401

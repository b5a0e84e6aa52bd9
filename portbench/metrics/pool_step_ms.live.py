"""Serving layer (`parallel.pool.StreamPool`): host wall of `step()` a
dispatched step."""

from portbench.readers import pool_step_ms as read  # noqa: F401

"""Device: the share of the profiled stretch with no operation on the card."""

from portbench.readers import device_idle_pct as read  # noqa: F401

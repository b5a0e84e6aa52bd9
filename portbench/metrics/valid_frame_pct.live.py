"""Serving layer: valid frames over the lanes x frames_per_step slots
dispatched."""

from portbench.readers import valid_frame_pct as read  # noqa: F401

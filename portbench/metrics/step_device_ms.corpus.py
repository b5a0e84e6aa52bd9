"""Chunk program (`models.pipeline.make_chunk_fn`): device milliseconds
between CUDA events recorded on the stream around each `step()`, a step."""

from portbench.readers import step_device_ms as read  # noqa: F401

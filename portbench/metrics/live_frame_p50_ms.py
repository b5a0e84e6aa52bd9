"""The median of live_frame_p95_ms's samples."""

from portbench.readers import latency_percentile


def read(rec):
    return latency_percentile(rec, 50)

"""95th percentile, over every frame whose last sample was due in the
window, of the time from that instant to the first poll at which the pool's
frame_count for the stream includes the frame (host clock); a frame that
never came out counts at the wait's deadline."""

from portbench.readers import latency_percentile


def read(rec):
    return latency_percentile(rec, 95)

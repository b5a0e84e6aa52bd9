"""Profiling and observability: torch.profiler traces and throughput
counters (twin of `swiftmp3_tpu.utils.profiling`; `ThroughputMeter` is a
verbatim copy of the reference's).

    with device_trace("traces/"):        # a Chrome trace, traces/trace_<pid>_<ns>.json
        with annotate("encode step"):    # a named span in the timeline
            ...
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class ThroughputMeter:
    """Accumulates encoded audio-seconds and wall time."""

    sample_rate: int = 44100
    frames: int = 0
    bytes_out: int = 0
    wall_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, frames: int = 0, bytes_out: int = 0) -> None:
        self.wall_seconds += time.perf_counter() - self._t0
        self.frames += frames
        self.bytes_out += bytes_out

    @property
    def audio_seconds(self) -> float:
        return self.frames * 1152 / self.sample_rate

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self) -> dict:
        return {
            "frames": self.frames,
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "realtime_factor": round(self.realtime_factor, 1),
            "bytes_out": self.bytes_out,
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the host and, with a card, the device around
    a code block, written on exit as a Chrome trace (chrome://tracing,
    Perfetto) into log_dir, which is made if missing. Yields the profiler,
    whose key_averages() sum the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    name = f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def annotate(name: str):
    """Named trace region (shows up in profiler timelines)."""
    with torch.profiler.record_function(name):
        yield

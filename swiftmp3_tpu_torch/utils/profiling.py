"""Profiling and observability: the port's spans and counters, torch.profiler
traces and throughput counters (twin of `swiftmp3_tpu.utils.profiling`;
`ThroughputMeter` is a verbatim copy of the reference's).

The port marks where its work happens with `annotate(name)` spans and
`count(name, n)` counters. Tracing is off by default: a span site then
checks one module-level flag and gets a shared no-op context back, reading
no clock. Turned on, each span records (name, start, end) on the epoch
clock (`time.time_ns()`, the clock the profiler's events carry) for its
thread, nested per thread, and opens a `record_function` of the same name,
so the port's phases show in any profiler trace.

    enable()                               # or: with device_trace("traces/"):
    encode_corpus(options, streams)
    disable()
    snap = snapshot()                      # {"spans", "totals", "counters"}
    snap["totals"]["chunk.loop_t"]         # [count, nanoseconds]

    with device_trace("traces/"):          # a Chrome trace, traces/trace_<pid>_<ns>.json
        with annotate("encode step"):      # a named span in the timeline
            ...
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch

_on = False  # the one flag a span site reads
_NOOP = contextlib.nullcontext()  # what annotate returns while tracing is off
_lock = threading.Lock()
_local = threading.local()  # this thread's nesting depth
_spans: list = []  # (name, start_ns, end_ns, native thread id, depth), in order of ending
_counters: dict = {}


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


def enable() -> None:
    """Turn the port's tracing on (spans and counters record)."""
    global _on
    _on = True


def disable() -> None:
    """Turn the port's tracing off; what was recorded stays for snapshot()."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span and counter recorded."""
    with _lock:
        _spans.clear()
        _counters.clear()


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (thread-safe; nothing while tracing is off)."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """What was recorded: `spans`, each (name, start_ns, end_ns, thread,
    depth) on the epoch clock with the native id of its thread and its
    nesting depth there (0 outermost), in order of ending; `totals`
    {name: [count, nanoseconds]}, a nested span's time also in its
    parent's; `counters` {name: value}."""
    with _lock:
        spans, counters = list(_spans), dict(_counters)
    totals: dict = {}
    for name, start, end, _, _ in spans:
        t = totals.setdefault(name, [0, 0])
        t[0] += 1
        t[1] += end - start
    return {"spans": spans, "totals": totals, "counters": counters}


class _Span:
    """One recorded span (tracing on): the epoch clock at both ends, around
    a `record_function` of the same name."""

    __slots__ = ("name", "start", "depth", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.depth = getattr(_local, "depth", 0)
        _local.depth = self.depth + 1
        self.start = time.time_ns()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        end = time.time_ns()
        _local.depth = self.depth
        with _lock:
            _spans.append((self.name, self.start, end, threading.get_native_id(), self.depth))
        return False


def annotate(name: str):
    """The port's span: `with annotate("chunk.sweep"): ...`. Off, the shared
    no-op context; on, a recorded span that also shows in profiler
    timelines."""
    if not _on:
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the host and, with a card, the device around
    a code block, written on exit as a Chrome trace (chrome://tracing,
    Perfetto) into log_dir, which is made if missing. The port's tracing is
    on inside the block, so its spans show in the trace. Yields the
    profiler, whose key_averages() sum the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
    name = f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))

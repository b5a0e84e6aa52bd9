"""The record of one run, and the arithmetic the metric readers share.

A reader (`metrics/<name>.py`) calls one of these on the `Record` and
returns a number, or None where the run holds nothing for it to read (a
span never recorded, a kernel never launched, no profiled stretch).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import bounds


@dataclass
class Record:
    """What a run leaves for its readers. Host times are time.perf_counter
    seconds (`window`, `jobs`), spans perf_counter_ns pairs."""

    setup_s: float
    window: tuple[float, float]
    jobs: list = field(default_factory=list)  # generator.Job of a corpus run
    latencies_ms: list = field(default_factory=list)  # every frame due in a live run's window
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    step_device_ms: list = field(default_factory=list)
    profile: dict | None = None


def audio_rate(rec: Record) -> float | None:
    """Audio seconds of every job started in the window over the time from
    the window's start to the last such job's end."""
    if not rec.jobs:
        return None
    return sum(j.audio_s for j in rec.jobs) / (rec.jobs[-1].end - rec.window[0])


def latency_percentile(rec: Record, q: float) -> float | None:
    """The q-th percentile (linear between order statistics) of every frame
    latency of the window, a frame that never came out counted at the wait's
    deadline."""
    if not rec.latencies_ms:
        return None
    return float(np.percentile(np.asarray(rec.latencies_ms), q))


def _total_ns(rec: Record, name: str) -> int:
    return sum(t1 - t0 for t0, t1 in rec.spans.get(name, ()))


def per_step_ms(rec: Record, name: str) -> float | None:
    """Host milliseconds in span `name` a dispatched step."""
    steps = len(rec.spans.get("step", ()))
    if not steps or name not in rec.spans:
        return None
    return _total_ns(rec, name) / steps * 1e-6


def pool_step_ms(rec: Record) -> float | None:
    """Host wall of `StreamPool.step`, the profiler's own pauses left out,
    over the steps that dispatched work (the pool's host thread a step)."""
    steps = len(rec.spans.get("step", ()))
    if not steps or "pool_step" not in rec.spans:
        return None
    return (_total_ns(rec, "pool_step") - _total_ns(rec, "profiler")) / steps * 1e-6


def files_self_ms(rec: Record) -> float | None:
    """The job spans minus their prepare, step and drain spans (and the
    profiler's pauses), a step: chunk building, encoder set-up, ID3/Xing."""
    steps = len(rec.spans.get("step", ()))
    if not steps or "job" not in rec.spans:
        return None
    inner = sum(_total_ns(rec, n) for n in ("prepare", "step", "drain", "profiler"))
    return (_total_ns(rec, "job") - inner) / steps * 1e-6


def valid_frame_pct(rec: Record) -> float | None:
    """Valid frames over the frame slots (lanes x frames a step) dispatched."""
    slots = rec.counters.get("frame_slots", 0)
    return 100.0 * rec.counters["valid_frames"] / slots if slots else None


def step_device_ms(rec: Record) -> float | None:
    """Device milliseconds between the CUDA events around each step, a step."""
    return float(np.mean(rec.step_device_ms)) if rec.step_device_ms else None


def kernels_per_step(rec: Record) -> float | None:
    p = rec.profile
    return p["kernels"] / p["steps"] if p and p["steps"] else None


def device_idle_pct(rec: Record) -> float | None:
    """The share of the profiled stretch with no operation on the card."""
    p = rec.profile
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def roofline_pct(rec: Record, kernel: str) -> float | None:
    """The least time of the stretch's launches of `kernel` ("rate_sweep",
    K1, or "pack", K2) by `bounds`, over their time in the profiler's trace."""
    p = rec.profile
    if not p:
        return None
    launches = p["launches"].get(kernel, [])
    count, seconds = p["kernel_s"][kernel]
    if not launches or not count or not seconds:
        return None
    if kernel == "rate_sweep":
        least_ms = sum(bounds.sweep_bound(n)[0] for n in launches)
    else:
        least_ms = sum(bounds.pack_bound(F, P, live, cap)[0] for F, P, cap, live in launches)
    return 100.0 * least_ms * 1e-3 / seconds

"""Shared fixtures of the benchmark's tests: a tiny run of a cell on the CPU
(the plain versions of the kernels), and the card for the tests marked
`cuda`, which skip without one."""

from __future__ import annotations

import time

import pytest

from portbench import run, spec

# a cell's traffic at a size a CPU test holds: the same loops, shapes cut
TINY = {
    "corpus": dict(streams_per_job=4, frames_per_step=4, clip_seconds={"law": "uniform", "low": 0.2, "high": 0.5},
                   tracks=2, track_seconds=1.0, profile={"skip_steps": 1, "steps": 2}),
    "pool": dict(lanes=4, frames_per_step=4, arrivals_per_s=6.0, stream_seconds={"law": "exponential", "mean": 0.3},
                 tracks=2, track_seconds=3.0, warm_seconds=0.1, tail_wait_s=30.0, profile={"skip_steps": 1, "steps": 2}),
}


# the live relay's cell, which BENCHMARK.json leaves out until it is measured
# again: the pool loop stays held to the same checks here
LIVE_CELL = {"name": "compat128.live", "config": "compat128", "traffic": "live", "chips": 1, "why": "the pool loop"}
LIVE_METRICS = [
    {"name": n, "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock", "workloads": ["compat128.live"]}
    for n in ("live_frame_p95_ms", "live_frame_p50_ms")
]


def bench_with(*cells: dict, metrics=()) -> dict:
    """BENCHMARK.json with more cells and end-to-end metrics."""
    bench = spec.load_benchmark()
    bench["workloads"] += [dict(c) for c in cells]
    bench["end_to_end"] += [dict(m) for m in metrics]
    return bench


def tiny_run(cell_name: str, seed: int = 2**31 + 11, trace: bool = False, seconds: float = 1.0, bench=None, **kw):
    """One run of a cell on the CPU at TINY's size: (result, lines). The
    live cell is added to the benchmark where it is asked for."""
    if bench is None:
        bench = bench_with(LIVE_CELL, metrics=LIVE_METRICS) if cell_name == LIVE_CELL["name"] else spec.load_benchmark()
    cell = spec.find_cell(bench, cell_name)
    root = kw.get("root") or spec.HERE
    loop = spec.load_mix(cell["traffic"], root)["loop"]
    return run.run_cell(bench, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                        mix_overrides=TINY.get(loop, {}), workers=0, **kw)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

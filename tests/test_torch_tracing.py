"""The port's tracer (`swiftmp3_tpu_torch.utils.profiling`) on the CPU: off,
a span site records nothing and hands back one shared no-op context; on,
the same bytes come out and the port's spans nest as the benchmark reads
them (`batch.step` around the chunk program's phases, `batch.drain` around
the wait and the render), on the clock the profiler's events carry, with
the render's native calls and their busy time counted.

Tiny compat and strict encodes (2 streams, 4 frames a step); nothing here
imports JAX.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest
import torch

from swiftmp3_tpu_torch import MP3EncoderOptions, Mode
from swiftmp3_tpu_torch.parallel.batch import BatchEncoder, _Chunks, _encode_chunks, encode_corpus
from swiftmp3_tpu_torch.parallel.mesh import make_mesh
from swiftmp3_tpu_torch.utils import profiling

torch.set_num_threads(1)

T = 4  # frames a step
PHASES = ("chunk.phase1", "chunk.scalefactors", "chunk.sweep", "chunk.loop_t", "chunk.finalize",
          "chunk.pack", "chunk.carry_out")
SPANS = {"batch.setup", "batch.build", "batch.prepare", "batch.step", "batch.fetch", "batch.drain",
         "drain.wait", "drain.render", "corpus.files", *PHASES}


@pytest.fixture(autouse=True)
def _fresh_tracer():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _streams():
    """Two int16 stereo streams of 6 and 3.1 frames: two steps of 4."""
    rng = np.random.default_rng(16)
    return [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (1152 * 2 * 6, 1152 * 2 * 3 + 100)]


def _compat():
    return MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128, sample_rate=44100)


def _traced(fn, *args, **kwargs):
    profiling.enable()
    try:
        out = fn(*args, **kwargs)
    finally:
        profiling.disable()
    return out, profiling.snapshot()


def _within(inner, outer) -> bool:
    """inner lies inside outer, on the same thread and deeper."""
    return inner[3] == outer[3] and inner[4] > outer[4] and outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(snap, name) -> list:
    return [s for s in snap["spans"] if s[0] == name]


def test_tracing_off_records_nothing_and_annotate_is_the_shared_noop():
    assert not profiling.enabled()
    assert profiling.annotate("batch.step") is profiling.annotate("chunk.sweep")
    encode_corpus(_compat(), _streams(), device="cpu", frames_per_step=T)
    profiling.count("render.busy_ns", 5)
    assert profiling.snapshot() == {"spans": [], "totals": {}, "counters": {}}


def test_tracing_on_gives_the_same_bytes_and_every_span_nested_a_step():
    off = encode_corpus(_compat(), _streams(), device="cpu", frames_per_step=T)
    on, snap = _traced(encode_corpus, _compat(), _streams(), device="cpu", frames_per_step=T)
    assert on == off
    assert {s[0] for s in snap["spans"]} == SPANS
    steps = _named(snap, "batch.step")
    assert len(steps) == 2  # 6 frames at 4 a step
    for name in PHASES + ("batch.fetch",):
        spans = _named(snap, name)
        assert len(spans) == len(steps), name
        assert all(any(_within(s, step) for step in steps) for s in spans), name
    # the phases follow one another inside a step
    for step in steps:
        inner = sorted((s for s in snap["spans"] if s[0] in PHASES and _within(s, step)), key=lambda s: s[1])
        assert [s[0] for s in inner] == list(PHASES)
        assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    drains = _named(snap, "batch.drain")
    for name in ("drain.wait", "drain.render"):
        assert all(any(_within(s, d) for d in drains) for s in _named(snap, name))
    assert snap["totals"]["batch.step"] == [2, sum(s[2] - s[1] for s in steps)]
    # nothing after disable()
    encode_corpus(_compat(), _streams(), device="cpu", frames_per_step=T)
    assert profiling.snapshot()["spans"] == snap["spans"]


def test_a_strict_row_runs_two_loops_over_t_a_step():
    o = MP3EncoderOptions.spec_strict(mode=Mode.JOINT_STEREO, bitrate_kbps=128)
    off = encode_corpus(o, _streams()[:1], device="cpu", frames_per_step=T)
    on, snap = _traced(encode_corpus, o, _streams()[:1], device="cpu", frames_per_step=T)
    assert on == off
    loops, steps = _named(snap, "chunk.loop_t"), _named(snap, "batch.step")
    assert len(loops) == 2 * len(steps) == 4
    # the second, on the actual bits, inside the finalize
    finals = _named(snap, "chunk.finalize")
    assert sum(any(_within(lp, f) for f in finals) for lp in loops) == len(steps)


def test_a_meshs_positions_each_run_their_phases_inside_the_step():
    mesh = make_mesh(["cpu", "cpu"])
    off = encode_corpus(_compat(), _streams(), frames_per_step=T, mesh=mesh)
    on, snap = _traced(encode_corpus, _compat(), _streams(), frames_per_step=T, mesh=mesh)
    assert on == off
    steps = _named(snap, "batch.step")
    for name in PHASES + ("batch.fetch",):
        spans = _named(snap, name)
        assert len(spans) == 2 * len(steps), name
        assert all(any(_within(s, step) for step in steps) for s in spans), name


def test_a_span_encloses_its_ops_on_the_profilers_clock():
    x = torch.arange(4096, dtype=torch.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.enable()
        with profiling.annotate("chunk.sweep"):
            x.cumsum(0)
        profiling.disable()
    (span,) = profiling.snapshot()["spans"]
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::cumsum"]
    assert ops
    for e in ops:
        assert span[1] <= e.start_ns() <= e.end_ns() <= span[2]
    # the span is also a record_function of its name
    assert any(e.name() == "chunk.sweep" for e in prof.profiler.kineto_results.events())


@pytest.mark.parametrize("render_threads", [None, 1], ids=["pool", "serial"])
def test_the_render_counts_its_busy_time_against_its_pool(render_threads):
    o, streams = _compat(), _streams()
    chunks = _Chunks(o, streams, len(streams), T)
    enc = BatchEncoder(o, len(streams), T, "cpu", render_threads=render_threads)
    try:
        _, snap = _traced(_encode_chunks, enc, chunks, chunks.frames, len(streams))
    finally:
        enc.close()
    renders = _named(snap, "drain.render")
    threads = snap["counters"]["render.threads"] / len(renders)  # counted once a render
    assert threads == (1 if render_threads == 1 else min(8, os.cpu_count() or 1))
    busy = snap["counters"]["render.busy_ns"]  # the native calls' time
    assert 0 < busy <= threads * sum(s[2] - s[1] for s in renders)
    # one native call a range of rows, at most one range a thread
    assert snap["counters"]["render.native_calls"] == len(renders) * min(threads, len(streams))


def test_counters_add_up_across_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    try:
        workers = [threading.Thread(target=lambda: [profiling.count("n", 3) for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers)
    finally:
        profiling.disable()
        sys.setswitchinterval(old)
    assert profiling.snapshot()["counters"] == {"n": 16 * 2000 * 3}
    profiling.reset()
    assert profiling.snapshot()["counters"] == {}

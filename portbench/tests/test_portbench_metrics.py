"""The metric arithmetic: the rate over whole jobs, the percentiles over
every frame with the lost ones counted, the per-step span and counter
readings, and the profiled stretch's reduction."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from portbench import readers, spec
from portbench.generator import Job, quantiles
from portbench.readers import Record
from portbench.tracing import reduce_profile


def test_rate_counts_every_job_started_in_the_window_to_the_last_ones_end():
    # the window opened at 10.0; the last job started inside it ends at 17.5
    jobs = [Job(10.0, 12.5, 100.0), Job(12.5, 15.0, 100.0), Job(15.0, 17.5, 100.0)]
    rec = Record(setup_s=1.0, window=(10.0, 17.5), jobs=jobs)
    assert readers.audio_rate(rec) == pytest.approx(300.0 / 7.5)
    assert readers.audio_rate(Record(setup_s=1.0, window=(0.0, 1.0))) is None


def test_percentiles_take_every_frame_and_count_the_lost_at_the_deadline():
    # 90 frames at 10 ms, 10 that never came out, counted at 5000 ms
    rec = Record(setup_s=1.0, window=(0.0, 1.0), latencies_ms=[10.0] * 90 + [5000.0] * 10)
    assert readers.latency_percentile(rec, 50) == 10.0
    assert readers.latency_percentile(rec, 95) == 5000.0
    assert readers.latency_percentile(rec, 95) == np.percentile(rec.latencies_ms, 95)


def test_live_frames_lost_reach_the_percentile():
    """The pool loop counts a frame due in the window that never came out
    as attempted, failed, and a latency at the deadline."""
    pool = spec.load_module("loops", "pool", spec.HERE)
    d = pool.Loop.__new__(pool.Loop)
    d.streams = [pool.LiveStream(0.0, np.zeros(10, np.int16), np.array([1.0, 2.0, 3.0, 9.0]), counted=1)]
    d.latencies, d.attempted, d.failed = [0.1], 0, 0
    d._account(t_end=5.0, deadline=65.0)
    assert (d.attempted, d.failed) == (3, 2)
    assert sorted(d.latencies) == [0.1, 62.0, 63.0]
    assert d.tally({"failed": 0})[:2] == (3, 2)


def test_the_live_schedule_is_one_set_of_gaps_and_durations_in_a_seeded_order():
    """Every seed gets the same gaps and durations; the seed orders them,
    so arrivals bunch as a Poisson schedule's do."""
    from types import SimpleNamespace

    pool = spec.load_module("loops", "pool", spec.HERE)
    mix = spec.load_mix("live")

    def schedule(seed):
        d = pool.Loop.__new__(pool.Loop)
        d.mix, d.seed, d.sr = mix, seed, 44100
        d.options = SimpleNamespace(samples_per_frame=1152)
        return d._schedule(51.0)

    a, b = schedule(2**31 + 1), schedule(2**31 + 2)
    assert a != b and a == schedule(2**31 + 1)
    # the same durations, but for the last arrivals, which the window may cut off
    rate, law = mix["arrivals_per_s"], mix["stream_seconds"]
    every = Counter(round(float(d), 9) for n in (round(rate * law["mean"]), round(rate * 51.0))
                    for d in quantiles(law, n))
    for s in (a, b):
        assert Counter(round(d, 9) for _, d in s) <= every
        assert len(s) >= sum(every.values()) - 3


def test_per_step_readings():
    ms = 1_000_000
    spans = {
        "job": [(0, 100 * ms)],
        "prepare": [(0, 5 * ms), (30 * ms, 35 * ms)],
        "step": [(5 * ms, 25 * ms), (35 * ms, 55 * ms)],
        "drain": [(60 * ms, 70 * ms), (70 * ms, 90 * ms)],
        "profiler": [(90 * ms, 94 * ms)],
        "pool_step": [(0, 40 * ms), (40 * ms, 94 * ms)],
    }
    rec = Record(setup_s=1.0, window=(0.0, 1.0), spans=spans,
                 counters={"valid_frames": 30, "frame_slots": 120}, step_device_ms=[10.0, 14.0])
    assert readers.per_step_ms(rec, "step") == pytest.approx(20.0)
    assert readers.per_step_ms(rec, "drain") == pytest.approx(15.0)
    # 100 - (10 + 40 + 30 + 4) = 16 ms over 2 steps
    assert readers.files_self_ms(rec) == pytest.approx(8.0)
    assert readers.pool_step_ms(rec) == pytest.approx(45.0)
    assert readers.valid_frame_pct(rec) == pytest.approx(25.0)
    assert readers.step_device_ms(rec) == pytest.approx(12.0)
    assert readers.per_step_ms(Record(setup_s=1.0, window=(0, 1)), "step") is None


class _Event:
    def __init__(self, name, kind, start, dur):
        self._v = (name, kind, start, dur)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def test_profile_reduction_busy_idle_kernels_and_rooflines():
    us = 1000
    events = [
        _Event("rate_sweep_kernel(float2 const*, int const*)", "kernel", 0, 400 * us),
        _Event("void at::native::elementwise_kernel<128, 2>", "kernel", 300 * us, 200 * us),  # overlaps
        _Event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1000 * us, 100 * us),
        _Event("pack_kernel(int const*, int const*)", "kernel", 1500 * us, 500 * us),
        _Event("step", "gpu_user_annotation", 0, 2000 * us),  # not device work
        _Event("aten::add", "cpu_op", 0, 5 * us),
    ]
    # a job span still open when the stretch is reduced holds the rest
    host = [("job", 0, None), ("step", 0, 1050 * us), ("drain", 1050 * us, 1600 * us)]
    p = reduce_profile(events, host, steps=2)
    assert p["kernels"] == 3 and p["steps"] == 2
    assert p["busy_s"] == pytest.approx(1100e-6)  # 0-500, 1000-1100, 1500-2000
    assert p["window_s"] == pytest.approx(2000e-6)
    assert p["kernel_s"]["rate_sweep"] == [1, pytest.approx(400e-6)]
    assert p["kernel_s"]["pack"] == [1, pytest.approx(500e-6)]
    # 500-1000, while the host was in step; 1100-1500, in drain
    assert p["idle_gaps"][0] == ["BatchEncoder.step", pytest.approx(500e-6)]
    assert p["idle_gaps"][1] == ["BatchEncoder.drain", pytest.approx(400e-6)]
    only_job = reduce_profile(events, [("job", 0, None)], 2)["idle_gaps"]
    assert [g[0] for g in only_job] == ["encode_corpus outside prepare/step/drain"] * 2
    rec = Record(setup_s=1.0, window=(0, 1), profile=dict(p, launches={"rate_sweep": [1000], "pack": [(64, 1152, 894, 100)]}))
    from portbench import bounds

    assert readers.device_idle_pct(rec) == pytest.approx(45.0)
    assert readers.kernels_per_step(rec) == 1.5
    assert readers.roofline_pct(rec, "rate_sweep") == pytest.approx(100 * bounds.sweep_bound(1000)[0] / 0.4)
    assert readers.roofline_pct(rec, "pack") == pytest.approx(100 * bounds.pack_bound(64, 1152, 100, 894)[0] / 0.5)
    rec.profile["launches"] = {}
    assert readers.roofline_pct(rec, "pack") is None  # nothing launched: nothing to read


def test_quantile_laws_give_every_seed_the_same_work():
    u = quantiles({"law": "uniform", "low": 15.0, "high": 45.0}, 256)
    assert u.min() > 15.0 and u.max() < 45.0 and u.mean() == pytest.approx(30.0)
    e = quantiles({"law": "exponential", "mean": 20.0}, 1000)
    assert e.mean() == pytest.approx(20.0, rel=0.01)
    with pytest.raises(ValueError):
        quantiles({"law": "pareto"}, 3)


def test_every_metric_has_a_reader_that_reads_a_record():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert callable(reader.read), m["name"]

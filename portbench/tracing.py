"""Spans, counters and the profiled stretch of a traced run, taken from
outside the port: for the run's length the public methods below are wrapped
at run time, and no file of the port changes.

- `BatchEncoder.prepare`, `step`, `drain` and `StreamPool.step`: a span on
  the host clock each call (`spans`); around each `BatchEncoder.step`, CUDA
  events on the current stream (`step_device_ms`; over a mesh, the
  current card's); the valid frames and frame slots each step dispatches
  (`counters`).
- `ops.kernels.rate_sweep` and `ops.kernels.pack`, the module attributes
  through which the chunk program calls K1 and K2: inside the profiled
  stretch, the sizes of each launch, from which `bounds` gives its least
  time.
- The profiled stretch: `torch.profiler` over the device alone, from
  `BatchEncoder.step` call `skip` of the window to call `skip + steps`, the
  card synchronised at both ends so the stretch holds exactly those steps'
  work. The trace stays in memory and is reduced at once (`profile`):
  kernels by name, device busy seconds (averaged over the chips used) and
  window seconds, the longest idle gaps with the host span each fell in.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels' names as the trace gives them ("(anonymous namespace)::pack_kernel(int const*, ...)")
KERNEL_NAMES = {"rate_sweep": re.compile(r"(^|[\s:])rate_sweep_kernel\b"),
                "pack": re.compile(r"(^|[\s:])pack_kernel\b")}


class Tracer:
    """Install with `with Tracer(skip, steps, cuda):`; record only while
    `on` is set (the window)."""

    def __init__(self, skip: int, steps: int, cuda: bool, chips: int = 1):
        self.skip, self.steps, self.cuda, self.chips = skip, steps, cuda, chips
        self.on = False
        self.spans: dict[str, list[tuple[int, int]]] = defaultdict(list)  # time.perf_counter_ns
        self.host_ns: list[list] = []  # [name, start, end] on the epoch clock; end None while open
        self.counters: dict[str, int] = defaultdict(int)
        self.events: list = []
        self.launches: dict[str, list] = defaultdict(list)
        self.n_steps = 0
        self.prof = None
        self.profile: dict | None = None

    # --- installing the wrappers ------------------------------------------

    def __enter__(self):
        from swiftmp3_tpu_torch.ops import kernels
        from swiftmp3_tpu_torch.parallel import batch, pool

        be, sp = batch.BatchEncoder, pool.StreamPool
        self._saved = [
            (be, "prepare", be.prepare), (be, "step", be.step), (be, "drain", be.drain),
            (sp, "step", sp.step), (batch, "encode_corpus", batch.encode_corpus),
            (kernels, "rate_sweep", kernels.rate_sweep), (kernels, "pack", kernels.pack),
        ]
        be.prepare = self._span("prepare", be.prepare)
        be.drain = self._span("drain", be.drain)
        be.step = self._step(be.step)
        sp.step = self._span("pool_step", sp.step)
        batch.encode_corpus = self._span("job", batch.encode_corpus)
        kernels.rate_sweep = self._sweep(kernels.rate_sweep)
        kernels.pack = self._pack(kernels.pack)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        if self.prof is not None:
            self._stop()

    def _span(self, name: str, fn):
        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0, span = time.perf_counter_ns(), [name, time.time_ns(), None]
            self.host_ns.append(span)
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans[name].append((t0, time.perf_counter_ns()))
                span[2] = time.time_ns()

        return wrapped

    def _count(self, valid) -> None:
        """The valid frames and frame slots of a step's host-side mask (the
        uploaded copy is never read back: that would wait for the card)."""
        if self.on and isinstance(valid, np.ndarray):
            self.counters["valid_frames"] += int(valid.sum())
            self.counters["frame_slots"] += int(valid.size)

    def _step(self, fn):
        timed = self._span("step", fn)

        def step(enc, pcm, final, valid, lookahead=None):
            if not self.on:
                return fn(enc, pcm, final, valid, lookahead)
            t0 = time.perf_counter_ns()
            if self.n_steps == self.skip + self.steps and self.prof is not None:
                self._stop()
            if self.n_steps == self.skip and self.cuda and self.profile is None:
                self._start()
            if self.n_steps in (self.skip, self.skip + self.steps):
                self.spans["profiler"].append((t0, time.perf_counter_ns()))
            self.n_steps += 1
            self._count(valid)
            if not self.cuda:
                return timed(enc, pcm, final, valid, lookahead)
            import torch

            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = timed(enc, pcm, final, valid, lookahead)
            e1.record()
            self.events.append((e0, e1))
            return out

        return step

    def _sweep(self, fn):
        def rate_sweep(mag, gstart, iso=False):
            if self.prof is not None and mag.is_cuda:
                self.launches["rate_sweep"].append(gstart.numel())
            return fn(mag, gstart, iso=iso)

        return rate_sweep

    def _pack(self, fn):
        def pack(chunks, nbits, cap_bytes):
            if self.prof is not None and chunks.is_cuda:
                F, P = chunks.shape
                self.launches["pack"].append((F, P, cap_bytes, nbits))
            return fn(chunks, nbits, cap_bytes)

        return pack

    # --- the profiled stretch ---------------------------------------------

    def warm(self) -> None:
        """Profile an empty stretch once (at set-up), so the profiler's own
        start-up is not paid inside the window."""
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    def _start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self._stretch_steps = self.n_steps

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.stop()
        steps = self.n_steps - self._stretch_steps
        # the live slots of each K2 launch, now that the stretch is over
        packs = [(F, P, cap, int((nb > 0).sum())) for F, P, cap, nb in self.launches["pack"]]
        self.launches["pack"] = packs
        self.profile = reduce_profile(prof.profiler.kineto_results.events(), self.host_ns, steps, self.chips)
        self.profile["launches"] = dict(self.launches)

    def step_device_ms(self) -> list[float]:
        """Each traced step's device time between its two events (after the
        window: waits for the card)."""
        if not self.events:
            return []
        import torch

        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events]


def reduce_profile(events, host: list, steps: int, chips: int = 1) -> dict:
    """The stretch's device operations reduced to what the readers use:
    `steps`, `kernels` (count), `by_name` {name: [count, seconds]},
    `kernel_s` {K1/K2 key: [count, seconds]}, `busy_s` (the union of each
    card's operations' intervals, summed over the cards and divided by
    `chips`), `window_s` (first start to last end, over all cards),
    `device_ops` (the ten names with the most time) and `idle_gaps` (the ten
    longest gaps, each named by the innermost host span it fell in)."""
    ops = []
    for e in events:
        kind = _activity(e)
        if kind in DEVICE_ACTIVITIES:
            start = e.start_ns()
            card = e.device_index() if chips > 1 else 0
            ops.append((start, start + e.duration_ns(), e.name(), kind, card))
    ops.sort()
    by_name: dict[str, list] = defaultdict(lambda: [0, 0.0])
    kernel_s = {k: [0, 0.0] for k in KERNEL_NAMES}
    n_kernels = 0
    for s, t, name, kind, _ in ops:
        by_name[name][0] += 1
        by_name[name][1] += (t - s) * 1e-9
        if kind == "kernel":
            n_kernels += 1
            for key, pat in KERNEL_NAMES.items():
                if pat.search(name):
                    kernel_s[key][0] += 1
                    kernel_s[key][1] += (t - s) * 1e-9
    by_card = defaultdict(list)
    for s, t, _, _, card in ops:
        by_card[card].append((s, t))
    busy = sum(_union(spans)[0] for spans in by_card.values()) / chips
    _, gaps = _union([(s, t) for s, t, *_ in ops])
    window = (max(t for _, t, *_ in ops) - ops[0][0]) if ops else 0
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_host_at(host, g0), (g1 - g0) * 1e-9] for g0, g1 in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "steps": steps,
        "kernels": n_kernels,
        "by_name": {k: list(v) for k, v in by_name.items()},
        "kernel_s": kernel_s,
        "busy_s": busy * 1e-9,
        "window_s": window * 1e-9,
        "device_ops": [[name[:120], v[1]] for name, v in top],
        "idle_gaps": named,
    }


def _union(spans: list) -> tuple[int, list]:
    """(the nanoseconds covered by the sorted (start, end) spans, the gaps
    between them)."""
    busy, gaps, end = 0, [], None
    for s, t in spans:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy, gaps


def _activity(e) -> str:
    """A trace event's kind: "kernel", "gpu_memcpy", "gpu_memset", or
    another (host work, annotations). Where the event does not say (older
    torch), a device event's kind is read from its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if str(e.device_type()).split(".")[-1] != "CUDA" or getattr(e, "is_user_annotation", lambda: False)():
        return "host"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


# what the host was doing, by the innermost span it was in
HOST_LABELS = {
    "job": "encode_corpus outside prepare/step/drain",
    "pool_step": "StreamPool.step outside step/drain",
    "prepare": "BatchEncoder.prepare",
    "step": "BatchEncoder.step",
    "drain": "BatchEncoder.drain",
}


def _host_at(host: list, t: int) -> str:
    """What the host was doing at time t on the epoch clock: the innermost
    span (the latest to start) holding t, a span still open holding all
    after its start; or the load loop's own work."""
    best = None
    for name, s, e in host:
        if s <= t and (e is None or t <= e) and (best is None or s >= best[1]):
            best = (name, s)
    return HOST_LABELS[best[0]] if best else "the load loop, outside the spans"

"""The pool loop: an open loop of live streams into one `StreamPool` (live
serving). Streams arrive on a schedule on the wall clock whatever the pool
does, with durations from the mix's law; each stream's audio is due in
real time in packets of `packet_ms` and is fed in due order between pool
steps, and the stream is closed when its last packet is due. The window
opens on the steady population (arrivals x mean duration streams) admitted
in its first frame's time with durations from the same law. Over several
chips the pool's lanes are cut over a mesh of them.

Every seed gets the same schedule's parts: the gaps between arrivals are
the quantiles of the exponential law at the mix's rate and the durations
the quantiles of their law, each set in an order drawn from the seed, so
arrivals bunch and thin out as a Poisson schedule's do. The mix's
`knee_arrivals_per_s` records the rate sweep that set its rate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from portbench.check import Output
from portbench.generator import make_audio, quantiles


@dataclass(eq=False)
class LiveStream:
    """One live stream: its schedule and PCM, and what the pool has made of it."""

    start: float  # when it arrives, on the host clock
    pcm: np.ndarray  # int16 interleaved
    due: np.ndarray  # when each frame's last sample is due
    sid: int | None = None
    fed: int = 0  # samples a channel fed
    closed: bool = False
    counted: int = 0  # frames the pool has counted
    output: Output | None = None


class Loop:
    """Open loop of live streams into one StreamPool (module docstring)."""

    with_header = False  # the outputs are the frames alone, as StreamPool.result gives them

    def __init__(self, options, mix: dict, seed: int, devices: list):
        from swiftmp3_tpu_torch.parallel.mesh import make_mesh

        self.options, self.mix, self.seed = options, mix, seed
        self.device = devices[0]
        self.mesh = make_mesh([str(d) for d in devices]) if len(devices) > 1 else None
        self.rng = np.random.default_rng([seed, 2])
        self.ch = options.channels
        self.sr = options.sample_rate
        self.packet = int(round(mix["packet_ms"] * self.sr / 1000))  # samples a channel
        self.audio = self.pool = None
        self.streams: list[LiveStream] = []
        self.latencies: list[float] = []
        self.attempted = self.failed = 0
        self.lateness: list[float] = []

    def setup(self) -> None:
        o, mix = self.options, self.mix
        t0 = time.perf_counter()
        self.audio = make_audio(self.seed, mix["tracks"], mix["track_seconds"], o.sample_rate, o.channels, self.device)
        self.audio_made_s = time.perf_counter() - t0
        from swiftmp3_tpu_torch.parallel.pool import StreamPool

        self.pool = StreamPool(
            o, lanes=mix["lanes"], frames_per_step=mix["frames_per_step"], device=self.device, mesh=self.mesh
        )
        # warm every shape and path of the window: a step, a drain and a
        # recycled lane, on streams fed whole
        n = int(mix["warm_seconds"] * self.sr) * self.ch
        for i in range(2):
            sid = self.pool.submit()
            self.pool.feed(sid, self.audio[i % len(self.audio), :n])
            self.pool.close(sid)
        self.pool.run_until_idle()
        for sid in self.pool.finished():
            self.pool.release(sid)

    def _schedule(self, seconds: float) -> list[tuple[float, float]]:
        """(arrival offset from the window's start, duration) of every
        stream: the steady population first, with the quantiles of the
        duration law for its size, each offset by its own phase within one
        frame so its frames do not all fall due at one instant; then the
        arrivals, whose gaps are the quantiles of the exponential law at the
        mix's rate and whose durations are the quantiles of the duration law
        for their number, each set in an order drawn from the seed."""
        rate, law = self.mix["arrivals_per_s"], self.mix["stream_seconds"]
        order = np.random.default_rng([self.seed, 3])
        n_arr = int(round(rate * seconds))
        n_steady = int(round(rate * law["mean"]))
        frame_s = self.options.samples_per_frame / self.sr
        phases = quantiles({"law": "uniform", "low": 0.0, "high": frame_s}, n_steady)
        steady = [(float(p), float(d)) for p, d in zip(phases, order.permutation(quantiles(law, n_steady)))]
        gaps = order.permutation(quantiles({"law": "exponential", "mean": 1.0 / rate}, n_arr))
        durations = order.permutation(quantiles(law, n_arr))
        arrivals = [(float(t), float(d)) for t, d in zip(np.cumsum(gaps), durations) if t < seconds]
        return sorted(steady + arrivals)

    def _stream(self, start: float, duration: float) -> LiveStream:
        n = max(int(round(duration * self.sr)), 1)
        track_n = self.audio.shape[1] // self.ch
        n = min(n, track_n)
        off = int(self.rng.integers(0, track_n - n + 1))
        track = int(self.rng.integers(0, len(self.audio)))
        spf = self.options.samples_per_frame
        frames = -(-n // spf)
        last = np.minimum((np.arange(frames) + 1) * spf, n) - 1  # last sample of each frame
        due = start + (last // self.packet + 1) * self.packet / self.sr
        return LiveStream(start, self.audio[track, off * self.ch : (off + n) * self.ch], due)

    def window(self, seconds: float) -> tuple[float, float]:
        """Serve until `seconds` have passed and every frame due by then is
        out, or `tail_wait_s` more have passed. Returns the window's (start,
        end) on the host clock."""
        pool = self.pool
        schedule = self._schedule(seconds)
        t0 = time.perf_counter()
        t_end, deadline = t0 + seconds, t0 + seconds + self.mix["tail_wait_s"]
        pending = [self._stream(t0 + a, d) for a, d in schedule]
        nxt = 0
        live: list[LiveStream] = []
        while True:
            now = time.perf_counter()
            while nxt < len(pending) and pending[nxt].start <= now:
                s = pending[nxt]
                s.sid = pool.submit()
                self.lateness.append(now - s.start)
                live.append(s)
                self.streams.append(s)
                nxt += 1
            for s in live:
                if s.closed:
                    continue
                n = len(s.pcm) // self.ch
                due = min(int((now - s.start) * self.sr) // self.packet * self.packet, n)
                if due > s.fed:
                    pool.feed(s.sid, s.pcm[s.fed * self.ch : due * self.ch])
                    s.fed = due
                if s.fed == n:
                    pool.close(s.sid)
                    s.closed = True
            pool.step()
            now = time.perf_counter()
            waiting = False
            for s in live:
                fc = pool.frame_count(s.sid)
                if fc > s.counted:
                    due = s.due[s.counted : fc]
                    self.latencies.extend((now - due[due <= t_end]).tolist())
                    s.counted = fc
                if s.counted < len(s.due) and s.due[s.counted] <= t_end:
                    waiting = True
            finished = set(pool.finished())
            if finished:
                for s in live:
                    if s.sid in finished:
                        s.output = Output(s.pcm, None, pool.result(s.sid))
                        pool.release(s.sid)
                live = [s for s in live if s.output is None]
            if now >= t_end and (not waiting or now >= deadline):
                break
        self._account(t_end, deadline)
        return t0, now

    def _account(self, t_end: float, deadline: float) -> None:
        """Every frame due by t_end is attempted; one that never came out
        fails and counts at the deadline."""
        for s in self.streams:
            in_window = s.due <= t_end
            self.attempted += int(in_window.sum())
            self.failed += int(in_window[s.counted :].sum())
            self.latencies.extend((deadline - s.due[s.counted :][in_window[s.counted :]]).tolist())

    def record(self, rec) -> None:
        rec.latencies_ms = [x * 1e3 for x in self.latencies]

    def notes(self, window: tuple[float, float]) -> list[str]:
        late = max(self.lateness, default=0.0)
        return [f"{len(self.streams)} streams, {self.attempted} frames due; "
                f"generator at most {late * 1e3:.3f} ms late"]

    def outputs(self) -> list[Output]:
        """The streams that finished, each with its whole PCM and the pool's
        result."""
        return [s.output for s in self.streams if s.output is not None]

    def tally(self, verdict: dict) -> tuple[int, int, dict]:
        """Every frame due in the window is attempted; one that never came
        out fails, and is compared on its own (limit 0)."""
        return self.attempted, self.failed, {"frames_never_out": {"value": self.failed, "limit": 0}}

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown()
        self.audio = self.pool = None

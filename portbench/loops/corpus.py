"""The corpus loop: a closed loop of `encode_corpus` jobs, back to back
(catalogue transcoding). Each job is `streams_per_job` clips whose lengths
are the quantiles of the mix's clip law, shuffled by the seed, each a view
of the audio at a seeded offset, with an ID3 tag each. Over several chips
the jobs are encoded over a mesh of them (`parallel.mesh.make_mesh`).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.check import Output
from portbench.generator import Job, make_audio, quantiles


class Loop:
    """Closed loop of `encode_corpus` jobs (module docstring)."""

    with_header = True  # the outputs are whole files: ID3, Xing/Info, frames

    def __init__(self, options, mix: dict, seed: int, devices: list):
        from swiftmp3_tpu_torch.parallel import batch
        from swiftmp3_tpu_torch.parallel.mesh import make_mesh

        self.batch = batch  # encode_corpus is looked up at each call (traced runs wrap it)
        self.options, self.mix, self.seed = options, mix, seed
        self.device = devices[0]
        self.mesh = make_mesh([str(d) for d in devices]) if len(devices) > 1 else None
        self.rng = np.random.default_rng([seed, 1])
        sr, ch = options.sample_rate, options.channels
        self.ch = ch
        secs = quantiles(mix["clip_seconds"], mix["streams_per_job"])
        self.lengths = np.round(secs * sr).astype(np.int64)  # samples a channel
        self.track_n = int(round(mix["track_seconds"] * sr))
        if self.lengths.max() > self.track_n:
            raise ValueError("a clip is longer than the tracks it is cut from")
        self.audio = None
        self.jobs: list[Job] = []

    def setup(self) -> None:
        o = self.options
        t0 = time.perf_counter()
        self.audio = make_audio(
            self.seed, self.mix["tracks"], self.mix["track_seconds"], o.sample_rate, o.channels, self.device
        )
        self.audio_made_s = time.perf_counter() - t0
        # warm every shape and size of the window with one whole job like
        # its own: a job of short clips left the first job of the window
        # 5-60% slower than the rest (on an H100)
        streams, tags, _ = self._job(-1)
        self._encode(streams, tags)

    def _encode(self, streams, tags):
        from swiftmp3_tpu_torch.options import ID3Tag

        tags = [ID3Tag(**t) for t in tags] if tags else None
        return self.batch.encode_corpus(
            self.options, streams, tags=tags, device=self.device,
            frames_per_step=self.mix["frames_per_step"], mesh=self.mesh,
        )

    def _job(self, k: int):
        """Job k's streams (views of the audio) and tags."""
        order = self.rng.permutation(len(self.lengths))
        lengths = self.lengths[order]
        tracks = self.rng.integers(0, len(self.audio), size=len(lengths))
        offsets = (self.rng.random(len(lengths)) * (self.track_n - lengths + 1)).astype(np.int64)
        streams = [
            self.audio[t, o * self.ch : (o + n) * self.ch] for t, o, n in zip(tracks, offsets, lengths)
        ]
        tags = [
            {"title": f"Clip {k}-{i}", "artist": "portbench", "album": f"Job {k}", "track": i + 1}
            for i in range(len(lengths))
        ]
        return streams, tags, float(lengths.sum()) / self.options.sample_rate

    def window(self, seconds: float) -> tuple[float, float]:
        """Run jobs back to back; every job started before `seconds` have
        passed runs to its end. Returns the window's (start, end) on the
        host clock: the end is the last job's."""
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            streams, tags, audio_s = self._job(k)
            start = time.perf_counter()
            files = self._encode(streams, tags)
            job = Job(start, time.perf_counter(), audio_s)
            job.outputs = [Output(s, t, f) for s, t, f in zip(streams, tags, files)]
            self.jobs.append(job)
            k += 1
        return t0, self.jobs[-1].end

    def record(self, rec) -> None:
        rec.jobs = self.jobs

    def notes(self, window: tuple[float, float]) -> list[str]:
        return [f"{len(self.jobs)} jobs in {window[1] - window[0]:.3f} s: "
                + " ".join(f"{j.end - j.start:.3f}" for j in self.jobs)]

    def outputs(self) -> list[Output]:
        return [o for j in self.jobs for o in j.outputs]

    def tally(self, verdict: dict) -> tuple[int, int, dict]:
        """Every file of the window is attempted; one that is missing or
        departs from the reference's structure fails."""
        return len(self.outputs()), verdict["failed"], {}

    def close(self) -> None:
        self.audio = None

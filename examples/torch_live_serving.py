"""Continuous-batching MP3 serving demo on the PyTorch/CUDA port (the
counterpart of examples/live_serving.py).

Simulates a live transcoding service: streams of random lengths arrive over
time (Poisson-ish), feed PCM incrementally, and finish independently while
a fixed set of device lanes stays busy. Prints per-step occupancy and final
throughput. Compare examples/torch_podcast_corpus.py, which encodes a FIXED
cohort in lockstep.

    python examples/torch_live_serving.py [--lanes 32] [--frames-per-step 16]
        [--streams 200] [--seconds-mean 20] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swiftmp3_tpu_torch import MP3EncoderOptions, Mode  # noqa: E402
from swiftmp3_tpu_torch.parallel import StreamPool  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--frames-per-step", type=int, default=16)
    ap.add_argument("--streams", type=int, default=200)
    ap.add_argument("--seconds-mean", type=float, default=20.0)
    ap.add_argument("--arrivals-per-step", type=float, default=4.0)
    ap.add_argument(
        "--sync",
        action="store_true",
        help="disable the one-chunk-deep step pipeline (A/B baseline)",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    opts = MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128)
    sr = opts.sample_rate
    pool = StreamPool(
        opts,
        lanes=args.lanes,
        frames_per_step=args.frames_per_step,
        device=args.device,
        pipelined=not args.sync,
    )
    rng = np.random.default_rng(0)

    def synth(n):
        t = np.arange(n) / sr
        f = rng.uniform(120, 3000)
        sig = rng.uniform(0.2, 0.7) * np.sin(2 * np.pi * f * t)
        sig = (sig * 32767).astype(np.int16)
        return np.repeat(sig[:, None], opts.channels, axis=1).reshape(-1)

    remaining = args.streams
    live = {}  # sid -> pcm iterator (streams feed in ~1 s slices)
    done_ids = []
    total_audio = 0.0
    t0 = time.perf_counter()
    step = 0
    while remaining or live or not pool.idle:
        # arrivals
        n_new = min(remaining, rng.poisson(args.arrivals_per_step))
        for _ in range(n_new):
            seconds = max(1.0, rng.exponential(args.seconds_mean))
            total_audio += seconds
            pcm = synth(int(seconds * sr))
            sid = pool.submit()
            slices = np.array_split(pcm, max(1, int(seconds)))
            live[sid] = iter(slices)
            remaining -= 1
        # each live stream feeds its next ~1 s slice, with back-pressure:
        # streams whose unconsumed backlog exceeds a few chunks skip a turn
        # (a real ingest loop throttles the same way)
        backlog_cap = 4 * args.frames_per_step * 1152 * 2
        finished_feeding = []
        for sid, it in live.items():
            if pool.buffered_samples(sid) > backlog_cap:
                continue
            chunk = next(it, None)
            if chunk is None:
                pool.close(sid)
                finished_feeding.append(sid)
            else:
                pool.feed(sid, chunk)
        for sid in finished_feeding:
            del live[sid]

        pool.step()
        step += 1
        for sid in pool.finished():
            done_ids.append((sid, len(pool.result(sid))))
            pool.release(sid)
        if step % 20 == 0:
            print(
                f"step {step:4d}: lanes busy {pool.busy_lanes}/{args.lanes}, "
                f"finished {len(done_ids)}/{args.streams}",
                file=sys.stderr,
            )

    dt = time.perf_counter() - t0
    mb = sum(n for _, n in done_ids) / 1e6
    print(
        f"{len(done_ids)} streams, {total_audio:.0f}s audio -> {mb:.1f} MB MP3 "
        f"in {dt:.1f}s wall ({total_audio/dt:.0f}x realtime end-to-end)"
    )
    pool.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Batched podcast-corpus encoding on the PyTorch/CUDA port (the counterpart
of examples/podcast_corpus.py).

Encodes N concurrent sessions with per-episode ID3 tags into complete MP3
files, over a mesh of every card (or one device with --device). Synthesizes
speech-like audio if no input directory of WAVs is given.

    python examples/torch_podcast_corpus.py [--streams 1000] [--seconds 30]
        [--outdir /tmp/podcasts] [--wavs DIR] [--device cuda|cpu|cuda:N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swiftmp3_tpu_torch import ID3Tag, MP3EncoderOptions, Mode  # noqa: E402
from swiftmp3_tpu_torch.parallel import encode_corpus, make_mesh  # noqa: E402
from swiftmp3_tpu_torch.utils import read_wav  # noqa: E402


def synth_speechlike(rng, n, sr):
    """Cheap speech-like signal: pitch bursts + amplitude envelope."""
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 220)
    voiced = np.sin(2 * np.pi * f0 * t) + 0.4 * np.sin(2 * np.pi * 2 * f0 * t)
    env = np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t), 0, 1)
    noise = rng.standard_normal(n) * 0.02
    x = (0.4 * voiced * env + noise).astype(np.float32)
    # int16 halves the host->device transfer (the device normalizes by 1/32768)
    return (np.clip(x, -0.99, 0.99) * 32767.0).astype(np.int16)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--streams", type=int, default=1000)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--outdir", default=None)
    p.add_argument("--wavs", default=None, help="directory of input WAVs")
    p.add_argument("--bitrate", type=int, default=128)
    p.add_argument("--frames-per-step", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda: a mesh of every card; else this one device (cpu, cuda:N)")
    args = p.parse_args(argv)

    sr = 44100
    rng = np.random.default_rng(0)

    if args.wavs:
        streams = []
        names = sorted(os.listdir(args.wavs))[: args.streams]
        for name in names:
            pcm, wav_sr, ch = read_wav(os.path.join(args.wavs, name))
            if wav_sr != sr:
                raise ValueError(f"{name}: expected {sr} Hz, got {wav_sr}")
            streams.append(pcm[0::ch] if ch > 1 else pcm)
    else:
        n = int(args.seconds * sr)
        streams = [
            synth_speechlike(rng, n + int(rng.integers(0, sr)), sr)
            for _ in range(args.streams)
        ]

    tags = [
        ID3Tag(title=f"Episode {i:04d}", artist="Corpus", album="Batch")
        for i in range(len(streams))
    ]
    options = MP3EncoderOptions(mode=Mode.MONO, bitrate_kbps=args.bitrate, sample_rate=sr)

    mesh = make_mesh() if args.device == "cuda" else make_mesh([args.device])
    total_audio = sum(len(s) for s in streams) / sr
    print(f"encoding {len(streams)} streams ({total_audio:.0f}s audio) "
          f"on mesh {mesh.shape} of {[str(d) for d in mesh.devices]} ...", file=sys.stderr)
    t0 = time.perf_counter()
    files = encode_corpus(
        options, streams, tags=tags,
        frames_per_step=args.frames_per_step, mesh=mesh,
    )
    dt = time.perf_counter() - t0
    total_bytes = sum(len(f) for f in files)
    print(
        f"done: {total_audio:.0f}s -> {total_bytes/1e6:.1f} MB in {dt:.1f}s "
        f"({total_audio/dt:.0f}x realtime aggregate)",
        file=sys.stderr,
    )

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        for i, blob in enumerate(files):
            with open(os.path.join(args.outdir, f"episode_{i:04d}.mp3"), "wb") as f:
                f.write(blob)
        print(f"wrote {len(files)} files to {args.outdir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The comparison that decides `correct`: the port's outputs of the window
against the frozen golden encoder (`golden/`), fed the same PCM.

Two kinds of number are compared, each against a limit of its own:

- `structure_errors` (limit 0, an exact comparison): outputs of the window
  that are missing, or whose ID3 tag, Xing/Info frame, frame count, frame
  sizes or frame headers differ from what the reference's laws give for
  the stream's length (the session's frame count, the CBR padding law, the
  golden `io` writers). Every output of the window is walked.
- Of a sample of outputs drawn from the seed (`draw_sample`), each encoded
  whole by the golden encoder in worker processes (one BLAS thread each,
  fed through pipes):
  `frames_differing_pct`, the share of frames whose bytes differ from the
  golden's, and `divergences_per_kframe`, the outputs that differ anywhere
  over the frames compared while the two were still equal (up to and
  including each output's first differing frame), a thousand frames: the
  rate at which the port leaves the golden's stream. A configuration's file
  names the numbers it is held to and their limits (`check.limits`), set
  from readings of sound runs and of the lower-precision control; the other
  is printed beside them.

This module imports numpy and the golden copy alone, so the workers it
starts load neither torch nor the port.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
from dataclasses import dataclass

import numpy as np

from .golden.encoder import new_session
from .golden.io.framing import FrameAssembler
from .golden.io.id3 import build_id3_tag
from .golden.io.xing import build_xing_header
from .golden.options import ID3Tag, Mode, MP3EncoderOptions, SAMPLES_PER_GRANULE
from .golden.tables import bitrate_index, bitrate_value, bitrate_value_lsf

MPEG1_RATES = (44100, 48000, 32000)


def build_options(options_cls, mode_cls, cfg: dict):
    """Encoder options of a configuration's file, built with either
    package's classes: `preset` names a classmethod (`hq`, `spec_strict`)
    or is null for the plain constructor; `options` are its keyword
    arguments, `mode` by name."""
    kwargs = dict(cfg["options"])
    if "mode" in kwargs:
        kwargs["mode"] = mode_cls[kwargs["mode"]]
    preset = cfg.get("preset")
    return getattr(options_cls, preset)(**kwargs) if preset else options_cls(**kwargs)


def golden_options(cfg: dict) -> MP3EncoderOptions:
    return build_options(MP3EncoderOptions, Mode, cfg)


def frame_plan(opts: MP3EncoderOptions, n_samples: int) -> list[int] | None:
    """The byte size of each audio frame a session emits for a stream of
    n_samples interleaved samples: the session's count (every whole frame,
    a zero-padded partial one, and under window_sequencing the granule of
    preroll) and the CBR padding law (the golden backend's `_apply_bitrate`).
    None under VBR, whose sizes follow the audio. Free format is not
    walked (`walk_frames`)."""
    if opts.vbr:
        return None
    ch = opts.channels
    n_frame = opts.samples_per_frame * ch
    la = SAMPLES_PER_GRANULE * ch if opts.window_sequencing else 0
    count = -(-(n_samples + la) // n_frame) if n_samples else 0
    sr = opts.sample_rate
    bi = bitrate_index(opts.bitrate_kbps, sr)
    bv = bitrate_value_lsf(bi) if opts.lsf else bitrate_value(bi)
    numerator = (72 if opts.lsf else 144) * bv * 1000
    base, rem = divmod(numerator, sr)
    sizes, acc = [], 0
    for _ in range(count):
        acc += rem
        pad = acc >= sr
        acc -= sr if pad else 0
        sizes.append(base + pad)
    return sizes


def split_id3(data: bytes) -> tuple[bytes, bytes]:
    """(the ID3v2 tag, the rest)."""
    if data[:3] != b"ID3" or len(data) < 10:
        return b"", data
    # the 10-byte header, whose last four bytes are a 28-bit syncsafe length
    size = 10 + sum((data[6 + k] & 0x7F) << (7 * (3 - k)) for k in range(4))
    return data[:size], data[size:]


def walk_frames(data: bytes) -> list[bytes] | None:
    """The Layer III frames of `data` (MPEG-1, 2 and 2.5, not free format),
    each by its header's size; None where a header is malformed or a frame
    runs past the end."""
    frames, pos = [], 0
    while pos < len(data):
        if pos + 4 > len(data):
            return None
        h = int.from_bytes(data[pos : pos + 4], "big")
        if (h >> 21) & 0x7FF != 0x7FF or (h >> 17) & 3 != 1:
            return None
        version = (h >> 19) & 3  # 3 MPEG-1, 2 MPEG-2, 0 MPEG-2.5
        bi, si, pad = (h >> 12) & 15, (h >> 10) & 3, (h >> 9) & 1
        if version == 1 or bi in (0, 15) or si == 3:
            return None
        sr = MPEG1_RATES[si] // {3: 1, 2: 2, 0: 4}[version]
        if version == 3:
            size = 144 * bitrate_value(bi) * 1000 // sr + pad
        else:
            size = 72 * bitrate_value_lsf(bi) * 1000 // sr + pad
        if pos + size > len(data):
            return None
        frames.append(data[pos : pos + size])
        pos += size
    return frames


@functools.lru_cache(maxsize=4096)
def expected_frames(opts: MP3EncoderOptions, n_samples: int):
    """(sizes, offsets, headers, mask) of the audio frames a stream of
    n_samples interleaved samples gives under CBR: `frame_plan`'s sizes,
    each frame's byte offset, and its 4-byte header as the golden assembler
    builds it for its padding, [frames, 4] uint8, with the bits compared
    (under joint stereo the two mode_extension bits follow the audio)."""
    sizes = frame_plan(opts, n_samples)
    assembler = FrameAssembler(opts)
    bi = bitrate_index(opts.bitrate_kbps, opts.sample_rate)
    base = min(sizes, default=0)
    want = np.array([list(assembler._build_header(bi, p, 0)) for p in (0, 1)], dtype=np.uint8)
    headers = want[np.asarray(sizes, dtype=np.int64) - base]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    mask = np.array([0xFF, 0xFF, 0xFF, 0xCF if opts.mode == Mode.JOINT_STEREO else 0xFF], dtype=np.uint8)
    return sizes, offsets, headers, mask


def structure_error(opts: MP3EncoderOptions, n_samples: int, data: bytes | None, tag=None, with_header=False) -> bool:
    """True where `data`, the port's output for a stream of n_samples
    interleaved samples, is missing or departs from the reference's laws: with
    with_header, [ID3 `tag`][Xing/Info][frames] as `encode_corpus` writes a
    file; without, the frames alone as `StreamPool.result` returns them.
    The frames' count, sizes and headers are compared (under VBR, whose
    sizes follow the audio, only that every frame parses)."""
    if data is None:
        return True
    rest = data
    if with_header:
        id3, rest = split_id3(data)
        if id3 != (build_id3_tag(ID3Tag(**tag)) if tag else b""):
            return True
    if opts.vbr:
        return walk_frames(rest) is None
    sizes, offsets, headers, mask = expected_frames(opts, n_samples)
    if with_header:
        xing = build_xing_header(opts, len(sizes), sum(sizes), sizes)
        if rest[: len(xing)] != xing:
            return True
        rest = rest[len(xing) :]
    if len(rest) != sum(sizes):
        return True
    if not sizes:
        return False
    got = np.frombuffer(rest, dtype=np.uint8)[offsets[:, None] + np.arange(4)]
    return bool(np.any((got & mask) != (headers & mask)))


def golden_bytes(task: tuple) -> bytes:
    """The golden encoder's output for one stream: (configuration, int16
    interleaved PCM, ID3 fields or None, with_header). Run in a worker."""
    cfg, pcm, tag, with_header = task
    opts = golden_options(cfg)
    s = new_session(opts)
    audio = s.encode(pcm) + s.flush()
    if not with_header:
        return audio
    id3 = build_id3_tag(ID3Tag(**tag)) if tag else b""
    return id3 + s.generate_xing_header() + audio


def compare_frames(port: bytes, golden: bytes, with_header: bool) -> tuple[int, int, int]:
    """(frames whose bytes differ, frames of the golden output, frames up to
    and including the first that differs, or all where none does), position
    by position; a missing or extra frame differs, and so does a differing
    ID3 tag or Xing/Info frame (as one frame each, the tag first)."""
    a, b = walk_frames(port) or [], walk_frames(golden) or []
    if with_header:
        a_id3, port = split_id3(port)
        b_id3, golden = split_id3(golden)
        a, b = [a_id3] + (walk_frames(port) or []), [b_id3] + (walk_frames(golden) or [])
    n = max(len(a), len(b))
    differs = [i >= len(a) or i >= len(b) or a[i] != b[i] for i in range(n)]
    first = differs.index(True) + 1 if any(differs) else len(b)
    return sum(differs), len(b), first


@dataclass
class Output:
    """One output of the window and what produced it: the stream's int16
    interleaved PCM (a view), its ID3 fields, and the port's bytes (None
    where the port gave none)."""

    pcm: np.ndarray
    tag: dict | None
    data: bytes | None


def draw_sample(outputs: list[Output], cfg: dict, seed: int) -> list[int]:
    """Indices of the outputs the golden encoder checks whole, drawn from
    the seed. With `strata` n in the configuration's check, the outputs
    sorted by length are cut into n runs of (nearly) equal count and one is
    drawn from each, so the sample spans the whole length law and always
    holds one of the longest streams; otherwise outputs are taken in random
    order until `golden_frames` frames are taken (at least one output)."""
    check = cfg["check"]
    rng = np.random.default_rng([seed, 0x636865636B])
    if "strata" in check:
        have = sorted((len(o.pcm), i) for i, o in enumerate(outputs) if o.data is not None)
        runs = np.array_split(np.array([i for _, i in have], dtype=np.int64), min(check["strata"], len(have)) or 1)
        return [int(r[rng.integers(len(r))]) for r in runs if len(r)]
    opts = golden_options(cfg)
    n_frame = opts.samples_per_frame * opts.channels
    chosen, total = [], 0
    for i in rng.permutation(len(outputs)).tolist():
        if outputs[i].data is None:
            continue
        n = -(-len(outputs[i].pcm) // n_frame) + 1
        if chosen and total + n > check["golden_frames"]:
            continue
        chosen.append(i)
        total += n
    return chosen


def run_golden(tasks: list[tuple], workers: int) -> list[bytes]:
    """golden_bytes of each task, in up to `workers` processes (`python -m
    portbench.check`, one BLAS thread each, the longest tasks spread first),
    each fed its tasks and returning its bytes through pipes; or in this
    process with workers=0."""
    if workers == 0 or not tasks:
        return [golden_bytes(t) for t in tasks]
    bins = [[] for _ in range(min(workers, len(tasks)))]
    load = [0] * len(bins)
    for i in sorted(range(len(tasks)), key=lambda i: -len(tasks[i][1])):
        k = load.index(min(load))
        bins[k].append(i)
        load[k] += len(tasks[i][1])
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-m", "portbench.check"], stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, env=env, cwd=repo)
        for _ in bins
    ]
    try:
        for proc, b in zip(procs, bins):
            proc.stdin.write(pickle.dumps([tasks[i] for i in b]))
            proc.stdin.close()
        out = [b""] * len(tasks)
        for proc, b in zip(procs, bins):
            results = pickle.loads(proc.stdout.read())  # bytes this module's workers wrote
            if proc.wait() != 0:
                raise RuntimeError(f"a golden worker exited with {proc.returncode}")
            for i, r in zip(b, results):
                out[i] = r
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def compare(outputs: list[Output], cfg: dict, seed: int, with_header: bool, workers: int) -> dict:
    """The numbers compared, each {"value", "limit"}, the others ("info"),
    and how many outputs failed: every output walked for structure, the
    drawn sample encoded by the golden encoder and compared frame by
    frame."""
    opts = golden_options(cfg)
    failed = sum(
        structure_error(opts, len(o.pcm), o.data, o.tag, with_header) for o in outputs
    )
    sample = draw_sample(outputs, cfg, seed)
    goldens = run_golden(
        [(_plain(cfg), np.ascontiguousarray(outputs[i].pcm), outputs[i].tag, with_header) for i in sample],
        workers,
    )
    diff = total = diverged = in_sync = 0
    for i, g in zip(sample, goldens):
        d, n, first = compare_frames(outputs[i].data, g, with_header)
        diff, total, diverged, in_sync = diff + d, total + n, diverged + (d > 0), in_sync + first
    numbers = {
        "frames_differing_pct": 100.0 * diff / total if total else 100.0,
        "divergences_per_kframe": 1000.0 * diverged / in_sync if in_sync else 1000.0,
    }
    limits = cfg["check"]["limits"]
    checks = {"structure_errors": {"value": failed, "limit": 0}}
    checks.update({name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()})
    return {
        "failed": failed,
        "sampled": len(sample),
        "sampled_frames": total,
        "info": {k: v for k, v in numbers.items() if k not in limits},
        "checks": checks,
    }


def _plain(cfg: dict) -> dict:
    """The configuration's file without the BENCHMARK.json entry (sent to
    workers)."""
    return {k: v for k, v in cfg.items() if k != "entry"}


if __name__ == "__main__":
    # a golden worker of run_golden: its tasks on stdin, their bytes on stdout
    pickle.dump([golden_bytes(t) for t in pickle.load(sys.stdin.buffer)], sys.stdout.buffer)

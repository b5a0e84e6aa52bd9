"""The one traffic generator: the seeded audio every cell encodes, the laws
a mix's sizes are drawn from, and the load loops a mix's `loop` key names.

A loop is found by name: `loops/<name>.py` under the benchmark's root,
loaded by its path (`spec.load_loop`), defines `Loop`, which run.py drives
through this interface alone, so a loop of a new kind is a new file:

- `Loop(options, mix, seed, devices)`: the port's encoder options, the
  mix's parameters, the run's seed, and one torch.device a chip of the cell
  (over several, the loop spreads its work with a mesh of them);
- `setup()`: make the audio (timing it as `audio_made_s`) and warm every
  shape the window uses;
- `window(seconds) -> (start, end)`: the load on the host clock;
- `record(rec)`: put the window's readings on the `readers.Record`;
- `notes(window) -> [str]`: lines for standard error;
- `outputs() -> [check.Output]` and `with_header` (whether they are whole
  files);
- `tally(verdict) -> (attempted, failed, checks)`: the result's counts from
  the comparison's verdict, and any numbers of the loop's own to compare
  ({name: {"value", "limit"}});
- `close()`: free the port's state.

Every seed gets the same work: sizes are a fixed set of quantiles of their
law (`quantiles`), which the seed orders. The seed makes the audio and
picks each stream's track and offset. The audio is made at set-up on the
device from the seed (`make_audio`), in a few large calls; nothing is made
inside the window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def quantiles(law: dict, n: int) -> np.ndarray:
    """The n mid-quantiles (i + 0.5) / n of `law`: {"law": "uniform", "low",
    "high"} or {"law": "exponential", "mean"}."""
    q = (np.arange(n) + 0.5) / n
    if law["law"] == "uniform":
        return law["low"] + (law["high"] - law["low"]) * q
    if law["law"] == "exponential":
        return -law["mean"] * np.log1p(-q)
    raise ValueError(f"unknown law {law['law']!r}")


def make_audio(seed: int, tracks: int, seconds: float, sample_rate: int, channels: int, device) -> np.ndarray:
    """`tracks` seeded int16 tracks of `seconds`, interleaved, [tracks,
    samples * channels] on the host: bench.py's audio model (three tones with
    a seeded level, and noise coloured by seven feed-forward taps at 0.05 of
    full scale) with a seeded pitch and phase a track, and each channel its
    own level and partly its own noise, so joint stereo has sides to code.
    Made on `device` with a torch.Generator seeded by `seed`."""
    import torch

    n = int(round(seconds * sample_rate))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float64)

    t = torch.arange(n, device=device, dtype=torch.float64) / sample_rate
    freqs = torch.tensor([220.0, 467.0, 1313.0], device=device, dtype=torch.float64)
    amps = torch.tensor([0.35, 0.2, 0.1], device=device, dtype=torch.float64)
    pitch = 0.8 + 0.45 * uniform(tracks, 1, 1)
    phase = 2 * math.pi * uniform(tracks, 3, 1)
    base = torch.zeros((tracks, n), device=device, dtype=torch.float32)
    for k in range(3):  # a tone at a time keeps the float64 phase small
        arg = 2 * math.pi * freqs[k] * pitch[:, 0] * t[None, :] + phase[:, k]
        base += (amps[k] * torch.sin(arg)).to(torch.float32)
    noise = torch.randn((tracks, channels + 1, n), generator=gen, device=device)
    for i in range(1, 8):
        noise[..., i:] += noise[..., :-i] / (i + 1)
    noise *= 0.05 / noise.abs().amax(dim=-1, keepdim=True)
    level = (0.5 + 0.5 * uniform(tracks, channels, 1)).to(torch.float32)
    sig = base[:, None, :] * level + 0.6 * noise[:, 1:, :] + 0.4 * noise[:, :1, :]
    pcm = (sig.clamp(-0.99, 0.99) * 32767).to(torch.int16)
    return pcm.transpose(1, 2).reshape(tracks, n * channels).cpu().numpy()


@dataclass
class Job:
    """A corpus job of the window: its span on the host clock, audio seconds
    and outputs."""

    start: float
    end: float
    audio_s: float
    outputs: list = field(default_factory=list)

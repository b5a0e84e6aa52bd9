"""Freeze the reference streams the port's hq and strict tests hold it to.

    JAX_PLATFORMS=cpu python -m tests.torch_freeze_fixtures

Run once on the CPU, from the repository root; no test runs it (it compiles
the JAX hq chunk program, which the fast tier never does). It writes under
tests/fixtures/torch/:

- golden_<preset>_<stem>.mp3: the golden numpy backend's streams under each
  hq configuration (tests/torch_inputs.HQ_OPTIONS) for the hq fixture rows
  and the telemetry corpus (torch_inputs.hq_streams);
- jax_<preset>_<stem>.mp3: the JAX backend's bytes for the same;
- jax_<name>.mp3: the JAX backend's bytes for torch_inputs.STRICT_EXTRA_ROWS;
- checkpoint_jax_<preset>.npz and checkpoint_port_<preset>.npz: the session
  state of each package in the middle of torch_inputs.HQ_CHECKPOINT's stream.
  Before writing them it checks that the JAX backend resumed from the port's
  checkpoint gives the bytes of the stream encoded without a break.

It prints, for every frozen JAX stream, how many frames the port's CPU
session encodes differently (the port's tests hold it to these files).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu.options import Mode
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.options import MP3EncoderOptions

from . import torch_inputs as ti
from .util import parse_frames


def hq_options(preset: str):
    """(port options, JAX options) of an hq preset."""
    kw = ti.HQ_OPTIONS[preset]
    return MP3EncoderOptions.hq(**kw), JaxOptions.hq(**dict(kw, mode=Mode(kw["mode"])))


def extra_options(kw: dict, preset):
    """(port options, JAX options) of a STRICT_EXTRA_ROWS row."""
    jkw = dict(kw, mode=Mode(kw["mode"]))
    if preset == "spec_strict":
        return MP3EncoderOptions.spec_strict(**kw), JaxOptions.spec_strict(**jkw)
    return MP3EncoderOptions(**kw), JaxOptions(**jkw)


def encode(session, pcm) -> bytes:
    return session.encode(pcm) + session.flush()


def frame_flips(got: bytes, ref: bytes) -> str:
    fg, fr = parse_frames(got), parse_frames(ref)
    if [f.size for f in fg] != [f.size for f in fr]:
        return "structure differs"
    bad = [i for i, (a, b) in enumerate(zip(fg, fr))
           if got[a.offset : a.offset + a.size] != ref[b.offset : b.offset + b.size]]
    return f"{len(bad)}/{len(fr)} frames differ (first {bad[:1]})"


def write(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)
    print(f"wrote {os.path.relpath(path)} ({len(data)} bytes)", flush=True)


def freeze_checkpoints() -> None:
    stem, preset, cut = ti.HQ_CHECKPOINT
    o, jo = hq_options(preset)
    pcm = ti.hq_streams()[stem]
    with open(ti.jax_path(f"{preset}_{stem}"), "rb") as fh:
        whole = fh.read()
    js = EncoderSession(jo, backend="tpu")
    head = js.encode(pcm[:cut])
    jax_state = js.state_dict()
    assert head + encode(js, pcm[cut:]) == whole
    port = new_session(o, "cpu")
    port_head = port.encode(pcm[:cut])
    port_state = port.state_dict()
    assert port_head == head, "the port and the JAX backend differ before the cut"
    resumed = EncoderSession(jo, backend="tpu")
    resumed.load_state_dict(port_state)
    assert head + encode(resumed, pcm[cut:]) == whole, (
        "the JAX backend resumed from the port's checkpoint differs from the unbroken stream"
    )
    for side, state in (("jax", jax_state), ("port", port_state)):
        path = ti.checkpoint_path(side)
        ti.save_session_state(path, state, head_len=len(head))
        print(f"wrote {os.path.relpath(path)}", flush=True)


def main() -> None:
    torch.set_num_threads(1)
    os.makedirs(ti.TORCH_FIXTURE_DIR, exist_ok=True)
    streams = ti.hq_streams()
    for preset in ti.HQ_OPTIONS:
        o, jo = hq_options(preset)
        for stem, pcm in streams.items():
            write(ti.golden_path(stem, preset), encode(EncoderSession(jo, backend="numpy"), pcm))
            ref = encode(EncoderSession(jo, backend="tpu"), pcm)
            write(ti.jax_path(f"{preset}_{stem}"), ref)
            print(f"  port: {frame_flips(encode(new_session(o, 'cpu'), pcm), ref)}", flush=True)
    for name, kw, preset, kind, seconds, seed in ti.STRICT_EXTRA_ROWS:
        o, jo = extra_options(kw, preset)
        pcm = ti.make_signal(kind, seconds, o.sample_rate, o.channels, seed)
        ref = encode(EncoderSession(jo, backend="tpu"), pcm)
        write(ti.jax_path(name), ref)
        print(f"  port: {frame_flips(encode(new_session(o, 'cpu'), pcm), ref)}", flush=True)
    freeze_checkpoints()


if __name__ == "__main__":
    main()

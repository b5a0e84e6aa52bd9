"""Freeze the reference streams the port's hq, strict, pool and CLI tests
hold it to.

    JAX_PLATFORMS=cpu python -m tests.torch_freeze_fixtures [part ...]

Run once on the CPU, from the repository root; no test runs it (it compiles
JAX hq chunk programs, which the fast tier never does). The parts are hq,
strict, checkpoint, flags, depth_checkpoint, corpus, cli, dc, is, lsf, ff
mesh and entry (all when none is named). It writes under tests/fixtures/torch/:

- golden_<preset>_<stem>.mp3: the golden numpy backend's streams under each
  hq configuration (tests/torch_inputs.HQ_OPTIONS) for the hq fixture rows
  and the telemetry corpus (torch_inputs.hq_streams);
- jax_<preset>_<stem>.mp3: the JAX backend's bytes for the same;
- jax_<name>.mp3: the JAX backend's bytes for torch_inputs.STRICT_EXTRA_ROWS;
- checkpoint_jax_<preset>.npz and checkpoint_port_<preset>.npz: the session
  state of each package in the middle of torch_inputs.HQ_CHECKPOINT's stream.
  Before writing them it checks that the JAX backend resumed from the port's
  checkpoint gives the bytes of the stream encoded without a break;
- golden_<preset>_<stem>.mp3 and jax_<preset>_<stem>.mp3 for each preset of
  torch_inputs.HQ_FLAG_OPTIONS on torch_inputs.hq_flag_streams(preset);
- checkpoint_jax_<preset>.npz and checkpoint_port_<preset>.npz in the middle
  of torch_inputs.DEPTH_CHECKPOINT's stream (reservoir depth 3), checked as
  above;
- jax_corpus_file0.mp3: the JAX package's encode_corpus file of the first
  of torch_inputs.corpus_streams();
- jax_cli.mp3: the JAX command line's output for torch_inputs.CLI_ARGS on a
  WAV of torch_inputs.cli_pcm();
- golden_<preset>_<stem>.mp3 and jax_<preset>_<stem>.mp3 for each preset of
  torch_inputs.DC_IS_OPTIONS on torch_inputs.dc_is_streams(preset): part dc
  (distortion control), part is (intensity stereo);
- jax_<row>.mp3 for each row of torch_inputs.LSF_ROWS (part lsf) and
  torch_inputs.FF_ROWS (part ff), jax_<row>_step7.mp3 the JAX package's
  encode_batch bytes of the row at torch_inputs.ODD_STEP frames a step, and
  with part lsf checkpoint_jax_<row>.npz
  and checkpoint_port_<row>.npz in the middle of torch_inputs.LSF_CHECKPOINT's
  row, checked as above;
- jax_mesh_<set>_<i>.mp3: the JAX package's encode_batch over its 8-position
  CPU mesh of each stream of each set of torch_inputs.MESH_OPTIONS (part
  mesh), and jax_multihost_<dtype>.mp3 its single-process
  encode_batch_multihost of each of torch_inputs.multihost_streams(). The
  module sets --xla_force_host_platform_device_count=8 before JAX starts;
- jax_entry.npz (torch_inputs.ENTRY_FIXTURE, part entry): the fetched
  outputs and new carry of __graft_entry__.entry()'s step, and of both steps
  of the JAX dry run (__graft_entry__.py:112-198, its inputs drawn as it
  draws them) over each of torch_inputs.ENTRY_DRYRUN_POSITIONS of the
  virtual CPU devices, batch 2 a device.

It prints, for every frozen JAX stream, how many frames the port's CPU
session encodes differently (the port's tests hold it to these files).
"""

from __future__ import annotations

import os
import sys
import tempfile

# The mesh part runs the JAX package over 8 virtual CPU devices, as
# tests/conftest.py sets them; XLA reads the flag when its CPU client starts.
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__ as jentry
import swiftmp3_tpu.utils as jutils
from swiftmp3_tpu.cli import main as jax_cli
from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.models import pipeline as jpipe
from swiftmp3_tpu.options import ID3Tag as JaxID3Tag
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu.options import Mode
from swiftmp3_tpu.parallel import encode_batch, encode_batch_multihost, encode_corpus, make_mesh
from swiftmp3_tpu.parallel.mesh import DATA_AXIS
from swiftmp3_tpu.utils.wav import write_wav
from swiftmp3_tpu_torch import graft_entry
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.options import MP3EncoderOptions
from swiftmp3_tpu_torch.parallel import encode_batch as encode_batch_port

from . import torch_inputs as ti


def hq_options(preset: str):
    """(port options, JAX options) of a preset of HQ_OPTIONS, HQ_FLAG_OPTIONS
    (hq) or DC_IS_OPTIONS."""
    if preset in ti.DC_IS_OPTIONS:
        return ti.dc_is_options(preset, MP3EncoderOptions), ti.dc_is_options(preset, JaxOptions, Mode)
    kw = {**ti.HQ_OPTIONS, **ti.HQ_FLAG_OPTIONS}[preset]
    return MP3EncoderOptions.hq(**kw), JaxOptions.hq(**dict(kw, mode=Mode(kw["mode"])))


def extra_options(kw: dict, preset):
    """(port options, JAX options) of a STRICT_EXTRA_ROWS row."""
    jkw = dict(kw, mode=Mode(kw["mode"]))
    if preset == "spec_strict":
        return MP3EncoderOptions.spec_strict(**kw), JaxOptions.spec_strict(**jkw)
    return MP3EncoderOptions(**kw), JaxOptions(**jkw)


def encode(session, pcm) -> bytes:
    return session.encode(pcm) + session.flush()


def frame_flips(got: bytes, ref: bytes, free_kbps: int | None = None) -> str:
    fg, fr = ti.walk_frames(got, free_kbps), ti.walk_frames(ref, free_kbps)
    if [f["size"] for f in fg] != [f["size"] for f in fr]:
        return "structure differs"
    bad = [i for i, (a, b) in enumerate(zip(fg, fr))
           if got[a["offset"] : a["offset"] + a["size"]] != ref[b["offset"] : b["offset"] + b["size"]]]
    return f"{len(bad)}/{len(fr)} frames differ (first {bad[:1]})"


def write(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)
    print(f"wrote {os.path.relpath(path)} ({len(data)} bytes)", flush=True)


def freeze_checkpoints(checkpoint=ti.HQ_CHECKPOINT, streams=ti.hq_streams) -> None:
    stem, preset, cut = checkpoint
    freeze_checkpoint(*hq_options(preset), streams()[stem], f"{preset}_{stem}", cut, preset)


def freeze_checkpoint(o, jo, pcm, whole_stem: str, cut: int, name: str) -> None:
    """Both packages' session checkpoints at sample `cut` of pcm, whose JAX
    stream is frozen as jax_<whole_stem>.mp3, as checkpoint_<side>_<name>.npz."""
    with open(ti.jax_path(whole_stem), "rb") as fh:
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
        path = ti.checkpoint_path(side, name)
        ti.save_session_state(path, state, head_len=len(head))
        print(f"wrote {os.path.relpath(path)}", flush=True)


def freeze_presets(presets, streams_of) -> None:
    """Golden and JAX-backend streams of each preset on its inputs."""
    for preset in presets:
        o, jo = hq_options(preset)
        for stem, pcm in streams_of(preset).items():
            write(ti.golden_path(stem, preset), encode(EncoderSession(jo, backend="numpy"), pcm))
            ref = encode(EncoderSession(jo, backend="tpu"), pcm)
            write(ti.jax_path(f"{preset}_{stem}"), ref)
            print(f"  port: {frame_flips(encode(new_session(o, 'cpu'), pcm), ref)}", flush=True)


def freeze_strict() -> None:
    for name, kw, preset, kind, seconds, seed in ti.STRICT_EXTRA_ROWS:
        o, jo = extra_options(kw, preset)
        pcm = ti.make_signal(kind, seconds, o.sample_rate, o.channels, seed)
        ref = encode(EncoderSession(jo, backend="tpu"), pcm)
        write(ti.jax_path(name), ref)
        print(f"  port: {frame_flips(encode(new_session(o, 'cpu'), pcm), ref)}", flush=True)


def freeze_rows(rows) -> None:
    """The JAX backend's bytes of each row of LSF_ROWS or FF_ROWS."""
    for row in rows:
        o = ti.lsf_row_options(row, MP3EncoderOptions)
        jo = ti.lsf_row_options(row, JaxOptions, Mode)
        pcm = ti.lsf_row_pcm(row)
        ref = encode(EncoderSession(jo, backend="tpu"), pcm)
        write(ti.jax_path(row), ref)
        free = o.bitrate_kbps if o.free_format else None
        print(f"  port: {frame_flips(encode(new_session(o, 'cpu'), pcm), ref, free)}", flush=True)
        odd = encode_batch(jo, [pcm], frames_per_step=ti.ODD_STEP)[0]
        write(ti.jax_path(f"{row}_step{ti.ODD_STEP}"), odd)
        port_odd = encode_batch_port(o, [pcm], "cpu", frames_per_step=ti.ODD_STEP)[0]
        print(f"  vs the session: {frame_flips(odd, ref, free)}; port: "
              f"{frame_flips(port_odd, odd, free)}", flush=True)


def freeze_lsf() -> None:
    freeze_rows(ti.LSF_ROWS)
    row, cut = ti.LSF_CHECKPOINT
    freeze_checkpoint(
        ti.lsf_row_options(row, MP3EncoderOptions), ti.lsf_row_options(row, JaxOptions, Mode),
        ti.lsf_row_pcm(row), row, cut, row,
    )


def freeze_corpus() -> None:
    kw = ti.CORPUS_OPTIONS
    jo = JaxOptions(**dict(kw, mode=Mode(kw["mode"])))
    tags = [JaxID3Tag(title=t, artist=a) for t, a in ti.CORPUS_TAGS]
    files = encode_corpus(jo, ti.corpus_streams(), tags=tags, frames_per_step=4)
    write(ti.jax_path("corpus_file0"), files[0])


def freeze_cli() -> None:
    _, seconds, sr, channels, _ = ti.CLI_SIGNAL
    with tempfile.TemporaryDirectory() as d:
        wav, out = os.path.join(d, "in.wav"), os.path.join(d, "out.mp3")
        write_wav(wav, ti.cli_pcm(), sr, channels)
        assert jax_cli([wav, out, *ti.CLI_ARGS]) == 0
        with open(out, "rb") as fh:
            write(ti.jax_path("cli"), fh.read())


def freeze_mesh() -> None:
    """The JAX package's encode_batch over its 8-position CPU mesh for each
    set of torch_inputs.mesh_streams, and its single-process
    encode_batch_multihost of each of torch_inputs.multihost_streams."""
    mesh = make_mesh()
    assert mesh.devices.size == 8, mesh.devices.size
    for name, (factory, kw) in ti.MESH_OPTIONS.items():
        o = ti.build_options(factory, kw, MP3EncoderOptions)
        jo = ti.build_options(factory, kw, JaxOptions, Mode)
        streams = ti.mesh_streams(name)
        got = encode_batch(jo, streams, frames_per_step=ti.MESH_STEP, mesh=mesh)
        port = encode_batch_port(o, streams, "cpu", frames_per_step=ti.MESH_STEP)
        for i, data in enumerate(got):
            write(ti.jax_path(f"mesh_{name}_{i}"), data)
            if data:
                print(f"  port: {frame_flips(port[i], data)}", flush=True)
    factory, kw = ti.MESH_OPTIONS["mono"]
    jo = ti.build_options(factory, kw, JaxOptions, Mode)
    for name, pcm in ti.multihost_streams().items():
        write(ti.jax_path(f"multihost_{name}"),
              encode_batch_multihost(jo, [pcm], frames_per_step=ti.MESH_STEP)[0])


def _jax_dryrun(n: int) -> dict:
    """Both steps of the JAX dry run over the first n virtual CPU devices
    (the body of __graft_entry__.py:112-198, its outputs kept):
    {step: (fetched outputs, new carry)}."""
    mesh = make_mesh(jax.devices()[:n])
    sh = NamedSharding(mesh, P(DATA_AXIS))
    T, B = 2, 2 * n
    final = jax.device_put(np.zeros((B, T), dtype=bool), sh)
    valid = jax.device_put(np.ones((B, T), dtype=bool), sh)

    def step(jo, pcm, la=None):
        carry = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), jpipe.init_carry(B, jo))
        args = (carry, jax.device_put(pcm, sh), final, valid)
        if la is not None:
            args += (jax.device_put(la, sh),)
        carry, outs = jax.jit(jpipe.make_chunk_fn(jo))(*args)
        return jpipe.fetch_outputs(outs, jo), {k: np.asarray(v) for k, v in carry.items()}

    jo = JaxOptions(mode=Mode.JOINT_STEREO, vbr=True, quality=3)
    n_pcm = 1152 * jo.channels
    rng = np.random.default_rng(1)
    got = {"vbr": step(jo, (rng.standard_normal((B, T, n_pcm)) * 0.4).astype(np.float32))}
    md = got["vbr"][0]["main_data"]
    assert md.shape == (B, T, jpipe.main_data_cap(jo)), md.shape
    assert bool(np.all(got["vbr"][1]["slot_fifo"][:, -1] > 0))
    pcm_s = (rng.standard_normal((B, T, n_pcm)) * 0.1).astype(np.float32)
    pcm_s[:, :, 400:900] *= 8.0
    la_n = n_pcm // 2
    la_s = np.zeros((B, T, la_n), dtype=np.float32)
    la_s[:, :-1] = pcm_s[:, 1:, :la_n]
    got["hq"] = step(JaxOptions.hq(mode=Mode.JOINT_STEREO), pcm_s, la_s)
    for outputs, _ in got.values():
        assert np.all(outputs["part23"] >= 0) and np.all(outputs["hb"] <= outputs["main_data"].shape[-1])
    return got


def freeze_entry() -> None:
    """__graft_entry__.entry()'s step and the JAX dry run at each of
    torch_inputs.ENTRY_DRYRUN_POSITIONS, in one file; prints the frames the
    port's CPU runs differ in."""
    jutils.enable_compilation_cache = lambda *args, **kwargs: None  # keep this process's cache
    fn, args = jentry.entry()
    carry, outs = jax.jit(fn)(*args)
    jo = JaxOptions(mode=Mode.STEREO, bitrate_kbps=128)
    outputs = jpipe.fetch_outputs(outs, jo)
    arrays = ti.entry_arrays("entry", outputs, {k: np.asarray(v) for k, v in carry.items()})
    tfn, targs = graft_entry.entry("cpu")
    _, touts = tfn(*targs)
    print(f"  entry: port differs in {ti.differing_frames(jpipe.fetch_outputs(touts, jo), outputs)} frames",
          flush=True)
    for n in ti.ENTRY_DRYRUN_POSITIONS:
        port = graft_entry.dryrun_multichip(n, device="cpu")
        for name, (outputs, carry) in _jax_dryrun(n).items():
            arrays.update(ti.entry_arrays(f"dry{n}.{name}", outputs, carry))
            print(f"  dry{n} {name}: port differs in {ti.differing_frames(port[name][0], outputs)} frames",
                  flush=True)
    np.savez_compressed(ti.ENTRY_FIXTURE, **arrays)
    print(f"wrote {os.path.relpath(ti.ENTRY_FIXTURE)}", flush=True)


PARTS = {
    "hq": lambda: freeze_presets(ti.HQ_OPTIONS, lambda preset: ti.hq_streams()),
    "strict": freeze_strict,
    "checkpoint": freeze_checkpoints,
    "flags": lambda: freeze_presets(ti.HQ_FLAG_OPTIONS, ti.hq_flag_streams),
    "depth_checkpoint": lambda: freeze_checkpoints(
        ti.DEPTH_CHECKPOINT, lambda: ti.hq_flag_streams(ti.DEPTH_CHECKPOINT[1])
    ),
    "corpus": freeze_corpus,
    "cli": freeze_cli,
    "dc": lambda: freeze_presets(["hq_dc_mono128", "hq_dc3p_mono128"], ti.dc_is_streams),
    "is": lambda: freeze_presets(["hq_is_32k", "strict_is_32k"], ti.dc_is_streams),
    "lsf": freeze_lsf,
    "ff": lambda: freeze_rows(ti.FF_ROWS),
    "mesh": freeze_mesh,
    "entry": freeze_entry,
}


def main(parts) -> None:
    torch.set_num_threads(1)
    os.makedirs(ti.TORCH_FIXTURE_DIR, exist_ok=True)
    for name in parts or PARTS:
        PARTS[name]()


if __name__ == "__main__":
    main(sys.argv[1:])

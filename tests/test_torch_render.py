"""The native render of a whole drain on the CPU: `BatchEncoder.drain`
renders its rows with one `native.render_batch` call a range of rows,
reading the packed host buffer in place.

- On small real chunks of the compat, hq_joint128 (aligned reservoir,
  mode_extension, scfsi), lsf_strict64 and CRC (`iso_crc`, reservoir depth
  3) configurations, with ragged frame counts, an empty stream, a row past
  the streams, a lane recycled between drains and the mesh's two CPU
  positions, the batched render gives the per-stream `FrameAssembler`
  reference's bytes, frame sizes, frame counts and byte counts
  (`tests.torch_inputs.AssemblerRender`).
- A drain makes at most render_threads native calls and counts their time.
- A frame past the pack's cap and a too small output arena raise.

Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from swiftmp3_tpu_torch import MP3EncoderOptions, Mode
from swiftmp3_tpu_torch.models.pipeline import main_data_cap, meta_layout
from swiftmp3_tpu_torch.parallel.batch import BatchEncoder, _Chunks
from swiftmp3_tpu_torch.parallel.mesh import make_mesh
from swiftmp3_tpu_torch.utils import profiling

from .torch_inputs import AssemblerRender

torch.set_num_threads(1)

ROWS, T = 6, 4  # the batch's rows (five streams and an empty row) and frames a step

CONFIGS = {
    "compat": dict(mode=Mode.STEREO, bitrate_kbps=128),
    "hq_joint128": ("hq", dict(mode=Mode.JOINT_STEREO, bitrate_kbps=128)),
    "lsf_strict64": ("spec_strict", dict(mode=Mode.JOINT_STEREO, bitrate_kbps=64, sample_rate=22050)),
    "crc_iso_depth3": dict(mode=Mode.JOINT_STEREO, bitrate_kbps=96, crc_protected=True, iso_crc=True,
                           reservoir_mode="aligned", reservoir_depth=3),
}


def _options(name: str) -> MP3EncoderOptions:
    how = CONFIGS[name]
    if isinstance(how, dict):
        return MP3EncoderOptions(**how)
    preset, kw = how
    return getattr(MP3EncoderOptions, preset)(**kw)


def _streams(o: MP3EncoderOptions) -> list:
    """Five int16 streams of 7.5, 5, 0, 3 and 6.3 frames: ragged over two
    or three steps of 4."""
    fl = o.samples_per_frame * o.channels
    rng = np.random.default_rng(19)
    return [(rng.standard_normal(int(n * fl)) * 5000).astype(np.int16) for n in (7.5, 5, 0, 3, 6.3)]


@pytest.mark.parametrize("where", ["one_device", "mesh2"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_batched_render_equals_per_stream_and_python_renders(config, where):
    o = _options(config)
    chunks = _Chunks(o, _streams(o), ROWS, T)
    assert chunks.frames > T  # two drains at least
    mesh = make_mesh(["cpu", "cpu"]) if where == "mesh2" else None
    enc = BatchEncoder(o, ROWS, T, "cpu", render_threads=4, mesh=mesh)
    ref = AssemblerRender(o, ROWS)
    got = {k: [bytearray() for _ in range(ROWS)] for k in ("batch", "python")}
    try:
        for i, start in enumerate(range(0, chunks.frames, T)):
            pcm, final, valid, la = chunks.build(start, chunks.frames)
            if i == 1:  # lane 1 takes a new stream between drains, as StreamPool recycles it
                lane = np.arange(ROWS) == 1
                enc.reset_lanes(lane)
                ref.reset_lanes(lane)
            outs = enc.step(pcm, final, valid, la)
            parts = outs["parts"] if "parts" in outs else [outs]
            assert len(parts) == (2 if mesh else 1)
            rendered = {"batch": enc.drain(outs, valid), "python": ref.drain(outs, valid)}
            for k, chunk in rendered.items():
                for b in range(ROWS):
                    got[k][b] += chunk[b]
        for k, tails in (("batch", enc.flush()), ("python", ref.flush())):
            for b, tail in enumerate(tails):
                got[k][b] += tail
    finally:
        enc.close()
    assert got["batch"] == got["python"]
    assert [len(x) > 0 for x in got["batch"]] == [True, True, False, True, True, False]
    for b, (r, want) in enumerate(zip(enc.renderers, ref.renderers)):
        assert r.frame_sizes == want.frame_sizes and sum(r.frame_sizes) == r.total_bytes
        for name in ("frame_count", "total_bytes"):
            assert getattr(r, name) == getattr(want, name)


def _compat_step(rows: int = ROWS, **kw):
    """A compat BatchEncoder and the outputs and valid mask of its first step."""
    o = _options("compat")
    chunks = _Chunks(o, _streams(o), rows, T)
    enc = BatchEncoder(o, rows, T, "cpu", **kw)
    pcm, final, valid, la = chunks.build(0, chunks.frames)
    return enc, enc.step(pcm, final, valid, la), valid


@pytest.mark.parametrize("render_threads", [1, 4, 16])
def test_a_drain_makes_at_most_render_threads_native_calls(render_threads):
    enc, outs, valid = _compat_step(render_threads=render_threads)
    profiling.reset()
    profiling.enable()
    try:
        for _ in range(2):
            enc.drain(outs, valid)
    finally:
        profiling.disable()
        enc.close()
    snap = profiling.snapshot()
    profiling.reset()
    renders = [s for s in snap["spans"] if s[0] == "drain.render"]
    assert len(renders) == 2
    calls = snap["counters"]["render.native_calls"]
    assert calls == 2 * min(render_threads, ROWS) <= 2 * render_threads
    threads = snap["counters"]["render.threads"] / len(renders)
    assert 0 < snap["counters"]["render.busy_ns"] <= threads * sum(s[2] - s[1] for s in renders)


@pytest.mark.parametrize("fault", ["past_cap", "small_arena", "foreign_layout"])
def test_a_faulty_drain_raises(fault):
    enc, outs, valid = _compat_step(render_threads=2)
    o = enc.options
    packed = outs["packed"]
    try:
        if fault == "past_cap":
            # row 3's second frame claims more main_data than the pack's cap holds
            cap = main_data_cap(o)
            word = meta_layout(o)["part23"][0]
            packed[3, 1, cap + 4 * word : cap + 4 * word + 4] = torch.from_numpy(
                np.array([8 * cap + 8], dtype=np.int32).view(np.uint8))
            match = "device pack cap exceeded"
        elif fault == "small_arena":
            enc._frame_bytes = 16  # an arena row of 64 bytes: three frames emitted do not fit
            match = "native render buffer overflow"
        else:
            outs = {"packed": packed[..., 1:]}
            match = "expected host uint8"
        with pytest.raises((RuntimeError, ValueError), match=match):
            enc.drain(outs, valid)
    finally:
        enc.close()

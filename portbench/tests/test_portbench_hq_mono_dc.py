"""The distortion-control configuration `hq_mono_dc` (MPEG-1 Layer III, the
hq preset in mono at 128 kbps and 44 100 Hz with distortion_control) held as
`test_portbench_lsf.py` holds the LSF one: the frozen golden copy gives the
port's golden backend's bytes, the port's batch path gives the port's own
session files, the golden's within distortion control's flip allowance and
with no structure error, and the frame plan is the session's (144
slots a kbps, padding at 128 kbps, one lookahead granule). A planted
one-byte main-data fault in the cell's files is refused by the number its
configuration holds."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from portbench import check, spec
from portbench.generator import make_audio

from .conftest import tiny_run
from .test_portbench_faults import _main_data_altered

NAME, CELL = "hq_mono_dc", "hq_mono_dc.corpus"


def _cfg():
    return spec.load_config(spec.load_benchmark(), NAME)


def _streams(seed=22):
    """Four mono streams of the cell's audio model at 44 100 Hz: whole
    frames, a partial frame, a partial granule's worth and a short one."""
    audio = make_audio(seed, 2, 1.0, 44100, 1, "cpu")
    lengths = [1152 * 9, 1152 * 7 + 300, 1152 * 8 - 576, 1000]
    return [audio[i % 2, 100 * i : 100 * i + n] for i, n in enumerate(lengths)]


def test_the_config_is_mono_hq_with_distortion_control():
    opts = check.golden_options(_cfg())
    assert opts.channels == 1 and not opts.lsf and opts.sample_rate == 44100 and opts.bitrate_kbps == 128
    assert opts.window_sequencing and opts.linbits_tables and opts.reservoir_mode == "aligned"
    # hq drops scfsi under distortion control, which runs its one default pass
    assert opts.distortion_control_active and not opts.scfsi and opts.dc_passes == 1


def test_the_copy_is_the_ports_golden_backend():
    from swiftmp3_tpu_torch import MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch.encoder import new_session

    cfg = _cfg()
    for pcm in _streams():
        s = new_session(check.build_options(MP3EncoderOptions, Mode, cfg), "cpu", backend="numpy")
        assert check.golden_bytes((cfg, pcm, None, False)) == s.encode(pcm) + s.flush()


def test_the_ports_batch_path_gives_the_goldens_files():
    """The batch path's files are the port's own session files byte for
    byte, and the golden's within the flip allowance of distortion control
    (its bump decision is a float compare: tests/test_torch_distortion.py
    allows 42 frames in 78 of the telemetry corpus), with no structure
    error."""
    from swiftmp3_tpu_torch import ID3Tag, MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch.encoder import new_session
    from swiftmp3_tpu_torch.parallel import encode_corpus

    cfg = _cfg()
    streams = _streams()
    tags = [{"title": f"Chapter {i}", "artist": "portbench", "track": i + 1} for i in range(len(streams))]
    options = check.build_options(MP3EncoderOptions, Mode, cfg)
    files = encode_corpus(options, streams, tags=[ID3Tag(**t) for t in tags], device="cpu", frames_per_step=4)
    opts = check.golden_options(cfg)
    differ = total = 0
    for pcm, tag, data in zip(streams, tags, files):
        s = new_session(dataclasses.replace(options, id3_tag=ID3Tag(**tag)), "cpu")
        audio = s.encode(pcm) + s.flush()
        assert data == s.generate_id3_tag() + s.generate_xing_header() + audio
        assert not check.structure_error(opts, len(pcm), data, tag, with_header=True)
        assert {len(f) for f in check.walk_frames(check.split_id3(data)[1])[1:]} <= {417, 418}
        d, n, _ = check.compare_frames(data, check.golden_bytes((cfg, pcm, tag, True)), True)
        differ, total = differ + d, total + n
    assert differ <= total * 42 / 78, (differ, total)


@pytest.mark.parametrize("frames", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("extra", [0, 1, 575, 576, 577, 1151])
def test_the_frame_plan_is_the_sessions(frames, extra):
    cfg = _cfg()
    opts = check.golden_options(cfg)
    n = 1152 * frames + extra
    pcm = (np.arange(n) % 200 - 100).astype(np.int16)
    data = check.golden_bytes((cfg, pcm, None, False))
    sizes = [len(f) for f in check.walk_frames(data)]
    assert sizes == check.frame_plan(opts, n)
    assert set(sizes) <= {417, 418}  # 144 * 128000 / 44100 = 417.96


def test_a_sound_run_is_correct():
    result, lines = tiny_run(CELL)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0


def test_a_one_byte_main_data_fault_is_refused(monkeypatch):
    """One byte of the first frame's main data in every rendered chunk
    inverted (byte 100: past the 4-byte header, the CRC and the 17 bytes of
    mono side information): the structure walk cannot see it; the number
    the configuration holds must refuse it."""
    _main_data_altered(monkeypatch)
    result, lines = tiny_run(CELL)
    assert not result["correct"], lines
    held = _cfg()["check"]["limits"]
    assert result["checks"]["structure_errors"]["value"] == 0, lines
    assert any(result["checks"][k]["value"] > limit for k, limit in held.items()), lines

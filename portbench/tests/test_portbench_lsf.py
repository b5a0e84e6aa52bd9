"""The LSF configuration `lsf_strict64` (MPEG-2 Layer III, spec_strict joint
stereo at 64 kbps and 22 050 Hz) held as `test_portbench_golden.py` holds
the MPEG-1 ones: the frozen golden copy gives the port's golden backend's
bytes, the port's batch path gives the golden's files with no structure
error, and the frame plan is the session's (72 slots a kbps, padding at
64 kbps). A planted one-byte main-data fault in the cell's files is refused
by the number its configuration holds."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import check, spec
from portbench.generator import make_audio

from .conftest import tiny_run
from .test_portbench_faults import _main_data_altered

NAME, CELL = "lsf_strict64", "lsf_strict64.corpus"


def _cfg():
    return spec.load_config(spec.load_benchmark(), NAME)


def _streams(seed=18):
    """Four stereo streams of the cell's audio model at 22 050 Hz: whole
    frames, a partial frame, a partial granule's worth and a short one."""
    audio = make_audio(seed, 2, 1.0, 22050, 2, "cpu")
    lengths = [576 * 9, 576 * 7 + 300, 576 * 8 - 288, 1000]
    return [audio[i % 2, 2 * 100 * i : 2 * (100 * i + n)] for i, n in enumerate(lengths)]


def test_the_config_is_mpeg2_lsf():
    opts = check.golden_options(_cfg())
    assert opts.lsf and opts.sample_rate == 22050 and opts.samples_per_frame == 576
    assert opts.spec_strict_entropy and opts.reservoir_mode == "aligned"


def test_the_copy_is_the_ports_golden_backend():
    from swiftmp3_tpu_torch import MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch.encoder import new_session

    cfg = _cfg()
    for pcm in _streams():
        s = new_session(check.build_options(MP3EncoderOptions, Mode, cfg), "cpu", backend="numpy")
        assert check.golden_bytes((cfg, pcm, None, False)) == s.encode(pcm) + s.flush()


def test_the_ports_batch_path_gives_the_goldens_files():
    from swiftmp3_tpu_torch import ID3Tag, MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch.parallel import encode_corpus

    cfg = _cfg()
    streams = _streams()
    tags = [{"title": f"Spot {i}", "artist": "portbench", "track": i + 1} for i in range(len(streams))]
    files = encode_corpus(check.build_options(MP3EncoderOptions, Mode, cfg), streams,
                          tags=[ID3Tag(**t) for t in tags], device="cpu", frames_per_step=4)
    opts = check.golden_options(cfg)
    for pcm, tag, data in zip(streams, tags, files):
        assert data == check.golden_bytes((cfg, pcm, tag, True))
        assert not check.structure_error(opts, len(pcm), data, tag, with_header=True)
        assert {len(f) for f in check.walk_frames(check.split_id3(data)[1])[1:]} <= {208, 209}


@pytest.mark.parametrize("frames", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("extra", [0, 1, 287, 288, 289, 575])
def test_the_frame_plan_is_the_sessions(frames, extra):
    cfg = _cfg()
    opts = check.golden_options(cfg)
    n = 2 * (576 * frames + extra)
    pcm = (np.arange(n) % 200 - 100).astype(np.int16)
    data = check.golden_bytes((cfg, pcm, None, False))
    sizes = [len(f) for f in check.walk_frames(data)]
    assert sizes == check.frame_plan(opts, n)
    assert set(sizes) <= {208, 209}  # 72 * 64000 / 22050 = 208.98


def test_a_sound_run_is_correct():
    result, lines = tiny_run(CELL)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0


def test_a_one_byte_main_data_fault_is_refused(monkeypatch):
    """One byte of the first frame's main data in every rendered chunk
    inverted (byte 100: past the 4-byte header, the CRC and the 17 bytes of
    side information): the structure walk cannot see it; the number the
    configuration holds must refuse it."""
    _main_data_altered(monkeypatch)
    result, lines = tiny_run(CELL)
    assert not result["correct"], lines
    held = _cfg()["check"]["limits"]
    assert result["checks"]["structure_errors"]["value"] == 0, lines
    assert any(result["checks"][k]["value"] > limit for k, limit in held.items()), lines

"""The frozen golden copy: the same bytes as the port's own golden backend,
and as the port's batch path on a tiny compat and hq batch on the CPU; and
the reference's laws for the frame count and sizes, ID3 and Xing."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import check, spec
from portbench.generator import make_audio

CONFIGS = ["compat128", "hq_joint128"]


def _cfg(name):
    return spec.load_config(spec.load_benchmark(), name)


def _streams(seed=5, n=4):
    audio = make_audio(seed, 2, 1.0, 44100, 2, "cpu")
    lengths = [1152 * 9, 1152 * 7 + 300, 1152 * 8 - 576, 2000][:n]
    return [audio[i % 2, 2 * 100 * i : 2 * (100 * i + n_)] for i, n_ in enumerate(lengths)]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_copy_is_the_ports_golden_backend(name):
    from swiftmp3_tpu_torch import MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch.encoder import new_session

    cfg = _cfg(name)
    for pcm in _streams():
        s = new_session(check.build_options(MP3EncoderOptions, Mode, cfg), "cpu", backend="numpy")
        assert check.golden_bytes((cfg, pcm, None, False)) == s.encode(pcm) + s.flush()


@pytest.mark.parametrize("name", CONFIGS)
def test_the_ports_batch_path_gives_the_goldens_files(name):
    from swiftmp3_tpu_torch import ID3Tag, MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch.parallel import encode_corpus

    cfg = _cfg(name)
    streams = _streams()
    tags = [{"title": f"Clip {i}", "artist": "portbench", "track": i + 1} for i in range(len(streams))]
    files = encode_corpus(check.build_options(MP3EncoderOptions, Mode, cfg), streams,
                          tags=[ID3Tag(**t) for t in tags], device="cpu", frames_per_step=4)
    opts = check.golden_options(cfg)
    for pcm, tag, data in zip(streams, tags, files):
        assert data == check.golden_bytes((cfg, pcm, tag, True))
        assert not check.structure_error(opts, len(pcm), data, tag, with_header=True)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("frames", [0, 1, 2, 5])
@pytest.mark.parametrize("extra", [0, 1, 575, 576, 577, 1151])
def test_the_frame_plan_is_the_sessions(name, frames, extra):
    cfg = _cfg(name)
    opts = check.golden_options(cfg)
    n = 2 * (1152 * frames + extra)
    pcm = (np.arange(n) % 200 - 100).astype(np.int16)
    data = check.golden_bytes((cfg, pcm, None, False))
    assert [len(f) for f in check.walk_frames(data)] == check.frame_plan(opts, n)


def test_a_malformed_or_missing_output_is_a_structure_error():
    cfg = _cfg("compat128")
    opts = check.golden_options(cfg)
    pcm = _streams(n=1)[0]
    tag = {"title": "x"}
    good = check.golden_bytes((cfg, pcm, tag, True))
    assert not check.structure_error(opts, len(pcm), good, tag, True)
    assert check.structure_error(opts, len(pcm), None, tag, True)
    assert check.structure_error(opts, len(pcm), good[:-1], tag, True)  # a frame cut short
    assert check.structure_error(opts, len(pcm), good, {"title": "y"}, True)  # another tag
    assert check.structure_error(opts, len(pcm) + 2304, good, tag, True)  # a frame missing
    id3 = len(check.split_id3(good)[0]) + 417  # the first audio frame's header
    assert check.structure_error(opts, len(pcm), good[: id3 + 2] + bytes([good[id3 + 2] ^ 1]) + good[id3 + 3 :], tag, True)
    n = len(check.walk_frames(check.split_id3(good)[1])) + 1  # the tag, Xing and the audio frames
    assert check.compare_frames(good, good, True) == (0, n, n)
    frames = check.walk_frames(check.split_id3(good)[1])
    altered = check.split_id3(good)[0] + b"".join(frames[:3]) + frames[3][:-1] + bytes([frames[3][-1] ^ 1]) + b"".join(frames[4:])
    assert check.compare_frames(altered, good, True) == (1, n, 5)


def test_the_golden_workers_give_the_in_process_bytes():
    cfg = {k: v for k, v in _cfg("hq_joint128").items() if k != "entry"}
    tasks = [(cfg, pcm, {"title": f"Clip {i}"}, True) for i, pcm in enumerate(_streams())]
    assert check.run_golden(tasks, 3) == check.run_golden(tasks, 0)

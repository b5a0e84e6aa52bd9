"""The port's host oracle surface against the JAX package's, on the CPU: the
golden backend (`new_session(o, backend="numpy")`, `MP3Encoder`, the command
line's `--backend numpy`), the decoder, `utils.quality`; the backend choice
(no card: `backend="torch"` raises, an unknown name raises); and the CPU
side of `chip_smoke.py [decode]`: a CPU batch's streams and the golden
encoder's of the same rows, decoded by the port's oracle and scored.

Every JAX side here is numpy (the golden backend, the decoder): no JAX
program is compiled.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
import swiftmp3_tpu.cli as jcli
import swiftmp3_tpu.options as jopt
import swiftmp3_tpu_torch.cli as tcli
import swiftmp3_tpu_torch.options as topt
from swiftmp3_tpu.decoder import decode_mp3 as jdecode
from swiftmp3_tpu.encoder import EncoderSession as JaxSession
from swiftmp3_tpu.utils.quality import encode_decode_quality as jquality
from swiftmp3_tpu_torch.decoder import decode_mp3
from swiftmp3_tpu_torch.encoder import GoldenBackend, MP3Encoder, new_session
from swiftmp3_tpu_torch.parallel.batch import BatchEncoder
from swiftmp3_tpu_torch.utils.quality import encode_decode_quality
from swiftmp3_tpu_torch.utils.wav import write_wav

from . import torch_inputs as ti

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """The golden encoder, the decoder and the quality measures run small
    BLAS calls frame by frame: with a BLAS thread a core in each of the
    suite's workers they crawl (minutes a test, measured), so each test
    here takes one."""
    with threadpool_limits(limits=1):
        yield


# (factory, options kwargs, signal kind, seconds, seed): at most 16 frames
# each. compat stereo, strict joint stereo, hq joint stereo, and LSF hq mono
# at 16 kHz (576-sample frames).
SESSION_ROWS = {
    "compat_stereo": (None, dict(mode="stereo"), "mix", 0.4, 1),
    "strict_joint": ("spec_strict", dict(mode="joint_stereo", bitrate_kbps=128), "burst", 0.4, 2),
    "hq_joint": ("hq", dict(mode="joint_stereo", bitrate_kbps=128), "mix", 0.35, 3),
    "lsf_hq_mono_16k": ("hq", dict(mode="mono", bitrate_kbps=48, sample_rate=16000), "burst", 0.5, 4),
}


def _both(row: str):
    factory, kw, kind, seconds, seed = SESSION_ROWS[row]
    t = ti.build_options(factory, kw, topt.MP3EncoderOptions)
    j = ti.build_options(factory, kw, jopt.MP3EncoderOptions, jopt.Mode)
    return t, j, ti.make_signal(kind, seconds, t.sample_rate, t.channels, seed)


@pytest.mark.parametrize("row", sorted(SESSION_ROWS))
def test_numpy_session_matches_the_jax_golden(row):
    t, j, pcm = _both(row)
    s = new_session(t, backend="numpy")
    assert isinstance(s.backend, GoldenBackend)
    got = s.encode(pcm) + s.flush()
    js = JaxSession(j, backend="numpy")
    want = js.encode(pcm) + js.flush()
    assert len(ti.walk_frames(want)) <= 17 and got == want
    assert s.generate_xing_header() == js.generate_xing_header()


# A compat stream of the JAX package's fixtures, an LSF one and an intensity
# one of the port's: (path, iso_conventions).
DECODE_STREAMS = {
    "compat_mono_32k": (os.path.join(ti.FIXTURE_DIR, "mono_cbr64_32k_noise.tpu.mp3"), False),
    "lsf_strict_joint_22k": (ti.jax_path("lsf_strict_joint64_22k_burst"), True),
    "hq_is_32k_panned": (ti.jax_path("hq_is_32k_corpus_panned"), True),
}


@pytest.mark.parametrize("name", sorted(DECODE_STREAMS))
def test_decoder_matches_the_jax_decoder(name):
    path, iso = DECODE_STREAMS[name]
    with open(path, "rb") as fh:
        data = fh.read()
    got, want = decode_mp3(data, iso_conventions=iso), jdecode(data, iso_conventions=iso)
    assert (got.sample_rate, got.channels, got.frame_count) == (
        want.sample_rate, want.channels, want.frame_count)
    assert want.frame_count > 5 and np.array_equal(got.pcm, want.pcm)


def test_encode_decode_quality_matches_the_reference():
    kw = dict(mode="mono", bitrate_kbps=64, reservoir_mode="aligned")
    pcm = ti.make_signal("sine", 0.3, 44100, 1, 0)
    got = encode_decode_quality(topt.MP3EncoderOptions(**kw), pcm, backend="numpy")
    want = jquality(jopt.MP3EncoderOptions(**dict(kw, mode=jopt.Mode.MONO)), pcm, backend="numpy")
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.snr_db > 10


def test_cli_backend_numpy_writes_the_jax_golden_file(tmp_path):
    wav = str(tmp_path / "in.wav")
    write_wav(wav, ti.cli_pcm(), ti.CLI_SIGNAL[2], ti.CLI_SIGNAL[3])
    outs = {m: tmp_path / f"{m}.mp3" for m in ("port", "jax")}
    assert tcli.main([wav, str(outs["port"]), *ti.CLI_ARGS, "--backend", "numpy"]) == 0
    assert jcli.main([wav, str(outs["jax"]), *ti.CLI_ARGS, "--backend", "numpy"]) == 0
    got, want = outs["port"].read_bytes(), outs["jax"].read_bytes()
    assert len(want) > 2000 and got == want
    with pytest.raises(SystemExit) as exit_:
        tcli.main([wav, str(tmp_path / "x.mp3"), "--backend", "bogus"])
    assert exit_.value.code != 0


def test_backend_choice():
    """backend="numpy" runs on the host, with or without a card;
    backend="torch" (the default) still needs the card by default; an
    unknown name raises, as the reference's does."""
    o = topt.MP3EncoderOptions(mode="mono")
    assert isinstance(MP3Encoder(o, backend="numpy").new_session().backend, GoldenBackend)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            new_session(o)
        with pytest.raises(RuntimeError):
            MP3Encoder(o).new_session()
    with pytest.raises(ValueError, match="unknown backend"):
        new_session(o, "cpu", backend="tpu")


def _cpu_batch(o, audio: list) -> list:
    """BatchEncoder on the CPU over the steps of `audio`, as chip_smoke.py's
    _drive runs it on the card."""
    B, T = audio[0].shape[:2]
    enc = BatchEncoder(o, B, T, device="cpu")
    final, valid = np.zeros((B, T), bool), np.ones((B, T), bool)
    streams = [bytearray() for _ in range(B)]
    try:
        for k in range(len(audio)):
            la = ti.step_lookahead(audio, k, o.channels) if o.window_sequencing else None
            for b, chunk in enumerate(enc.drain(enc.step(audio[k], final, valid, la), valid)):
                streams[b] += chunk
        for b, tail in enumerate(enc.flush()):
            streams[b] += tail
    finally:
        enc.close()
    return [bytes(s) for s in streams]


# Two of the [decode] paths: the strict path, and intensity stereo (window
# sequencing: the golden is fed each frame's lookahead as the batch is).
DECODE_PATHS = {
    "strict": lambda rng: (topt.MP3EncoderOptions.spec_strict(**ti.STRICT_OPTIONS),
                           [ti.bench_audio(rng, 1, 8, 2, 44100) for _ in range(2)]),
    "hq is": lambda rng: (ti.dc_is_options("hq_is_32k", topt.MP3EncoderOptions),
                          [ti.panned_audio(rng, 1, 8) for _ in range(2)]),
}


@pytest.mark.parametrize("path", sorted(DECODE_PATHS))
def test_decode_phase_row_on_the_cpu(path):
    """chip_smoke.py's [decode] row on a CPU batch's stream (2 steps of 8
    frames): structure equal to the golden encoder's, every frame parses,
    equal sample counts, and the decoded scores of the batch's and the
    golden's streams within the phase's 0.2 dB."""
    o, audio = DECODE_PATHS[path](np.random.default_rng(5))
    (data,) = _cpu_batch(o, audio)
    row = chip_smoke._decode_row(o, audio, data)
    assert row["frames"] == 16 and row["decoded_frames"] == 16
    diff = {k: max(abs(a - b) for a, b in zip(row["card"][k], row["golden"][k])) for k in ("snr", "nmr")}
    print(f"{path}: frames {row['differ']} of 16 differ; SNR CPU batch {row['card']['snr']} golden "
          f"{row['golden']['snr']} dB; largest differences {diff}")
    assert max(diff.values()) <= chip_smoke.DECODE_SCORE_CEILING_DB and min(row["card"]["snr"]) > 10
    if row["mpg123"] is not None:
        assert row["mpg123"] > chip_smoke.MPG123_AGREEMENT_FLOOR_DB

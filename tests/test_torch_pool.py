"""The port's serving and file entry points on the CPU: `StreamPool`,
`BatchEncoder.reset_lanes`, the native render against the FrameAssembler
reference, `encode_corpus` and the command line.

- each scenario of tests/test_pool.py, the sequenced hq pool of
  tests/test_window_sequencing.py and the gapless pool of
  tests/test_gapless.py, run on the port's pool, give byte for byte the
  port's sessions' streams (one float stack, so no flip is allowed),
  pipelined and synchronous;
- reset_lanes leaves unmasked lanes bit for bit and gives masked ones
  init_carry's state; the native render gives the per-stream
  FrameAssembler's bytes (`tests.torch_inputs.AssemblerRender`);
- encode_corpus equals ID3 + Xing + session bytes, and the JAX package's
  frozen encode_corpus file; the command line's file equals the port's
  session's and the JAX command line's frozen file for the same WAV;
- the new entry points default to the card and raise without one.

Nothing here imports JAX: the JAX bytes are files frozen by
tests/torch_freeze_fixtures.py.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from swiftmp3_tpu_torch import cli
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.io.id3 import build_id3_tag
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.native import NativeStreamRenderer
from swiftmp3_tpu_torch.options import ID3Tag, MP3EncoderOptions
from swiftmp3_tpu_torch.parallel import BatchEncoder, StreamPool, encode_corpus, make_mesh
from swiftmp3_tpu_torch.parallel import batch as tbatch
from swiftmp3_tpu_torch.utils import read_wav, write_wav

from . import torch_inputs as ti
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _session(opts):
    return new_session(opts, CPU)


def _session_encode(opts, pcm) -> bytes:
    s = _session(opts)
    return s.encode(pcm) + s.flush()


def _pool(opts, **kw) -> StreamPool:
    return StreamPool(opts, device="cpu", **kw)


def _sig(rng, n_samples, ch, kind=1):
    """Copy of tests/test_pool.py's signal maker."""
    n = n_samples * ch
    if kind == 0:
        return np.zeros(n, dtype=np.float32)
    t = np.arange(n) / 44100
    f = rng.uniform(100, 4000)
    return (rng.uniform(0.1, 0.8) * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _bursty(n: int, seed: int = 9) -> np.ndarray:
    """Copy of tests/test_window_sequencing.py's signal maker."""
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * 523.0 * np.arange(n) / 44100.0)
    for s in range(1500, n - 600, 5000):
        x[s : s + 300] += 0.55 * rng.standard_normal(300)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _chirp(n: int) -> np.ndarray:
    """Copy of tests/test_gapless.py's signal maker (mono)."""
    t = np.arange(n) / 44100
    return (0.5 * np.sin(2 * np.pi * (300 + 1500 * t / (n / 44100)) * t)).astype(np.float32)


# --- tests/test_pool.py's scenarios on the port ------------------------------------


@pytest.mark.parametrize("pipelined", [True, False])
def test_pool_matches_sessions_staggered(pipelined):
    """More streams than lanes, different lengths (incl. partial tails and
    an exact frame boundary), arrivals staggered across steps."""
    opts = MP3EncoderOptions(mode="mono", bitrate_kbps=64)
    rng = np.random.default_rng(1)
    lengths = [3 * 1152 + 400, 2 * 1152, 5 * 1152 + 1, 1152 // 2, 4 * 1152]
    sigs = [_sig(rng, L, 1) for L in lengths]

    pool = _pool(opts, lanes=2, frames_per_step=2, pipelined=pipelined)
    sids = []
    for i in range(2):
        sid = pool.submit()
        pool.feed(sid, sigs[i])
        pool.close(sid)
        sids.append(sid)
    pending = list(range(2, len(sigs)))
    for _ in range(200):
        if pool.idle and not pending:
            break
        if pending:
            i = pending.pop(0)
            sid = pool.submit()
            pool.feed(sid, sigs[i])
            pool.close(sid)
            sids.append(sid)
        pool.step()
    pool.run_until_idle()
    for i, sid in enumerate(sids):
        assert pool.result(sid) == _session_encode(opts, sigs[i]), f"stream {i}"


def test_pool_incremental_feed_matches_whole():
    """Feeding in odd-sized chunks with interleaved steps equals one-shot."""
    opts = MP3EncoderOptions(mode="stereo")
    rng = np.random.default_rng(2)
    pcm = _sig(rng, 4 * 1152 + 777, 2)
    pool = _pool(opts, lanes=1, frames_per_step=2)
    sid = pool.submit()
    pos = 0
    for chunk in (1000, 3000, 500, 10, len(pcm)):
        end = min(pos + chunk, len(pcm))
        pool.feed(sid, pcm[pos:end])
        pos = end
        pool.step()
        if pos == len(pcm):
            break
    pool.close(sid)
    pool.run_until_idle()
    assert pool.result(sid) == _session_encode(opts, pcm)


def test_pool_lane_reuse_is_fresh():
    """A lane recycled after a loud stream encodes a new stream exactly as a
    fresh session would (carry, reservoir and renderer all reset)."""
    opts = MP3EncoderOptions(mode="mono")
    rng = np.random.default_rng(3)
    loud = (_sig(rng, 3 * 1152, 1) * 1.2).clip(-0.99, 0.99)
    quiet = _sig(rng, 3 * 1152 + 100, 1) * 0.1
    pool = _pool(opts, lanes=1, frames_per_step=4)
    a = pool.submit()
    pool.feed(a, loud)
    pool.close(a)
    pool.run_until_idle()
    b = pool.submit()
    pool.feed(b, quiet)
    pool.close(b)
    pool.run_until_idle()
    assert pool.result(a) == _session_encode(opts, loud)
    assert pool.result(b) == _session_encode(opts, quiet)
    assert pool.frame_count(b) == 4  # 3 full + padded tail


def test_pool_empty_and_silent_streams():
    opts = MP3EncoderOptions(mode="mono")
    pool = _pool(opts, lanes=2, frames_per_step=2)
    empty = pool.submit()
    pool.close(empty)
    silent = pool.submit()
    pool.feed(silent, np.zeros(2 * 1152, dtype=np.float32))
    pool.close(silent)
    pool.run_until_idle()
    assert pool.result(empty) == b""
    assert pool.result(silent) == _session_encode(opts, np.zeros(2 * 1152, dtype=np.float32))
    assert len(parse_frames(pool.result(silent))) == 2


def test_pool_feed_after_close_raises():
    pool = _pool(MP3EncoderOptions(mode="mono"), lanes=1)
    sid = pool.submit()
    pool.close(sid)
    with pytest.raises(ValueError):
        pool.feed(sid, np.zeros(10, dtype=np.float32))
    with pytest.raises(ValueError):
        pool.result(pool.submit())  # not finished


def test_pool_xing_header_matches_session():
    opts = MP3EncoderOptions(mode="mono")
    pcm = _sig(np.random.default_rng(5), 3 * 1152 + 200, 1)
    pool = _pool(opts, lanes=1, frames_per_step=2)
    sid = pool.submit()
    pool.feed(sid, pcm)
    pool.close(sid)
    pool.run_until_idle()
    s = _session(opts)
    assert pool.result(sid) == s.encode(pcm) + s.flush()
    assert pool.xing_header(sid) == s.generate_xing_header()


def test_pool_int16_feed_matches_float():
    """int16 feeds ride as int16 and give the float session's bytes; a float
    stream in the same step takes the mixed-dtype path."""
    opts = MP3EncoderOptions(mode="mono")
    f = _sig(np.random.default_rng(6), 3 * 1152 + 300, 1)
    i16 = (f * 32767).astype(np.int16)
    pool = _pool(opts, lanes=2, frames_per_step=2)
    a = pool.submit()
    pool.feed(a, i16)
    pool.close(a)
    b = pool.submit()
    pool.feed(b, f)
    pool.close(b)
    pool.run_until_idle()
    assert pool.result(a) == _session_encode(opts, i16)
    assert pool.result(b) == _session_encode(opts, f)


def test_pool_int16_stays_int16_up_to_the_device(monkeypatch):
    """An all-int16 step hands the chunk program int16 PCM."""
    seen = []
    step = BatchEncoder.step

    def spy(self, pcm, final, valid, lookahead=None):
        seen.append(pcm.dtype)
        return step(self, pcm, final, valid, lookahead)

    monkeypatch.setattr(BatchEncoder, "step", spy)
    pool = _pool(MP3EncoderOptions(mode="mono"), lanes=2, frames_per_step=2)
    sid = pool.submit()
    pool.feed(sid, (_sig(np.random.default_rng(8), 2 * 1152, 1) * 32767).astype(np.int16))
    pool.close(sid)
    pool.run_until_idle()
    assert seen and set(seen) == {np.dtype(np.int16)}


def test_pool_release_and_stall_detection():
    opts = MP3EncoderOptions(mode="mono")
    pool = _pool(opts, lanes=1, frames_per_step=2)
    sid = pool.submit()
    pool.feed(sid, np.zeros(500, dtype=np.float32))  # sub-frame, never closed
    with pytest.raises(RuntimeError, match="stalled"):
        pool.run_until_idle()
    pool.close(sid)
    pool.run_until_idle()
    _ = pool.result(sid)
    pool.release(sid)
    with pytest.raises(KeyError):
        pool.result(sid)
    pool.shutdown()


def test_pool_pipelined_matches_synchronous():
    """pipelined=True defers each chunk's drain one step; bytes, frame
    counts and Xing headers equal the synchronous pool's and the sessions'."""
    opts = MP3EncoderOptions(mode="mono", bitrate_kbps=96)
    rng = np.random.default_rng(7)
    lengths = [4 * 1152 + 300, 2 * 1152, 6 * 1152 + 900, 1152]
    sigs = [_sig(rng, L, 1) for L in lengths]
    results = {}
    for pipelined in (False, True):
        pool = _pool(opts, lanes=2, frames_per_step=2, pipelined=pipelined)
        sids = [pool.submit() for _ in sigs]
        for sid, sig in zip(sids, sigs):
            pool.feed(sid, sig)
            pool.close(sid)
        pool.run_until_idle()
        results[pipelined] = [
            (pool.result(sid), pool.frame_count(sid), pool.xing_header(sid)) for sid in sids
        ]
        pool.shutdown()
    assert results[False] == results[True]
    for (data, frames, _), sig in zip(results[True], sigs):
        assert data == _session_encode(opts, sig)
        assert frames == len(parse_frames(data))


def test_pool_pipelined_done_defers_one_step():
    """A finishing chunk's results surface on the next step; idle stays
    False while a chunk is in flight."""
    opts = MP3EncoderOptions(mode="mono")
    pool = _pool(opts, lanes=1, frames_per_step=4, pipelined=True)
    sid = pool.submit()
    pool.feed(sid, np.zeros(2 * 1152, dtype=np.float32))
    pool.close(sid)
    pool.step()  # dispatches the final chunk
    assert not pool.done(sid) and not pool.idle
    pool.step()  # drains it
    assert pool.done(sid) and pool.finished() == [sid]
    assert pool.result(sid) == _session_encode(opts, np.zeros(2 * 1152, np.float32))
    pool.shutdown()


# --- hq: window sequencing, gapless --------------------------------------------------


@pytest.mark.parametrize("pipelined", [True, False])
def test_sequenced_pool_matches_sessions(pipelined):
    """Under hq (window_sequencing): the holdback rule, the preroll on first
    feed and the exact-frame-multiple final flag give the sessions' bytes,
    with a drip-fed stream and a stream closed without PCM."""
    o = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=128)
    sigs = [
        _bursty(3 * 1152 + 500, seed=31),
        _bursty(2 * 1152, seed=32),  # exact frame multiple
        _bursty(4 * 1152 + 1, seed=33),
    ]
    pool = _pool(o, lanes=2, frames_per_step=2, pipelined=pipelined)
    sid0 = pool.submit()
    sid_empty = pool.submit()
    pool.close(sid_empty)
    pos = 0
    sids = [sid0, None, None]
    arrivals = [1, 2]
    for chunk in (900, 2500, 3333, None, None):
        if chunk is not None:
            end = min(pos + chunk, len(sigs[0]))
            pool.feed(sid0, sigs[0][pos:end])
            pos = end
        elif arrivals:
            i = arrivals.pop(0)
            sids[i] = pool.submit()
            pool.feed(sids[i], sigs[i])
            pool.close(sids[i])
        pool.step()
    pool.feed(sid0, sigs[0][pos:])
    pool.close(sid0)
    pool.run_until_idle()
    assert pool.result(sid_empty) == b""
    for i, sid in enumerate(sids):
        assert pool.result(sid) == _session_encode(o, sigs[i]), f"stream {i}"


def test_gapless_pool_and_batch_match_session():
    """Under gapless_info the pool's Xing header and bytes, and
    encode_batch's bytes, equal the session's (tail zeros and tag fields)."""
    pcm = _chirp(3 * 1152 + 451)
    opts = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=128, gapless_info=True)
    s = _session(opts)
    body = s.encode(pcm) + s.flush()
    assert tbatch.encode_batch(opts, [pcm], CPU, frames_per_step=4)[0] == body
    pool = _pool(opts, lanes=2, frames_per_step=4, pipelined=False)
    sid = pool.submit()
    pool.feed(sid, pcm)
    pool.close(sid)
    for _ in range(64):
        if pool.done(sid):
            break
        pool.step()
    assert pool.xing_header(sid) + pool.result(sid) == s.generate_xing_header() + body
    pool.shutdown()


# --- BatchEncoder: reset_lanes, the FrameAssembler path ------------------------------


@pytest.mark.parametrize("preset", ["compat", "hq_depth3"])
def test_reset_lanes(preset):
    """Masked lanes take init_carry's state (the +inf block energies of
    window sequencing among it) and fresh renderers; unmasked lanes keep
    their carry bit for bit; an all-False mask changes nothing."""
    if preset == "compat":
        o = MP3EncoderOptions(mode="stereo")
    else:
        o = MP3EncoderOptions.hq(mode="stereo", bitrate_kbps=96, reservoir_depth=3)
    B, T = 3, 2
    enc = BatchEncoder(o, B, T, CPU)
    rng = np.random.default_rng(9)
    pcm = (rng.standard_normal((B, T, 2304)) * 0.3).astype(np.float32)
    la = (rng.standard_normal((B, T, 1152)) * 0.3).astype(np.float32)
    valid = np.ones((B, T), dtype=bool)
    outs = enc.step(pcm, np.zeros((B, T), dtype=bool), valid, la if o.window_sequencing else None)
    enc.drain(outs, valid)
    before = {k: v.clone() for k, v in enc.carry.items()}
    renderers = list(enc.renderers)
    enc.reset_lanes(np.zeros(B, dtype=bool))
    assert all(torch.equal(enc.carry[k], before[k]) for k in before)
    assert enc.renderers == renderers
    mask = np.array([False, True, False])
    enc.reset_lanes(mask)
    init = tpipe.init_carry(B, o, CPU)
    for k, v in enc.carry.items():
        assert v.dtype == before[k].dtype and v.shape == before[k].shape, k
        assert v[[0, 2]].numpy().tobytes() == before[k][[0, 2]].numpy().tobytes(), k
        assert v[1].numpy().tobytes() == init[k][1].numpy().tobytes(), k
    # the step had moved the lane's state away from a fresh stream's
    moved = {k for k in before if not torch.equal(before[k][1], init[k][1])}
    assert {"fb_hist", "overlap", "stream_len", "slot_fifo", "pad_rem"} <= moved
    if o.window_sequencing:
        assert torch.isinf(enc.carry["onset_prev2"][1]).all()
        assert torch.isfinite(enc.carry["onset_prev2"][0]).all()
    assert enc.renderers[1] is not renderers[1]
    assert enc.renderers[0] is renderers[0] and enc.renderers[2] is renderers[2]
    enc.close()


def test_frame_assembler_path_matches_native():
    """The native render gives the Python FrameAssembler's bytes, in steps
    and at the flush, at depth 3."""
    o = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=96, reservoir_depth=3)
    pcm = ti.sparse_transients(8 * 1152).reshape(2, 4, 1152)
    la = np.zeros((2, 4, 576), dtype=np.float32)
    la[:, :-1] = pcm[:, 1:, :576]
    valid = np.ones((2, 4), dtype=bool)
    valid[1, 3] = False
    final = np.zeros((2, 4), dtype=bool)
    enc = BatchEncoder(o, 2, 4, CPU, render_threads=1)
    assert all(isinstance(r, NativeStreamRenderer) for r in enc.renderers)
    ref = ti.AssemblerRender(o, 2)
    outs = enc.step(pcm, final, valid, la)
    data = enc.drain(outs, valid)
    assert data == ref.drain(outs, valid)
    tails = enc.flush()
    assert tails == ref.flush()
    assert all(d + t for d, t in zip(data, tails))


def test_pool_without_native_matches_sessions():
    """The pool, whose one render is the native one, gives the sessions'
    streams and Xing headers."""
    opts = MP3EncoderOptions(mode="joint_stereo", bitrate_kbps=112)
    rng = np.random.default_rng(10)
    sigs = [_sig(rng, 2 * 1152 + 33 * i, 2) for i in range(3)]
    pool = _pool(opts, lanes=2, frames_per_step=2)
    assert all(isinstance(r, NativeStreamRenderer) for r in pool.enc.renderers)
    sids = [pool.submit() for _ in sigs]
    for sid, sig in zip(sids, sigs):
        pool.feed(sid, sig)
        pool.close(sid)
    pool.run_until_idle()
    for sid, sig in zip(sids, sigs):
        assert pool.result(sid) == _session_encode(opts, sig)
        assert pool.xing_header(sid) == _xing_of(opts, sig)


def _xing_of(opts, pcm) -> bytes:
    s = _session(opts)
    s.encode(pcm)
    s.flush()
    return s.generate_xing_header()


# --- encode_corpus and the command line -----------------------------------------------


def _corpus_options(**kw) -> MP3EncoderOptions:
    return MP3EncoderOptions(**ti.CORPUS_OPTIONS, **kw)


def test_encode_corpus_equals_id3_xing_and_session_bytes():
    """Per stream [ID3][Xing][frames], the tag per stream or the options'
    own, as a session writes them."""
    streams = ti.corpus_streams()
    tags = [ID3Tag(title=t, artist=a) for t, a in ti.CORPUS_TAGS]
    for o, tag_list in ((_corpus_options(), tags), (_corpus_options(id3_tag=tags[1]), None)):
        files = encode_corpus(o, streams, tags=tag_list, device="cpu", frames_per_step=4)
        for b, (pcm, data) in enumerate(zip(streams, files)):
            s = _session(dataclasses.replace(o, id3_tag=tag_list[b] if tag_list else o.id3_tag))
            audio = s.encode(pcm) + s.flush()
            assert data == s.generate_id3_tag() + s.generate_xing_header() + audio, b
            assert data.startswith(build_id3_tag(s.options.id3_tag))
    o = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=96, reservoir_depth=3)
    pcm = ti.sparse_transients(6 * 1152)
    (data,) = encode_corpus(o, [pcm], device="cpu", frames_per_step=4)
    s = _session(o)
    audio = s.encode(pcm) + s.flush()
    assert data == s.generate_xing_header() + audio  # no tag


def test_encode_corpus_matches_the_jax_file():
    tags = [ID3Tag(title=t, artist=a) for t, a in ti.CORPUS_TAGS]
    files = encode_corpus(_corpus_options(), ti.corpus_streams(), tags=tags, device="cpu",
                          frames_per_step=4)
    with open(ti.jax_path("corpus_file0"), "rb") as fh:
        assert files[0] == fh.read()


def _cli_wav(tmp_path) -> str:
    _, _, sr, channels, _ = ti.CLI_SIGNAL
    wav = str(tmp_path / "in.wav")
    write_wav(wav, ti.cli_pcm(), sr, channels)
    return wav


def test_cli_matches_the_session_and_the_jax_file(tmp_path):
    wav, out = _cli_wav(tmp_path), str(tmp_path / "out.mp3")
    assert cli.main([wav, out, *ti.CLI_ARGS, "--device", "cpu"]) == 0
    with open(out, "rb") as fh:
        got = fh.read()
    with open(ti.jax_path("cli"), "rb") as fh:
        assert got == fh.read()
    pcm, sr, channels = read_wav(wav)
    o = MP3EncoderOptions.hq(mode="mono", sample_rate=sr, bitrate_kbps=96, lowpass_hz=11000,
                             gapless_info=True, id3_tag=ID3Tag(title="Port", artist="swiftmp3"))
    assert channels == 1 and o.adaptive_lowpass is False
    s = _session(o)
    audio = s.encode(pcm) + s.flush()
    assert got == s.generate_id3_tag() + s.generate_xing_header() + audio


def test_cli_mode_and_preset_flags(tmp_path):
    """A mono WAV to joint stereo, the strict preset and the default."""
    wav = _cli_wav(tmp_path)
    pcm, sr, _ = read_wav(wav)
    cases = [
        (["--mode", "joint_stereo", "--spec-strict"],
         MP3EncoderOptions.spec_strict(mode="joint_stereo", sample_rate=sr), np.repeat(pcm, 2)),
        (["--bitrate", "64", "--vbr"], MP3EncoderOptions(mode="mono", sample_rate=sr,
                                                         bitrate_kbps=64, vbr=True), pcm),
    ]
    for i, (args, o, src) in enumerate(cases):
        out = str(tmp_path / f"out{i}.mp3")
        assert cli.main([wav, out, "--quiet", "--device", "cpu", *args]) == 0
        s = _session(o)
        audio = s.encode(src) + s.flush()
        with open(out, "rb") as fh:
            assert fh.read() == s.generate_xing_header() + audio, args


def test_wav_round_trip(tmp_path):
    """utils.wav writes PCM16 and reads it back as float32 in [-1, 1)."""
    pcm = ti.make_signal("mix", 0.05, 32000, 2, 44)
    path = str(tmp_path / "x.wav")
    write_wav(path, pcm, 32000, 2)
    back, sr, ch = read_wav(path)
    assert (sr, ch) == (32000, 2) and back.dtype == np.float32
    assert np.array_equal(back, (np.clip(pcm, -1, 1) * 32767).astype(np.int16) / np.float32(32768))


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """StreamPool, encode_corpus and the command line run on "cuda" unless
    told otherwise, and with no card they raise; the pool and encode_corpus
    take no mesh unless given one, and the default mesh (every card) raises
    without a card too."""
    for f in (StreamPool, encode_corpus):
        assert inspect.signature(f).parameters["device"].default == "cuda"
        assert inspect.signature(f).parameters["mesh"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o = MP3EncoderOptions(mode="stereo")
    pcm = ti.make_signal("sine", 0.1, 44100, 2, 0)
    wav = _cli_wav(tmp_path)
    for call in (
        lambda: StreamPool(o),
        lambda: encode_corpus(o, [pcm]),
        lambda: cli.main([wav, str(tmp_path / "o.mp3"), "--quiet"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        StreamPool(o, mesh=make_mesh())

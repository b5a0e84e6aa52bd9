"""The port's compat chunk program, sessions and batch encoder against the
JAX package (CPU).

- the chunk program against jax.jit(pipeline.make_chunk_fn): every
  fetch_outputs field exact, the carry within float tolerance;
- the 8 compat fixture rows byte-equal to the JAX backend's streams;
- drip-feed, batch and checkpoint invariances; unsupported options raise;
- importing the port loads no jax.
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.models import pipeline as jpipe
from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.parallel.batch import BatchEncoder, encode_batch

from .fixture_lib import FIXTURES, fixture_path, make_signal
from .test_ulp_telemetry import _corpus_stereo
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")
COMPAT_FIXTURES = [f for f in FIXTURES if not MP3EncoderOptions(**f[1]).spec_strict_entropy]

CHUNK_OPTIONS = {
    "stereo": dict(mode=Mode.STEREO),
    "joint": dict(mode=Mode.JOINT_STEREO),
    "mono_vbr": dict(mode=Mode.MONO, vbr=True, quality=3),
    "aligned_crc_48k": dict(
        mode=Mode.STEREO, reservoir_mode="aligned", crc_protected=True, sample_rate=48000
    ),
    "iso_quant_32k": dict(mode=Mode.JOINT_STEREO, iso_quantization=True, sample_rate=32000),
}


def _chunk_input(options, B, T, seed):
    rng = np.random.default_rng(seed)
    n = 1152 * options.channels
    x = rng.standard_normal((B, T * n)).astype(np.float32) * 0.2
    for i in range(1, 5):  # correlated, reservoir-stressing
        x[:, i:] += x[:, :-i] / (i + 1)
    x[0, : T * n // 2] *= 0.01  # quiet then loud: transients, gain spread
    return x.reshape(B, T, n)


@pytest.mark.parametrize("name", sorted(CHUNK_OPTIONS))
def test_chunk_program_matches_jax(name):
    o = MP3EncoderOptions(**CHUNK_OPTIONS[name])
    B, T = 2, 4
    final = np.zeros((B, T), bool)
    final[1, 2] = True
    valid = np.ones((B, T), bool)
    valid[1, 3] = False  # stream 1 ends inside the first chunk
    chunks = [
        (_chunk_input(o, B, T, 0), final, valid),
        (_chunk_input(o, B, T, 1), np.zeros((B, T), bool), np.ones((B, T), bool)),
    ]
    jrun = jax.jit(jpipe.make_chunk_fn(o))
    trun = tpipe.make_chunk_fn(o)
    jc = jpipe.init_carry(B, o)
    tc = tpipe.init_carry(B, o, CPU)
    for pcm, fin, val in chunks:
        jc, jo = jrun(jc, pcm, fin, val)
        tc, to = trun(tc, torch.from_numpy(pcm), torch.from_numpy(fin), torch.from_numpy(val))
        want = jpipe.fetch_outputs(jo, o)
        got = tpipe.fetch_outputs(to, o)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(to["packed"].numpy(), np.asarray(jo["packed"]))
    assert sorted(tc) == sorted(k for k in jc if k in tc)
    for k, v in tc.items():
        ref = np.asarray(jc[k])
        assert v.dtype == getattr(torch, str(ref.dtype)) and tuple(v.shape) == ref.shape, k
        if ref.dtype == np.float32:
            np.testing.assert_allclose(v.numpy(), ref, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert np.array_equal(v.numpy(), ref), k


def test_host_contract_matches_jax():
    """main_data_cap, fetch_outputs and frame_results_from_outputs read one
    packed output exactly as the JAX functions do."""
    for _, kw, *_ in COMPAT_FIXTURES:
        o = MP3EncoderOptions(**kw)
        assert tpipe.main_data_cap(o) == jpipe.main_data_cap(o)
    o = MP3EncoderOptions(mode=Mode.JOINT_STEREO)
    B, T = 2, 3
    pcm = _chunk_input(o, B, T, 5)
    _, outs = tpipe.make_chunk_fn(o)(
        tpipe.init_carry(B, o, CPU), torch.from_numpy(pcm),
        torch.zeros(B, T, dtype=torch.bool), torch.ones(B, T, dtype=torch.bool),
    )
    packed = outs["packed"].numpy()
    got = tpipe.fetch_outputs(outs, o)
    want = jpipe.fetch_outputs({"packed": packed}, o)
    for b in range(B):
        for t in range(T):
            fr_t = tpipe.frame_results_from_outputs(got, o, t, b)
            fr_j = jpipe.frame_results_from_outputs(want, o, t, b)
            assert fr_t.granules == fr_j.granules
            assert fr_t.main_data == fr_j.main_data
            for f in ("bitrate_index", "padding", "main_data_begin", "slot_size",
                      "scfsi", "mode_ext"):
                assert getattr(fr_t, f) == getattr(fr_j, f), f
            assert np.array_equal(fr_t.big_values, fr_j.big_values)


@pytest.mark.parametrize("row", COMPAT_FIXTURES, ids=[f[0] for f in COMPAT_FIXTURES])
def test_compat_fixture_rows_byte_equal(row):
    name, kw, kind, seconds, seed = row
    o = MP3EncoderOptions(**kw)
    pcm = make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    s = new_session(o, CPU)
    data = s.encode(pcm) + s.flush()
    with open(fixture_path(name, "tpu"), "rb") as fh:
        assert data == fh.read()


def test_compat_flip_rate_vs_golden_on_the_telemetry_corpus():
    """The JAX backend's compat ceiling on the tests/test_ulp_telemetry
    corpus (2 divergent frames; measured 0/72 there) holds for the port;
    structure is equal everywhere."""
    o = MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128, sample_rate=44100)
    bad = total = 0
    for pcm in _corpus_stereo().values():
        s = new_session(o, CPU)
        got = s.encode(pcm) + s.flush()
        g = EncoderSession(o, backend="numpy")
        ref = g.encode(pcm) + g.flush()
        fg, fr = parse_frames(got), parse_frames(ref)
        assert [f.size for f in fg] == [f.size for f in fr]
        bad += sum(
            got[a.offset : a.offset + a.size] != ref[b.offset : b.offset + b.size]
            for a, b in zip(fg, fr)
        )
        total += len(fr)
    assert total == 72 and bad <= 2


def test_drip_feed_matches_whole_buffer():
    o = MP3EncoderOptions(mode=Mode.JOINT_STEREO)
    pcm = make_signal("mix", 0.5, 44100, 2, 21)
    s = new_session(o, CPU)
    whole = s.encode(pcm) + s.flush()
    s = new_session(o, CPU)
    parts = bytearray()
    for i in range(0, len(pcm), 3001):
        parts += s.encode(pcm[i : i + 3001])
    parts += s.flush()
    assert bytes(parts) == whole
    assert s.flush() == b""


def test_batch_matches_sessions():
    o = MP3EncoderOptions(mode=Mode.STEREO, vbr=True, quality=4)
    base = make_signal("noise", 0.6, 44100, 2, 22)
    streams = [
        base,
        base[: 2 * 1152 * 7],  # exact frame multiple: no final frame
        base[::-1].copy()[: 2 * 5000 + 2],  # partial last frame
        (make_signal("sine", 0.3, 44100, 2, 0) * 32767).astype(np.int16),
    ]
    got = encode_batch(o, streams, CPU, frames_per_step=4)
    for s_pcm, data in zip(streams, got):
        s = new_session(o, CPU)
        assert data == s.encode(s_pcm) + s.flush()
        assert len(parse_frames(data)) == s.encoded_frame_count


def test_batch_encoder_step_drain_flush():
    o = MP3EncoderOptions(mode=Mode.MONO)
    B, T = 3, 4
    enc = BatchEncoder(o, B, T, CPU)
    pcm = _chunk_input(o, B, T, 9)
    valid = np.ones((B, T), bool)
    try:
        out = enc.drain(enc.step(*enc.prepare(pcm, np.zeros((B, T), bool), valid)), valid)
        out = [a + b for a, b in zip(out, enc.flush())]
    finally:
        enc.close()
    for b in range(B):
        s = new_session(o, CPU)
        assert out[b] == s.encode(pcm[b].reshape(-1)) + s.flush()


def _split_encode(first, second, pcm, cut):
    """Encode pcm[:cut] with session `first`, move its checkpoint into
    `second`, finish there; returns the bytes after the cut."""
    first.encode(pcm[:cut])
    second.load_state_dict(first.state_dict())
    return second.encode(pcm[cut:]) + second.flush()


def test_checkpoint_jax_to_port_and_back():
    o = MP3EncoderOptions(mode=Mode.JOINT_STEREO)
    pcm = make_signal("noise", 0.5, 44100, 2, 23)
    cut = 2 * 1152 * 9 + 500

    ref = EncoderSession(o, backend="tpu")
    ref.encode(pcm[:cut])
    tail_ref = ref.encode(pcm[cut:]) + ref.flush()

    tail = _split_encode(EncoderSession(o, backend="tpu"), new_session(o, CPU), pcm, cut)
    assert tail == tail_ref
    tail = _split_encode(new_session(o, CPU), EncoderSession(o, backend="tpu"), pcm, cut)
    assert tail == tail_ref


def test_carry_from_jax_conversions():
    o = MP3EncoderOptions(mode=Mode.STEREO)
    state = {k: np.asarray(v) for k, v in jpipe.init_carry(2, o).items()}
    state["stream_len"] = np.array([5, 7], np.int32)
    carry = tpipe.carry_from_jax(state, CPU)
    back = tpipe.carry_to_jax(carry)
    assert sorted(back) == sorted(state)
    for k in state:
        assert back[k].dtype == state[k].dtype and np.array_equal(back[k], state[k])
    # pre-depth checkpoint: one buffered frame in prev_slot/has_buffered
    old = {k: v for k, v in state.items() if k != "slot_fifo"}
    old["prev_slot"] = np.array([417, 418], np.int32)
    old["has_buffered"] = np.array([True, False])
    fifo = tpipe.carry_from_jax(old, CPU)["slot_fifo"]
    assert fifo.tolist() == [[417], [0]]
    with pytest.raises(NotImplementedError):
        tpipe.carry_from_jax({**state, "seq_prev_short": np.zeros(2, bool)}, CPU)


@pytest.mark.parametrize(
    "kw",
    [
        dict(count1_coding=True),
        dict(iso_quantization=True, real_scalefactors=True),
        dict(iso_ms_matrix=True),
        dict(iso_mode_ext=True),
        dict(lowpass_hz=10000),
        dict(reservoir_mode="aligned", reservoir_depth=2),
        dict(free_format=True, bitrate_kbps=100),
        dict(sample_rate=22050, iso_quantization=True, reservoir_mode="aligned"),
    ],
    ids=lambda kw: ",".join(kw),
)
def test_unsupported_options_raise(kw):
    o = MP3EncoderOptions(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        new_session(o, CPU)
    with pytest.raises(NotImplementedError):
        BatchEncoder(o, 2, 4, CPU)


def test_hq_preset_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        tpipe.make_chunk_fn(MP3EncoderOptions.hq())


def test_import_loads_no_jax():
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'jaxlib')):\n"
        "            raise ImportError('jax import blocked: ' + name)\n"
        "before = {m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')}\n"
        "sys.meta_path.insert(0, Block())\n"
        "import swiftmp3_tpu_torch, swiftmp3_tpu_torch.encoder\n"
        "import swiftmp3_tpu_torch.parallel.batch, swiftmp3_tpu_torch.ops.kernels\n"
        "after = {m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')}\n"
        "assert after == before, sorted(after - before)\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr

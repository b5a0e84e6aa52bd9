"""The port's compat chunk program, sessions and batch encoder against the
JAX package (CPU).

- the chunk program against jax.jit(pipeline.make_chunk_fn): every
  fetch_outputs field exact, the carry within float tolerance;
- the 8 compat fixture rows byte-equal to the JAX backend's streams;
- drip-feed, batch and checkpoint invariances; LSF and free format build
  and encode through new_session and BatchEncoder;
- importing the port loads neither jax nor the JAX package.

Each package builds its own MP3EncoderOptions from the same keyword
arguments (channel modes named as strings).
"""

import dataclasses
import inspect
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.models import pipeline as jpipe
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.options import MP3EncoderOptions
from swiftmp3_tpu_torch.parallel import batch as tbatch
from swiftmp3_tpu_torch.parallel.batch import BatchEncoder, encode_batch

from .test_ulp_telemetry import _corpus_stereo
from . import torch_inputs as ti
from .torch_inputs import COMPAT_FIXTURES, fixture_path, make_signal
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")

CHUNK_OPTIONS = {
    "stereo": dict(mode="stereo"),
    "joint": dict(mode="joint_stereo"),
    "mono_vbr": dict(mode="mono", vbr=True, quality=3),
    "aligned_crc_48k": dict(
        mode="stereo", reservoir_mode="aligned", crc_protected=True, sample_rate=48000
    ),
    "iso_quant_32k": dict(mode="joint_stereo", iso_quantization=True, sample_rate=32000),
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
    jo_opts = JaxOptions(**CHUNK_OPTIONS[name])
    B, T = 2, 4
    final = np.zeros((B, T), bool)
    final[1, 2] = True
    valid = np.ones((B, T), bool)
    valid[1, 3] = False  # stream 1 ends inside the first chunk
    chunks = [
        (_chunk_input(o, B, T, 0), final, valid),
        (_chunk_input(o, B, T, 1), np.zeros((B, T), bool), np.ones((B, T), bool)),
    ]
    jrun = jax.jit(jpipe.make_chunk_fn(jo_opts))
    trun = tpipe.make_chunk_fn(o)
    jc = jpipe.init_carry(B, jo_opts)
    tc = tpipe.init_carry(B, o, CPU)
    for pcm, fin, val in chunks:
        jc, jo = jrun(jc, pcm, fin, val)
        tc, to = trun(tc, torch.from_numpy(pcm), torch.from_numpy(fin), torch.from_numpy(val))
        want = jpipe.fetch_outputs(jo, jo_opts)
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
        assert tpipe.main_data_cap(MP3EncoderOptions(**kw)) == jpipe.main_data_cap(
            JaxOptions(**kw)
        )
    o = MP3EncoderOptions(mode="joint_stereo")
    jo_opts = JaxOptions(mode="joint_stereo")
    B, T = 2, 3
    pcm = _chunk_input(o, B, T, 5)
    _, outs = tpipe.make_chunk_fn(o)(
        tpipe.init_carry(B, o, CPU), torch.from_numpy(pcm),
        torch.zeros(B, T, dtype=torch.bool), torch.ones(B, T, dtype=torch.bool),
    )
    packed = outs["packed"].numpy()
    got = tpipe.fetch_outputs(outs, o)
    want = jpipe.fetch_outputs({"packed": packed}, jo_opts)
    for b in range(B):
        for t in range(T):
            fr_t = tpipe.frame_results_from_outputs(got, o, t, b)
            fr_j = jpipe.frame_results_from_outputs(want, jo_opts, t, b)
            # GranuleInfo is each package's own dataclass: compare field by field
            assert [[dataclasses.astuple(g) for g in gr] for gr in fr_t.granules] == [
                [dataclasses.astuple(g) for g in gr] for gr in fr_j.granules
            ]
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
    kw = dict(mode="stereo", bitrate_kbps=128, sample_rate=44100)
    o = MP3EncoderOptions(**kw)
    bad = total = 0
    for pcm in _corpus_stereo().values():
        s = new_session(o, CPU)
        got = s.encode(pcm) + s.flush()
        g = EncoderSession(JaxOptions(**kw), backend="numpy")
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
    o = MP3EncoderOptions(mode="joint_stereo")
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
    o = MP3EncoderOptions(mode="stereo", vbr=True, quality=4)
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
    o = MP3EncoderOptions(mode="mono")
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
    o = MP3EncoderOptions(mode="joint_stereo")
    jo_opts = JaxOptions(mode="joint_stereo")
    pcm = make_signal("noise", 0.5, 44100, 2, 23)
    cut = 2 * 1152 * 9 + 500

    ref = EncoderSession(jo_opts, backend="tpu")
    ref.encode(pcm[:cut])
    tail_ref = ref.encode(pcm[cut:]) + ref.flush()

    tail = _split_encode(EncoderSession(jo_opts, backend="tpu"), new_session(o, CPU), pcm, cut)
    assert tail == tail_ref
    tail = _split_encode(new_session(o, CPU), EncoderSession(jo_opts, backend="tpu"), pcm, cut)
    assert tail == tail_ref


def test_carry_from_jax_conversions():
    state = {k: np.asarray(v) for k, v in jpipe.init_carry(2, JaxOptions(mode="stereo")).items()}
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
    # a window-sequencing checkpoint from before the raw-want and block-energy
    # carries gets zeros and +inf (no past), as the JAX backend converts it
    seq = tpipe.carry_from_jax({**state, "seq_prev_short": np.array([True, False])}, CPU)
    assert seq["seq_prev_want"].tolist() == [False, False]
    assert seq["onset_prev2"].shape == (2, 2, 2) and torch.isinf(seq["onset_prev2"]).all()
    # keys of no carry, or a sequencing carry for a session without it, raise
    with pytest.raises(ValueError):
        tpipe.carry_from_jax({**state, "prev_granule": np.zeros(2, bool)}, CPU)
    with pytest.raises(ValueError):
        tpipe.carry_from_jax(tpipe.carry_to_jax(seq), CPU, MP3EncoderOptions(mode="stereo"))


# The options ROADMAP Queue 1 item 11 brought, at the configurations where
# the port raised before it: free format at an off-table rate, and an LSF
# rate on the non-strict chunk program (ISO quantization, the aligned
# reservoir).
@pytest.mark.parametrize(
    "kw",
    [
        dict(free_format=True, bitrate_kbps=100),
        dict(sample_rate=22050, iso_quantization=True, reservoir_mode="aligned"),
    ],
    ids=lambda kw: ",".join(kw),
)
def test_lsf_and_free_format_build_and_encode(kw):
    """Both build and encode frames through new_session and BatchEncoder on
    the CPU, to the same bytes: LSF frames of 576 samples, free-format
    frames with header index 0."""
    o = MP3EncoderOptions(mode="stereo", **kw)
    pcm = make_signal("mix", 0.2, o.sample_rate, o.channels, 6)
    s = new_session(o, CPU)
    data = s.encode(pcm) + s.flush()
    frames = ti.walk_frames(data, o.bitrate_kbps if o.free_format else None)
    assert len(frames) >= 4
    if o.free_format:
        assert {f["bitrate_index"] for f in frames} == {0}
    else:
        assert {(f["version"], f["samples"]) for f in frames} == {("2", 576)}
    assert encode_batch(o, [pcm], CPU, frames_per_step=4) == [data]  # a BatchEncoder


# The flags ROADMAP Queue 1 items 9 and 10 brought, at the configurations
# where test_unsupported_options_raise held them to their items before:
# distortion control in hq mono 128 kbps, intensity stereo in hq joint
# stereo 32 kbps with the lowpass off.
@pytest.mark.parametrize(
    "kw",
    [
        dict(distortion_control=True, mode="mono"),
        dict(intensity_stereo=True, mode="joint_stereo", bitrate_kbps=32, lowpass_hz=None),
    ],
    ids=["distortion_control", "intensity_stereo"],
)
def test_distortion_and_intensity_build_and_encode(kw):
    """Both build and encode frames through new_session and BatchEncoder on
    the CPU, to the same bytes."""
    o = MP3EncoderOptions.hq(**kw)
    assert o.distortion_control_active or o.intensity_stereo_active
    pcm = make_signal("mix", 0.1, 44100, o.channels, 6)
    s = new_session(o, CPU)
    data = s.encode(pcm) + s.flush()
    assert len(parse_frames(data)) >= 4
    assert encode_batch(o, [pcm], CPU, frames_per_step=4) == [data]  # a BatchEncoder


def test_entry_points_default_to_the_card(monkeypatch):
    """new_session, TorchBackend, BatchEncoder and encode_batch run on
    "cuda" unless told otherwise; with no card they raise and do not run on
    the CPU."""
    defaults = [
        inspect.signature(new_session).parameters["device"].default,
        inspect.signature(tpipe.TorchBackend).parameters["device"].default,
        inspect.signature(BatchEncoder).parameters["device"].default,
        inspect.signature(encode_batch).parameters["device"].default,
    ]
    assert defaults == ["cuda"] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cpu_run(*args, **kwargs):
        raise AssertionError("a default call ran the chunk program")

    monkeypatch.setattr(tpipe, "init_carry", no_cpu_run)
    monkeypatch.setattr(tbatch, "init_carry", no_cpu_run)
    o = MP3EncoderOptions(mode="stereo")
    pcm = make_signal("sine", 0.1, 44100, 2, 0)
    for call in (
        lambda: new_session(o),
        lambda: tpipe.TorchBackend(o),
        lambda: BatchEncoder(o, 2, 4),
        lambda: encode_batch(o, [pcm]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_hq_preset_raises():
    """The hq preset builds at 128 kbps, with its rate-derived adaptive
    lowpass at 96 kbps, and (ROADMAP Queue 1 item 11) at an LSF rate, where
    it raised before: nothing of it raises any more."""
    tpipe.make_chunk_fn(MP3EncoderOptions.hq())
    tpipe.make_chunk_fn(MP3EncoderOptions.hq(bitrate_kbps=96))
    o = MP3EncoderOptions.hq(mode="mono", sample_rate=22050, bitrate_kbps=64)
    assert o.lsf and o.window_sequencing
    tpipe.make_chunk_fn(o)


def test_import_loads_no_jax():
    """Importing every module of the port loads neither jax nor any module
    of the JAX package (both are blocked; neither may already be loaded)."""
    code = (
        "import sys, importlib, importlib.abc, pkgutil\n"
        "BLOCKED = ('jax', 'jaxlib', 'swiftmp3_tpu')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('import blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import swiftmp3_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(swiftmp3_tpu_torch.__path__, 'swiftmp3_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'swiftmp3_tpu_torch.native.lib' in names and len(names) > 25, names\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr

"""LSF sample rates and free format in the port against the JAX package (CPU).

- the ops the one-granule frame adds equal the JAX ops on seeded inputs at
  22 050, 16 000 and 8 000 Hz: the case-0 scalefactor finisher
  (`_finish_slots_lsf_device`) and both scalefactor dispatches with `lsf`
  (long, short and the 6-band mixed head; every field exactly, mag_scale
  bit for bit), the entropy layout with the band-derived region-0 boundary
  of switching granules (`b0_switch`; every integer), the boundary's rule
  by block type, the MPEG-2 bitrate lookup, the mixed reorders (true
  permutations at every LSF rate), and the filterbank at an odd number of
  LSF frames (T = 1, 3, 5: 18T windows, padded to the 4-a-row packing)
  within the JAX filterbank tests' tolerance (atol 2e-4, and 4e-6 x the
  output's scale);
- main_data_cap equals the JAX function at every configuration the card
  drives and the frozen rows use;
- sessions on the rows of tests/torch_inputs.LSF_ROWS and FF_ROWS equal the
  JAX backend's bytes frozen under tests/fixtures/torch/ by
  tests/torch_freeze_fixtures.py (no JAX chunk program is compiled here);
  their frames carry the MPEG-2 or 2.5 header and 576 samples (free format:
  index 0, 489 or 490 bytes, the Info frame too); the 8 kHz row emits mixed
  blocks where the JAX stream does, and keeps its bytes when its chunks
  hold an odd number of frames (a session of 7-frame chunks, encode_batch
  at 5 frames a step); without iso_short_blocks mixed verdicts code as
  short blocks, as in the JAX stream; the rows' signals are copies of the
  reference tests' makers;
- an hq LSF session checkpoint crosses between the packages both ways;
- encode_batch at LSF (uneven lengths) and a StreamPool at 16 kHz equal the
  port's sessions, and the native renderer the Python FrameAssembler;
- encode_corpus at the benchmark's LSF configuration (spec_strict joint
  stereo, 64 kbps, 22 050 Hz) writes the golden backend's session files,
  and an LSF strict step records the span names of an MPEG-1 strict step.

The JAX ops run under a few small jax.jit compiles.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmp3_tpu import tables as jtables
from swiftmp3_tpu.decoder.decoder import _iter_frames, parse_frame
from swiftmp3_tpu.models import pipeline as jpipe
from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu.options import Mode as JaxMode
from swiftmp3_tpu_torch.encoder import EncoderSession, new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.options import MP3EncoderOptions
from swiftmp3_tpu_torch.parallel import BatchEncoder, StreamPool, encode_batch
from swiftmp3_tpu_torch.parallel import batch as tbatch

from . import torch_inputs as ti
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")
OP_RATES = (22050, 16000, 8000)
LSF_RATES = (22050, 24000, 16000, 11025, 12000, 8000)
ROWS = [*ti.LSF_ROWS, *ti.FF_ROWS]
ODD_ROW = "lsf_strict_mono48_8k_mixed"


def _t(a):
    return torch.from_numpy(np.array(a))


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _encode(session, pcm) -> bytes:
    return session.encode(pcm) + session.flush()


def _free(o) -> int | None:
    return o.bitrate_kbps if o.free_format else None


@functools.lru_cache(maxsize=None)
def _port_stream(row: str) -> bytes:
    return _encode(new_session(ti.lsf_row_options(row, MP3EncoderOptions), CPU), ti.lsf_row_pcm(row))


# --- seeded op inputs ---------------------------------------------------------------


def _spectra(n: int, seed: int) -> np.ndarray:
    """[n, 576] spectra with levels over 5 decades, band levels over 14, silent
    granules, silent bands and zero tails: every slot's scalefactor from 0
    up to its cap, every group's slen from 0 to its maximum."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n, 576)) * 10 ** rng.uniform(-4, 1, (n, 1))
    s *= 10 ** -rng.uniform(0, 14, (n, 48)).repeat(12, axis=1)  # band levels
    s[rng.random((n, 576)) < 0.02] *= 50.0
    for i in range(n):
        lo = int(rng.integers(0, 560))
        if rng.random() < 0.4:
            s[i, lo : lo + int(rng.integers(4, 64))] = 0.0
        if rng.random() < 0.3:
            s[i, int(rng.integers(100, 576)) :] = 0.0
    s[:2] = 0.0
    return s.astype(np.float32)


def _blocks(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice([tdsp.BLOCK_LONG, tdsp.BLOCK_SHORT, tdsp.BLOCK_MIXED], n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_scalefactors(sr: int):
    def run(spec, block):
        return [
            jdsp.granule_scalefactors_device(spec, sr, block, psy=psy, iso_short=True, lsf=True)
            for psy in (False, True)
        ]

    return jax.jit(run)


@pytest.mark.parametrize("sr", OP_RATES)
def test_lsf_scalefactors_match_jax(sr):
    """granule_scalefactors_device(lsf=True) on long, short and mixed
    granules (both laws): every field exactly, the 9-bit compress below 400
    (case 0) and reaching past the 4-bit range, mixed granules on the
    6-band head (33 slots)."""
    n = 240
    spec, block = _spectra(n, seed=sr % 97), _blocks(n, seed=sr % 89)
    want = _jax_scalefactors(sr)(spec, block)
    for psy, w in zip((False, True), want):
        got = tdsp.granule_scalefactors_device(_t(spec), sr, _t(block), psy=psy, iso_short=True, lsf=True)
        assert sorted(got) == sorted(w)
        for k in w:
            g, e = got[k].numpy(), np.asarray(w[k])
            assert g.dtype == e.dtype and g.tobytes() == e.tobytes(), (psy, k)
    compress = want[0]["compress"]
    assert int(compress.max()) < 400 and int(compress.max()) > 15
    mixed = block == tdsp.BLOCK_MIXED
    assert not np.asarray(want[0]["slot_nbits"])[mixed][:, 33:].any()
    assert np.asarray(want[0]["sf_slots"])[mixed][:, 6:33].any()


@functools.lru_cache(maxsize=None)
def _jax_finish(ns: tuple):
    return jax.jit(lambda slots: jdsp._finish_slots_lsf_device(slots, ns))


@pytest.mark.parametrize("ns", [tdsp.LSF_NSF_LONG, tdsp.LSF_NSF_SHORT, tdsp.LSF_NSF_MIXED],
                         ids=["long", "short", "mixed"])
def test_finish_slots_lsf_matches_jax(ns):
    """The case-0 finisher on slot values up to each group's cap (15, 15,
    7, 7), every slen from 0 up: compress, slens, slot widths and part2."""
    rng = np.random.default_rng(sum(ns))
    caps = np.repeat([15, 15, 7, 7], ns)
    slots = np.zeros((400, tdsp.SF_SLOTS), np.int32)
    top = rng.integers(0, 5, (400, 4))  # a bit length per group
    for k, (lo, hi) in enumerate(zip(np.cumsum((0,) + ns[:-1]), np.cumsum(ns))):
        group_cap = np.minimum(((1 << top[:, k]) - 1)[:, None], caps[lo:hi])
        slots[:, lo:hi] = np.minimum(rng.integers(0, 16, (400, hi - lo)), group_cap)
    got = tdsp._finish_slots_lsf_device(_t(slots), ns)
    want = _jax_finish(ns)(slots)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    assert len(np.unique(np.asarray(want["compress"]))) > 50


@functools.lru_cache(maxsize=None)
def _jax_layout(sr: int, linbits: bool):
    def run(q, is_long, b0):
        return jdsp.strict_layout_device(q, sr, is_long, True, True, linbits=linbits, b0_switch=b0)

    return jax.jit(run)


@pytest.mark.parametrize("sr", OP_RATES)
def test_strict_layout_with_b0_switch_matches_jax(sr):
    """The entropy layout of switching granules with their band-derived
    region-0 boundary (SHORT, MIXED, START, STOP by the chunk program's
    rule), linbits on at 16 kHz: every integer the layout returns."""
    n = 320
    rng = np.random.default_rng(sr % 83)
    linbits = sr == 16000
    cap = 40 if linbits else 15
    q = rng.integers(-cap, cap + 1, (n, 576)) * (rng.random((n, 576)) < 0.4)
    q = np.where(np.arange(576) < rng.integers(0, 577, (n, 1)), q, 0).astype(np.int32)
    block = rng.choice(
        [tdsp.BLOCK_LONG, tdsp.BLOCK_SHORT, tdsp.BLOCK_MIXED, tdsp.BLOCK_START, tdsp.BLOCK_STOP], n
    ).astype(np.int32)
    is_long = block == tdsp.BLOCK_LONG
    b0 = tpipe.switch_region0(_t(block), sr)
    got = tdsp.strict_layout_device(_t(q), sr, _t(is_long), True, True, linbits=linbits, b0_switch=b0)
    want = _jax_layout(sr, linbits)(q, is_long, b0.numpy())
    for k in want:
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), k
    # region 0 of switching granules ends off the MPEG-1 constant 36 (54 or
    # 72 at 22.05 and 16 kHz, up to 108 at 8 kHz)
    assert set(np.unique(np.asarray(want["b0"])[~is_long])) - {36}


@pytest.mark.parametrize("sr", LSF_RATES)
def test_switch_region0_is_the_jax_rule(sr):
    """pipeline.py:567-584 by block type: SHORT switch_bound(sr, True),
    MIXED mixed_switch_bound(sr), START/STOP (and LONG, unread)
    switch_bound(sr, False); the mixed reorders are permutations that keep
    the head (3 short bands' lines) in natural order."""
    blocks = np.arange(5, dtype=np.int32)
    want = np.where(
        blocks == jdsp.BLOCK_SHORT,
        jtables.switch_bound(sr, True),
        np.where(blocks == jdsp.BLOCK_MIXED, jtables.mixed_switch_bound(sr),
                 jtables.switch_bound(sr, False)),
    )
    got = tpipe.switch_region0(_t(blocks), sr)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    perms = tdsp.build_reorder_perms(sr)
    for p in perms:
        assert np.array_equal(np.sort(p), np.arange(576))
    head = 3 * int(tdsp.short_band_bounds(sr)[3])
    assert np.array_equal(perms[1][:head], np.arange(head))
    assert head == (72 if sr == 8000 else 36)
    assert np.array_equal(perms[1], np.asarray(jtables.mixed_reorder_src(sr)))


def test_bitrate_value_device_lsf():
    idx = np.arange(16, dtype=np.int32)
    for lsf in (False, True):
        got = tdsp.bitrate_value_device(_t(idx), lsf=lsf).numpy()
        want = np.asarray(jdsp.bitrate_value_device(jnp.asarray(idx), lsf=lsf))
        assert np.array_equal(got, want)
    assert tpipe.LSF_L3_BITRATES == jpipe.LSF_VBR_BITRATES


@pytest.mark.parametrize("T", [1, 3, 5])
def test_polyphase_odd_lsf_chunk_matches_jax(T):
    """An odd number of LSF frames (18T windows, T odd: two zero windows
    pad the packing and are sliced off); x (the carried history's source)
    exactly."""
    rng = np.random.default_rng(30 + T)
    hist = rng.standard_normal((3, 2, 480)).astype(np.float32)
    pcm = rng.standard_normal((3, 2, T * 576)).astype(np.float32)
    S_j, x_j = jdsp.polyphase_chunk_matmul(jnp.asarray(hist), jnp.asarray(pcm))
    S_t, x_t = tdsp.polyphase_chunk_matmul(_t(hist), _t(pcm))
    assert S_t.shape == (3, 2, 18 * T, 32)
    assert np.array_equal(x_t.numpy(), np.asarray(x_j))
    S_j = np.asarray(S_j)
    np.testing.assert_allclose(S_t.numpy(), S_j, rtol=0, atol=2e-4)
    assert float(np.abs(S_t.numpy() - S_j).max()) <= 4e-6 * max(float(np.abs(S_j).max()), 1.0)
    # the same windows as a longer, even chunk's head
    S_e, _ = tdsp.polyphase_chunk_matmul(_t(hist), _t(np.concatenate([pcm, pcm[..., :576]], -1)))
    np.testing.assert_allclose(S_e[..., : 18 * T, :].numpy(), S_t.numpy(), rtol=0, atol=1e-6)


# (factory, kwargs): the card's LSF and free-format phases and every frozen row
CAP_CONFIGS = [
    ("spec_strict", dict(sample_rate=22050, bitrate_kbps=64, mode="joint_stereo")),
    ("hq", dict(sample_rate=16000, bitrate_kbps=48, mode="mono")),
    (None, dict(sample_rate=22050, bitrate_kbps=64, iso_quantization=True, reservoir_mode="aligned")),
    ("spec_strict", dict(mode="mono", bitrate_kbps=150, free_format=True, linbits_tables=True)),
    *((f, kw) for f, kw, _ in [*ti.LSF_ROWS.values(), *ti.FF_ROWS.values()]),
    ("spec_strict", dict(sample_rate=8000, bitrate_kbps=8, mode="mono", crc_protected=True)),
    ("hq", dict(sample_rate=24000, bitrate_kbps=160, mode="stereo", vbr=True, vbr_demand=True)),
]
# main_data_cap of the first four: the pack caps of the card's phases
CARD_CAPS = (444, 460, 444, 982)


@pytest.mark.parametrize("i", range(len(CAP_CONFIGS)))
def test_main_data_cap_matches_jax(i):
    factory, kw = CAP_CONFIGS[i]
    jkw = dict(kw, mode=JaxMode(kw.get("mode", "stereo")))
    kw = dict(kw, mode=kw.get("mode", "stereo"))
    o = getattr(MP3EncoderOptions, factory)(**kw) if factory else MP3EncoderOptions(**kw)
    jo = getattr(JaxOptions, factory)(**jkw) if factory else JaxOptions(**jkw)
    assert tpipe.main_data_cap(o) == jpipe.main_data_cap(jo)
    if i < len(CARD_CAPS):
        assert tpipe.main_data_cap(o) == CARD_CAPS[i]


# --- sessions against the JAX bytes -----------------------------------------------


def test_lsf_signal_copies_equal_the_originals():
    """torch_inputs' numpy-only copies of tests/test_lsf_encode.py's signal
    makers (chip_smoke.py imports no test module of the JAX package)."""
    from .test_lsf_encode import _content, _mixed_content

    for sr, seconds, seed in ((16000, 1.0, 3), (24000, 0.75, 5), (22050, 1.1, 3)):
        for channels in (1, 2):
            want = _content(sr, seconds, stereo=channels == 2, seed=seed).reshape(-1)
            assert ti.lsf_content(sr, seconds, channels, seed).tobytes() == want.tobytes()
    assert ti.lsf_mixed_content(8000, 30, 3).tobytes() == _mixed_content(8000).tobytes()


@pytest.mark.parametrize("row", ROWS)
def test_lsf_session_matches_the_jax_bytes(row):
    assert _port_stream(row) == _read(ti.jax_path(row))


@pytest.mark.parametrize("row", ROWS)
def test_lsf_frames_carry_their_header(row):
    """MPEG-2 or 2.5 headers and 576 samples a frame at LSF rates; free
    format: index 0 in every header, 489 or 490 bytes; the walk agrees with
    the JAX package's decoder walk."""
    o = ti.lsf_row_options(row, MP3EncoderOptions)
    data = _port_stream(row)
    frames = ti.walk_frames(data, _free(o))
    ref = list(_iter_frames(data))
    assert [(f["offset"], f["size"]) for f in frames] == [(f.offset, f.size) for f in ref]
    if o.free_format:
        assert {f["bitrate_index"] for f in frames} == {0}
        assert {f["size"] for f in frames} <= {489, 490} and len(frames) >= 6
    else:
        assert {f["version"] for f in frames} == {"2.5" if o.sample_rate <= 12000 else "2"}
        assert {f["samples"] for f in frames} == {576}
        assert {f["sample_rate"] for f in frames} == {o.sample_rate}
        assert len(frames) * 576 >= len(ti.lsf_row_pcm(row)) // o.channels


def _block_kinds(data: bytes) -> list:
    """(block_type, mixed_block_flag) of each granule, frame by frame."""
    return [
        [(g.block_type, g.mixed_block_flag) for gr in fi.granules for g in gr]
        for fi in (parse_frame(data, f.offset) for f in _iter_frames(data))
    ]


def test_8k_mixed_blocks_sit_where_the_jax_stream_has_them():
    kinds = _block_kinds(_port_stream(ODD_ROW))
    assert kinds == _block_kinds(_read(ti.jax_path(ODD_ROW)))
    assert sum(k == (2, 1) for f in kinds for k in f) >= 5


def test_mixed_blocks_demote_to_short_without_iso_short_blocks():
    """Without iso_short_blocks an LSF mixed verdict codes as a short block,
    per channel and in the M/S frames' shared layout (pipeline.py:380-401):
    the JAX stream's block types, no mixed granule."""
    row = "lsf_strict_noshort_joint48_22k_mixed"
    kinds = _block_kinds(_port_stream(row))
    assert kinds == _block_kinds(_read(ti.jax_path(row)))
    flat = [k for f in kinds for k in f]
    assert (2, 1) not in flat and flat.count((2, 0)) >= 5


@pytest.mark.parametrize("row", ROWS)
def test_odd_step_batch_matches_the_jax_odd_step_batch(row):
    """encode_batch at ODD_STEP (7) frames a step equals the JAX package's
    encode_batch at 7 frames a step, frozen as jax_<row>_step7.mp3. At LSF
    rates an odd chunk moves the next chunk's frames to the other half of
    the folded filterbank's 4-window rows: on the no-iso_short_blocks row
    the JAX package's own bytes then differ from its 8-frame session's in 4
    of 30 frames (a float order, ROADMAP Queue 3), and the port's with
    them."""
    o = ti.lsf_row_options(row, MP3EncoderOptions)
    got = encode_batch(o, [ti.lsf_row_pcm(row)], CPU, frames_per_step=ti.ODD_STEP)[0]
    want = _read(ti.jax_path(f"{row}_step{ti.ODD_STEP}"))
    assert got == want
    if row == "lsf_strict_noshort_joint48_22k_mixed":
        frames = ti.walk_frames(want)
        ref = _read(ti.jax_path(row))
        assert [f["size"] for f in frames] == [f["size"] for f in ti.walk_frames(ref)]
        assert sum(want[f["offset"] : f["offset"] + f["size"]] != ref[f["offset"] : f["offset"] + f["size"]]
                   for f in frames) == 4


@pytest.mark.parametrize("how", ["session_chunk7", "batch_step5"])
def test_odd_chunks_keep_the_jax_bytes(how):
    """The 8 kHz row through chunks of an odd number of frames (the
    filterbank's padded windows reach neither the MDCT nor the carry)."""
    o = ti.lsf_row_options(ODD_ROW, MP3EncoderOptions)
    pcm = ti.lsf_row_pcm(ODD_ROW)
    if how == "session_chunk7":

        class Chunk7(tpipe.TorchBackend):
            CHUNK = 7

        got = _encode(EncoderSession(o, Chunk7(o, CPU)), pcm)
    else:
        got = encode_batch(o, [pcm], CPU, frames_per_step=5)[0]
    assert got == _read(ti.jax_path(ODD_ROW))


def test_free_format_info_frame():
    """The Xing/Info frame carries index 0 and the audio frames' size;
    without the flag an off-table rate is coerced to the nearest entry; VBR
    is refused."""
    row = "ff_strict_mono150_44k_noise"
    o = ti.lsf_row_options(row, MP3EncoderOptions)
    s = new_session(o, CPU)
    audio = _encode(s, ti.lsf_row_pcm(row))
    frames = ti.walk_frames(s.generate_xing_header() + audio, o.bitrate_kbps)
    assert frames[0]["bitrate_index"] == 0 and frames[0]["size"] == 489
    # without the flag the off-table rate is coerced to the nearest entry
    coerced = MP3EncoderOptions.spec_strict(mode="mono", bitrate_kbps=150, linbits_tables=True)
    data = _encode(new_session(coerced, CPU), ti.lsf_row_pcm(row))
    assert {f.bitrate_kbps for f in parse_frames(data)} == {160}
    # free format is CBR-only, as in the reference's options
    with pytest.raises(ValueError, match="CBR-only"):
        MP3EncoderOptions(free_format=True, vbr=True)


def test_lsf_checkpoint_jax_to_port_and_back():
    """A session checkpoint in the middle of the hq LSF row: the port
    resumes from the JAX backend's and gives the JAX stream; the port's own
    checkpoint there is, bit for bit, the one the JAX backend resumed from
    to give its unbroken stream when tests/torch_freeze_fixtures.py froze
    it (the 255-capped counters, the one-granule sequencer state)."""
    row, cut = ti.LSF_CHECKPOINT
    o = ti.lsf_row_options(row, MP3EncoderOptions)
    pcm = ti.lsf_row_pcm(row)
    whole = _read(ti.jax_path(row))
    jax_state, extra = ti.load_session_state(ti.checkpoint_path("jax", row))
    head = int(extra["head_len"])
    assert {"seq_prev_short", "onset_prev2"} <= set(jax_state["backend"])
    s = new_session(o, CPU)
    s.load_state_dict(jax_state)
    assert whole[:head] + s.encode(pcm[cut:]) + s.flush() == whole
    s = new_session(o, CPU)
    assert s.encode(pcm[:cut]) == whole[:head]
    mine = s.state_dict()
    frozen, _ = ti.load_session_state(ti.checkpoint_path("port", row))
    for k in ("fed", "fed_samples", "reservoir_avail", "buffered_slots", "frame_count",
              "total_bytes", "frame_sizes"):
        assert mine[k] == frozen[k], k
    assert bytes(mine["reservoir_stream"]) == frozen["reservoir_stream"]
    assert [bytes(h) for h in mine["buffered_heads"]] == frozen["buffered_heads"]
    assert mine["pcm"].tobytes() == frozen["pcm"].tobytes()
    assert sorted(mine["backend"]) == sorted(frozen["backend"])
    for k, v in mine["backend"].items():
        assert v.dtype == frozen["backend"][k].dtype and v.tobytes() == frozen["backend"][k].tobytes(), k


# --- batch, pool and the renderers ------------------------------------------------


def _uneven(o, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [
        (0.3 * rng.standard_normal((576 * k + j) * o.channels)).astype(np.float32)
        for k, j in ((9, 100), (13, 0), (4, 17))
    ]


def test_lsf_encode_batch_matches_sessions():
    """Uneven lengths under hq at 16 kHz (the lookahead is the next frame's
    whole granule), 6 frames a step (tests/test_lsf_encode.py:349-366)."""
    o = MP3EncoderOptions.hq(sample_rate=16000, bitrate_kbps=48, mode="mono")
    streams = _uneven(o, 3)
    got = encode_batch(o, streams, CPU, frames_per_step=6)
    assert got == [_encode(new_session(o, CPU), s) for s in streams]


def test_lsf_pool_matches_sessions():
    """A StreamPool at 16 kHz (576-sample frames, an odd step of 5 frames,
    the sequencing holdback), streams fed whole and drip-fed."""
    o = MP3EncoderOptions.hq(sample_rate=16000, bitrate_kbps=48, mode="mono")
    streams = _uneven(o, 4)
    pool = StreamPool(o, lanes=2, frames_per_step=5, device=CPU)
    try:
        sids = [pool.submit() for _ in streams]
        pool.feed(sids[0], streams[0])
        pool.close(sids[0])
        for piece in np.array_split(streams[1], 4):
            pool.feed(sids[1], piece)
            pool.step()
        pool.close(sids[1])
        pool.feed(sids[2], streams[2])
        pool.close(sids[2])
        pool.run_until_idle()
        got = [pool.result(sid) for sid in sids]
    finally:
        pool.shutdown()
    assert got == [_encode(new_session(o, CPU), s) for s in streams]


def test_lsf_corpus_and_cli_files(tmp_path):
    """encode_corpus at 16 kHz writes [ID3][Xing][frames] as a session
    does (the Xing frame an MPEG-2 one), and the command line encodes a
    16 kHz WAV to the same file as its session."""
    from swiftmp3_tpu_torch import cli
    from swiftmp3_tpu_torch.options import ID3Tag
    from swiftmp3_tpu_torch.parallel import encode_corpus
    from swiftmp3_tpu_torch.utils import read_wav, write_wav

    o = MP3EncoderOptions.hq(sample_rate=16000, bitrate_kbps=48, mode="mono",
                             id3_tag=ID3Tag(title="lsf"))
    streams = _uneven(o, 5)[:2]
    for pcm, data in zip(streams, encode_corpus(o, streams, device=CPU, frames_per_step=5)):
        s = new_session(o, CPU)
        audio = _encode(s, pcm)
        xing = s.generate_xing_header()
        assert data == s.generate_id3_tag() + xing + audio
        assert ti.walk_frames(xing + audio)[0]["version"] == "2"
    wav, out = str(tmp_path / "in.wav"), str(tmp_path / "out.mp3")
    write_wav(wav, streams[0], 16000, 1)
    assert cli.main([wav, out, "--hq", "--bitrate", "48", "--device", "cpu", "--quiet"]) == 0
    pcm, sr, _ = read_wav(wav)
    s = new_session(MP3EncoderOptions.hq(sample_rate=sr, bitrate_kbps=48, mode="mono",
                                         lowpass_hz=None), CPU)
    audio = _encode(s, pcm)
    with open(out, "rb") as fh:
        assert fh.read() == s.generate_xing_header() + audio


def _lsf_strict64(**kw):
    """The benchmark's LSF configuration (portbench/configs/lsf_strict64.json):
    spec_strict joint stereo at 64 kbps and 22 050 Hz."""
    return MP3EncoderOptions.spec_strict(mode="joint_stereo", bitrate_kbps=64, sample_rate=22050, **kw)


def _stereo_streams(seed: int) -> list:
    """Three int16 stereo streams of uneven length (whole frames, a partial
    frame, a partial granule's worth), correlated channels so M/S engages."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (576 * 9 + 100, 576 * 6, 576 * 4 + 17):
        mono = rng.standard_normal(n + 8)
        for i in range(1, 8):
            mono[i:] += mono[:-i] / (i + 1)
        left = 0.4 * np.sin(np.arange(n) * 0.05) + 0.05 * mono[:n]
        right = 0.8 * left + 0.05 * mono[8:]
        out.append((np.stack([left, right], axis=-1).reshape(-1) * 20000).astype(np.int16))
    return out


def test_lsf_strict64_corpus_files_equal_golden_sessions():
    """encode_corpus at the benchmark's LSF configuration, 4 frames a step,
    writes [ID3][Xing][frames] byte-equal to the golden backend's session
    files: MPEG-2 headers at 64 kbps, 208/209-byte frames of 576 samples."""
    from swiftmp3_tpu_torch.options import ID3Tag
    from swiftmp3_tpu_torch.parallel import encode_corpus

    o = _lsf_strict64()
    streams = _stereo_streams(18)
    tags = [ID3Tag(title=f"Spot {i}", artist="lsf", track=i + 1) for i in range(len(streams))]
    files = encode_corpus(o, streams, tags=tags, device=CPU, frames_per_step=4)
    for pcm, tag, data in zip(streams, tags, files):
        s = new_session(_lsf_strict64(id3_tag=tag), CPU, backend="numpy")
        audio = _encode(s, pcm)
        xing = s.generate_xing_header()
        assert data == s.generate_id3_tag() + xing + audio
        frames = ti.walk_frames(xing + audio)
        assert {(f["version"], f["sample_rate"], f["samples"]) for f in frames} == {("2", 22050, 576)}
        assert {(f["bitrate_kbps"], f["size"]) for f in frames[1:]} == {(64, 208), (64, 209)}


def test_lsf_strict_step_emits_the_spans_of_an_mpeg1_strict_step():
    """Under profiling.enable() a CPU LSF strict step records the same span
    names as an MPEG-1 strict step: every LSF-only branch runs inside one of
    the chunk program's phases."""
    from swiftmp3_tpu_torch.parallel import encode_corpus
    from swiftmp3_tpu_torch.utils import profiling

    def names(o, n_frame):
        pcm = (np.sin(np.arange(n_frame * 6) * 0.05) * 12000).astype(np.int16)
        profiling.disable()
        profiling.reset()
        profiling.enable()
        try:
            encode_corpus(o, [pcm], device=CPU, frames_per_step=4)
        finally:
            profiling.disable()
        got = set(profiling.snapshot()["totals"])
        profiling.reset()
        return got

    lsf = names(_lsf_strict64(), 576 * 2)
    mpeg1 = names(MP3EncoderOptions.spec_strict(mode="joint_stereo", bitrate_kbps=128), 1152 * 2)
    assert lsf == mpeg1
    assert {"chunk.phase1", "chunk.scalefactors", "chunk.sweep", "chunk.loop_t", "chunk.finalize",
            "chunk.pack", "batch.build", "drain.render"} <= lsf


@pytest.mark.parametrize(
    "sr,kbps,mode,preset",
    [(16000, 48, "mono", "hq"), (22050, 64, "joint_stereo", "hq"),
     (8000, 32, "mono", "spec_strict"), (24000, 96, "stereo", "spec_strict")],
)
def test_native_matches_python_lsf(sr, kbps, mode, preset):
    """encode_batch through the port's native renderer gives the LSF bytes
    of its FrameAssembler over the same chunks (one-granule side info,
    8-bit main_data_begin, 9-bit scalefac_compress, MPEG-2 and 2.5 headers;
    tests/test_native.py:99)."""
    rng = np.random.default_rng(sr % 101)
    base = [
        (rng.standard_normal(1152 * 3 + 400) * 0.4).astype(np.float32),
        (np.sin(np.arange(1152 * 5) * 0.07) * 0.6).astype(np.float32),
    ]
    streams = [np.stack([s, 0.8 * s], axis=-1).reshape(-1) if mode != "mono" else s for s in base]
    o = getattr(MP3EncoderOptions, preset)(mode=mode, bitrate_kbps=kbps, sample_rate=sr)
    native = encode_batch(o, streams, CPU, frames_per_step=4)
    chunks = tbatch._Chunks(o, streams, len(streams), 4)
    enc = BatchEncoder(o, len(streams), 4, CPU, render_threads=1)
    ref = ti.AssemblerRender(o, len(streams))
    python = [bytearray() for _ in streams]
    for start in range(0, chunks.frames, 4):
        pcm, final, valid, la = chunks.build(start, chunks.frames)
        for b, chunk in enumerate(ref.drain(enc.step(pcm, final, valid, la), valid)):
            python[b] += chunk
    for b, tail in enumerate(ref.flush()):
        python[b] += tail
    assert native == [bytes(x) for x in python]
    assert all(ti.walk_frames(d)[0]["samples"] == 576 for d in native)

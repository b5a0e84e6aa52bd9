"""The rest of the hq flags in the port against the JAX package (CPU): the
static and adaptive lowpass, demand VBR and reservoir depth > 1.

- the adaptive lowpass decision equals the JAX op's on the same spectra,
  seeded to straddle both of its thresholds; the lowpass stage masks as the
  reference's does, and always in a non-LONG granule;
- demand VBR's bitrate choice equals the golden encoder's law at every slot
  boundary of its band, and the JAX chunk program's choice in every frame of
  its frozen streams;
- sessions on five hq configurations (96 kbps mono and joint stereo, where
  the preset engages its adaptive lowpass; a static 10 kHz lowpass; demand
  VBR at quality 5; depth 3 on sparse transients) equal the JAX backend's
  bytes frozen under tests/fixtures/torch/ by tests/torch_freeze_fixtures.py
  (no JAX chunk program is compiled here). Two rows sit on a float knife
  edge: there the port is held to the stream structure, and the port with
  the JAX MDCT in place of its own reproduces the JAX bytes exactly;
- every row is structurally equal to the golden encoder's, and demand VBR
  keeps the telemetry suite's flip ceiling on its corpus;
- a depth-3 session checkpoint crosses between the packages mid-stream.

The JAX ops run under a few small jax.jit compiles.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from swiftmp3_tpu.models import pipeline as jpipe
from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu.ops.reference import MPEG1_L3_BITRATES
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu.options import Mode as JaxMode
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.options import MP3EncoderOptions

from . import torch_inputs as ti
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")
SR = 44100
FLAG_ROWS = [f"{p}_{stem}" for p in ti.HQ_FLAG_OPTIONS for stem in ti.hq_flag_streams(p)]
# Frozen JAX rows the port's CPU session does not reproduce byte for byte (1
# of 13 and 1 of 17 frames): the two MDCTs sum in another order and a few
# ULPs of spectrum move a quantization knife edge
# (test_knife_edge_rows_match_with_the_jax_mdct). ROADMAP Queue 3 logs them.
KNIFE_EDGE_ROWS = {"hq_joint_96k_corpus_burst": 1, "hq_mono_96k_depth3_sparse": 1}
# Frames of the telemetry corpus (78) whose bytes may differ from the golden
# encoder's under demand VBR: tests/test_ulp_telemetry.py's hq_vbr_demand_q5
# ceiling (it measured 12/78).
VBR_DEMAND_FLIP_CEILING = 20


def _row(row: str) -> tuple[str, str]:
    preset = max((p for p in ti.HQ_FLAG_OPTIONS if row.startswith(p + "_")), key=len)
    return preset, row[len(preset) + 1 :]


def _options(preset: str) -> MP3EncoderOptions:
    return MP3EncoderOptions.hq(**ti.HQ_FLAG_OPTIONS[preset])


def _encode(o, pcm) -> bytes:
    s = new_session(o, CPU)
    return s.encode(pcm) + s.flush()


@functools.lru_cache(maxsize=None)
def _port_stream(row: str) -> bytes:
    preset, stem = _row(row)
    return _encode(_options(preset), ti.hq_flag_streams(preset)[stem])


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _flips(got: bytes, ref: bytes) -> int:
    """Frames whose bytes differ; the structure (every frame's size and
    header) must be equal."""
    fg, fr = parse_frames(got), parse_frames(ref)
    assert [(f.size, got[f.offset : f.offset + 4]) for f in fg] == [
        (f.size, ref[f.offset : f.offset + 4]) for f in fr
    ]
    return sum(
        got[a.offset : a.offset + a.size] != ref[b.offset : b.offset + b.size]
        for a, b in zip(fg, fr)
    )


# --- the lowpass ------------------------------------------------------------------


def _lowpass_spectra(cut_sb: int, seed: int) -> np.ndarray:
    """Granules [6, 64, 576] whose high bands (from cut_sb * 18) straddle both
    thresholds of the adaptive decision: peaky bands whose energy fraction
    runs across 1e-3; peak-plus-noise bands whose flatness runs across 0.15;
    plain noise; silent high bands and silent granules."""
    rng = np.random.default_rng(seed)
    lo = cut_sb * 18
    n_lo, n_hb = lo, 576 - lo
    out = []
    for kind in range(6):
        spec = rng.standard_normal((64, 576)).astype(np.float64)
        hb = rng.standard_normal((64, n_hb)) * 0.05  # the noise floor
        peaks = rng.integers(0, n_hb, (64, 3))
        if kind in (0, 1):  # peaky: flatness far below 0.15, fraction near 1e-3
            hb[np.arange(64)[:, None], peaks] = 40.0
            energy = (hb**2).sum(axis=1, keepdims=True)
            frac = 1e-3 * 10 ** rng.uniform(-0.25, 0.25, (64, 1))
            hb *= np.sqrt(frac * n_lo / energy / (1 - frac))
        elif kind in (2, 3):  # peaks over noise: flatness near 0.15
            ratio = 0.9 * 10 ** rng.uniform(-0.4, 0.4, 64)
            hb[np.arange(64)[:, None], peaks] = np.sqrt(ratio * n_hb * 0.05**2 / 3)[:, None]
            hb *= 20.0
        elif kind == 4:  # noise
            hb *= 10 ** rng.uniform(-3, 1, (64, 1))
        else:  # silent high bands, then silent granules
            hb[:] = 0.0
            spec[32:] = 0.0
        spec[:, lo:] = hb
        out.append(spec)
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_engage():
    return jax.jit(jdsp.adaptive_lowpass_engage, static_argnums=1)


def _engage_stats(spec: np.ndarray, cut_sb: int) -> tuple[np.ndarray, np.ndarray]:
    hb2 = spec[..., cut_sb * 18 :].astype(np.float64) ** 2
    frac = hb2.sum(-1) / np.maximum((spec.astype(np.float64) ** 2).sum(-1), 1e-30)
    sfm = np.exp(np.log(hb2 + 1e-20).mean(-1)) / (hb2.mean(-1) + 1e-20)
    return frac, sfm


@pytest.mark.parametrize("cut_sb", [14, 15, 20])
def test_adaptive_lowpass_engage_matches_jax(cut_sb):
    """The decision is exact on the same spectra, including granules within
    a quarter decade of either threshold."""
    spec = _lowpass_spectra(cut_sb, seed=cut_sb)
    got = tdsp.adaptive_lowpass_engage(torch.from_numpy(spec), cut_sb).numpy()
    want = np.asarray(_jax_engage()(spec, cut_sb))
    assert np.array_equal(got, want)
    frac, sfm = _engage_stats(spec, cut_sb)
    peaky = sfm < 0.05
    # both thresholds are crossed both ways, by granules near them
    for stat, thr, near in ((frac, 1e-3, peaky), (sfm, 0.15, ~peaky)):
        close = near & (np.abs(np.log10(np.maximum(stat, 1e-30) / thr)) < 0.25)
        assert (close & (stat < thr)).sum() >= 10 and (close & (stat > thr)).sum() >= 10
    assert got.any() and not got.all()
    # the statistics ignore the coefficients' order (every block layout)
    perm = np.random.default_rng(0).permutation(576 - cut_sb * 18) + cut_sb * 18
    shuffled = spec.copy()
    shuffled[..., cut_sb * 18 :] = spec[..., perm]
    again = tdsp.adaptive_lowpass_engage(torch.from_numpy(shuffled), cut_sb).numpy()
    assert np.array_equal(again, np.asarray(_jax_engage()(shuffled, cut_sb)))


@pytest.mark.parametrize("adaptive", [False, True])
def test_lowpass_stage(adaptive):
    """The static mask zeroes every coefficient from cut_sb * 18 up and keeps
    the rest bit for bit; the adaptive stage masks exactly the granules that
    engage (by the JAX op) or are not LONG."""
    cut_sb = 14
    spec = _lowpass_spectra(cut_sb, seed=3).reshape(2, 2, 24, 4, 576)[:, :, :, :2]
    block = np.random.default_rng(4).integers(0, 5, spec.shape[:-1]).astype(np.int32)
    block[0] = tdsp.BLOCK_LONG
    got = tpipe.lowpass_stage(
        torch.from_numpy(spec), torch.from_numpy(block), cut_sb, adaptive
    ).numpy()
    masked = spec * (np.arange(576) < cut_sb * 18).astype(np.float32)
    if adaptive:
        engage = np.asarray(_jax_engage()(spec, cut_sb)) | (block != tdsp.BLOCK_LONG)
        assert engage.any() and not engage.all()
        want = np.where(engage[..., None], masked, spec)
    else:
        want = masked
    assert got.tobytes() == want.tobytes()


def test_lowpass_cut():
    """The stage runs only below Nyquist, at the reference's cut subband."""
    cases = [(None, 44100), (10000, 44100), (11000, 44100), (10000, 32000), (22050, 44100),
             (24000, 48000), (23999, 48000)]
    for hz, sr in cases:
        o = MP3EncoderOptions(sample_rate=sr, lowpass_hz=hz)
        want = None if hz is None or hz * 64 // sr >= 32 else hz * 64 // sr
        assert tpipe.lowpass_cut(o) == want, (hz, sr)
    assert tpipe.lowpass_cut(MP3EncoderOptions.hq(bitrate_kbps=96)) == 14
    assert tpipe.lowpass_cut(MP3EncoderOptions.hq(bitrate_kbps=128)) is None


# --- demand VBR -------------------------------------------------------------------


def _golden_demand_bitrate(demand: int, o: JaxOptions) -> int:
    """The golden encoder's demand-VBR law (swiftmp3_tpu/encoder.py:613-628,
    MPEG-1): the smallest bitrate of the band whose slot covers the demand."""
    side = 17 if o.channels == 1 else 32
    crc = 2 if o.crc_protected else 0
    top = min(MPEG1_L3_BITRATES[-1], o.bitrate_kbps + 64 - o.quality * 4)
    cands = [b for b in MPEG1_L3_BITRATES if 32 <= b <= top]
    for b in cands:
        if ((144 * b * 1000) // o.sample_rate - 4 - crc - side) * 8 >= demand:
            return b
    return cands[-1]


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="mono", bitrate_kbps=128, quality=5),
        dict(mode="joint_stereo", bitrate_kbps=128, quality=0),
        dict(mode="stereo", bitrate_kbps=320, quality=9, sample_rate=48000),
        dict(mode="mono", bitrate_kbps=32, quality=9, crc_protected=True, sample_rate=32000),
    ],
    ids=lambda kw: "_".join(str(v) for v in kw.values()),
)
def test_demand_vbr_choice_matches_the_golden_law(kw):
    o = MP3EncoderOptions.hq(vbr=True, vbr_demand=True, **kw)
    jo = JaxOptions.hq(vbr=True, vbr_demand=True, **dict(kw, mode=JaxMode(kw["mode"])))
    cands, slot_bits = tpipe.demand_vbr_candidates(o)
    demands = [0, 1, 10**6] + [s + d for s in slot_bits for d in (-1, 0, 1)]
    got = tdsp.demand_vbr_bitrate(
        torch.tensor(demands, dtype=torch.int32),
        torch.tensor(slot_bits, dtype=torch.int32),
        torch.tensor(cands, dtype=torch.int32),
    )
    assert got.tolist() == [_golden_demand_bitrate(d, jo) for d in demands]
    # every frame's size stays within the pack's cap of the VBR band
    assert max(cands) <= o.bitrate_kbps + 64 - o.quality * 4


@pytest.mark.parametrize("stem", list(ti.hq_flag_streams("hq_vbr_demand_q5")))
def test_demand_vbr_bitrates_match_the_frozen_jax_streams(stem):
    """The bitrate the port's session chose for each frame is the one the
    JAX chunk program chose (read from its frozen stream's headers)."""
    row = f"hq_vbr_demand_q5_{stem}"
    ref = [f.bitrate_kbps for f in parse_frames(_read(ti.jax_path(row)))]
    assert [f.bitrate_kbps for f in parse_frames(_port_stream(row))] == ref


# --- sessions against the frozen JAX and golden streams ------------------------------


@pytest.mark.parametrize("row", FLAG_ROWS)
def test_flag_session_matches_the_jax_bytes(row):
    ref = _read(ti.jax_path(row))
    if row in KNIFE_EDGE_ROWS:
        assert _flips(_port_stream(row), ref) == KNIFE_EDGE_ROWS[row]
    else:
        assert _port_stream(row) == ref


@functools.lru_cache(maxsize=None)
def _jax_mdct(iso_mixed_alias: bool, window_seq: bool):
    return jax.jit(
        functools.partial(
            jdsp.mdct_chunk, iso_mixed_alias=iso_mixed_alias, window_seq=window_seq
        )
    )


@pytest.mark.parametrize("row", sorted(KNIFE_EDGE_ROWS))
def test_knife_edge_rows_match_with_the_jax_mdct(row, monkeypatch):
    """The port's session with the JAX package's MDCT in place of its own
    reproduces the JAX bytes exactly, while every call's two MDCTs agree
    within the JAX MDCT tests' tolerance (1e-5 x scale): the rows differ by
    a float knife edge, not a law."""
    port_mdct = tdsp.mdct_chunk

    def jax_mdct(S, overlap, block_type, iso_mixed_alias=False, window_seq=False):
        out, signed = _jax_mdct(iso_mixed_alias, window_seq)(
            S.numpy(), overlap.numpy(), block_type.numpy()
        )
        mine, _ = port_mdct(S, overlap, block_type, iso_mixed_alias, window_seq)
        out = np.asarray(out)
        scale = max(float(np.abs(out).max()), 1.0)
        assert float(np.abs(mine.numpy() - out).max()) <= 1e-5 * scale
        return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(signed))

    monkeypatch.setattr(tdsp, "mdct_chunk", jax_mdct)
    preset, stem = _row(row)
    got = _encode(_options(preset), ti.hq_flag_streams(preset)[stem])
    assert got == _read(ti.jax_path(row))


@pytest.mark.parametrize("row", FLAG_ROWS)
def test_flag_session_is_structurally_the_golden_stream(row):
    preset, stem = _row(row)
    _flips(_port_stream(row), _read(ti.golden_path(stem, preset)))


def test_vbr_demand_flip_rate_vs_golden_on_the_telemetry_corpus():
    bad = total = 0
    rates = set()
    for stem in ti.hq_flag_streams("hq_vbr_demand_q5"):
        got = _port_stream(f"hq_vbr_demand_q5_{stem}")
        ref = _read(ti.golden_path(stem, "hq_vbr_demand_q5"))
        bad += _flips(got, ref)
        total += len(parse_frames(ref))
        rates.update(f.bitrate_kbps for f in parse_frames(got))
    assert total == 78 and bad <= VBR_DEMAND_FLIP_CEILING
    assert len(rates) >= 4 and max(rates) <= 160  # the band's frames up to 160 kbps


# --- reservoir depth ----------------------------------------------------------------


def test_depth3_reaches_past_one_slot():
    """At depth 3 a frame's main_data starts more than one slot back (the
    deep reach is used, not just allowed) and never past 511 bytes."""
    frames = parse_frames(_port_stream("hq_mono_96k_depth3_sparse"))
    slot = 144 * 96000 // SR - 21
    mdbs = [f.main_data_begin for f in frames]
    assert len(frames) == 17 and slot < max(mdbs) <= 511


def test_depth3_carry_matches_the_jax_layout():
    o = _options("hq_mono_96k_depth3")
    jo = JaxOptions.hq(**dict(ti.HQ_FLAG_OPTIONS["hq_mono_96k_depth3"], mode=JaxMode.MONO))
    want = {k: np.asarray(v) for k, v in jpipe.init_carry(2, jo).items()}
    got = tpipe.carry_to_jax(tpipe.init_carry(2, o, CPU))
    assert sorted(got) == sorted(want) and got["slot_fifo"].shape == (2, 3)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    back = tpipe.carry_to_jax(tpipe.carry_from_jax(got, CPU, o))
    assert all(np.array_equal(back[k], got[k]) for k in got)


def test_depth3_checkpoint_jax_to_port_and_back():
    """A session checkpoint in the middle of the depth-3 stream, its slot
    fifo full. The port resumes from the JAX backend's and gives its own
    unbroken stream's bytes (the JAX stream's but for the knife-edge frame
    after the cut); the port's own checkpoint there is, bit for bit, the one
    the JAX backend resumed from to give its unbroken stream when
    tests/torch_freeze_fixtures.py froze it."""
    stem, preset, cut = ti.DEPTH_CHECKPOINT
    o = _options(preset)
    pcm = ti.hq_flag_streams(preset)[stem]
    whole = _read(ti.jax_path(f"{preset}_{stem}"))
    jax_state, extra = ti.load_session_state(ti.checkpoint_path("jax", preset))
    head = int(extra["head_len"])
    assert np.count_nonzero(jax_state["backend"]["slot_fifo"]) == 3
    s = new_session(o, CPU)
    s.load_state_dict(jax_state)
    resumed = whole[:head] + s.encode(pcm[cut:]) + s.flush()
    assert resumed == _port_stream(f"{preset}_{stem}")
    assert _flips(resumed, whole) == KNIFE_EDGE_ROWS[f"{preset}_{stem}"]
    s = new_session(o, CPU)
    assert s.encode(pcm[:cut]) == whole[:head]
    mine = s.state_dict()
    frozen, _ = ti.load_session_state(ti.checkpoint_path("port", preset))
    for k in ("fed", "fed_samples", "reservoir_avail", "buffered_slots", "frame_count",
              "total_bytes", "frame_sizes"):
        assert mine[k] == frozen[k], k
    assert len(mine["buffered_slots"]) == 3
    assert bytes(mine["reservoir_stream"]) == frozen["reservoir_stream"]
    assert [bytes(h) for h in mine["buffered_heads"]] == frozen["buffered_heads"]
    assert mine["pcm"].tobytes() == frozen["pcm"].tobytes()
    assert sorted(mine["backend"]) == sorted(frozen["backend"])
    for k, v in mine["backend"].items():
        assert v.dtype == frozen["backend"][k].dtype and v.tobytes() == frozen["backend"][k].tobytes(), k

"""Intensity stereo in the port against the JAX package (CPU).

- the analyses (long layout, and per (band, window) on the natural layout
  of pure-short granules) equal the JAX ops on seeded spectrum pairs whose
  bands straddle every threshold (panned, correlated, anti-phase, silent
  bands; peaky and noise-flat carriers, zero-filled tails): positions,
  regions and has_region exactly, the line masks within 0 (they are 0/1).
  Granules within 1e-4 of a threshold, where the two packages' float sums
  may decide apart, are left out and counted;
- the knife-edge zeroing, the post-walk scalefactors (every field) and the
  padded part2, long and short, equal the JAX ops exactly; the chunk
  program's zeroing composes them as the JAX program does on granules of
  every block type (START and STOP keep the natural order);
- sessions on hq joint stereo 32 kbps with intensity stereo (the preset's
  adaptive 10 kHz lowpass before the analysis) and on spec_strict joint
  stereo 32 kbps (the raw transient gate, no window sequencing) equal the
  JAX backend's bytes frozen under tests/fixtures/torch/ by
  tests/torch_freeze_fixtures.py (no JAX chunk program is compiled here);
  their intensity frames (mode_extension 0b01) sit where the JAX stream's
  do; every row is structurally the golden encoder's, and the corpus keeps
  the telemetry suite's flip ceiling against it.

The JAX ops run under a few small jax.jit compiles.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.options import MP3EncoderOptions

from . import torch_inputs as ti
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")
SR = 44100
IS_PRESETS = ("hq_is_32k", "strict_is_32k")
IS_ROWS = [f"{p}_{stem}" for p in IS_PRESETS for stem in ti.dc_is_streams(p)]
# Frames of the telemetry corpus (78) whose bytes may differ from the golden
# encoder's: tests/test_ulp_telemetry.py's hq_is_32k ceiling (it measured
# 11/78).
IS_GOLDEN_FLIP_CEILING = 19
# Relative distance to a threshold under which a decision may go apart in
# the two packages (their band sums run in another order).
KNIFE = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _row(row: str) -> tuple[str, str]:
    preset = next(p for p in IS_PRESETS if row.startswith(p + "_"))
    return preset, row[len(preset) + 1 :]


@functools.lru_cache(maxsize=None)
def _port_stream(row: str) -> bytes:
    preset, stem = _row(row)
    s = new_session(ti.dc_is_options(preset, MP3EncoderOptions), CPU)
    pcm = ti.dc_is_streams(preset)[stem]
    return s.encode(pcm) + s.flush()


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


# --- seeded spectrum pairs ----------------------------------------------------------


def _pairs(n: int, seed: int, short: bool = False):
    """n spectrum pairs [n, 576] (natural layout, short: coefficient 3 line +
    window) whose bands (per window when short) run across every decision:
    per granule a kind (panned, correlated, mixed), per band a pan (the
    quieter channel at 10^-3..10^0.5 of the louder's energy) and a
    correlation (-1..1), peaky lines over a floor or plain noise, silent
    bands, and zero-filled tails above 232 lines (the adaptive lowpass)."""
    rng = np.random.default_rng(seed)
    if short:
        slot = tdsp._dc_table("is_slot_of", SR, CPU).numpy()  # (band, window) of each line
        n_bands = 36
    else:
        slot = tdsp._dc_table("is_band_of", SR, CPU).numpy()
        n_bands = 21
    kind = rng.integers(0, 3, n)
    pan = 10 ** rng.uniform(-3, 0.5, (n, n_bands))
    pan[kind == 0] = 10 ** rng.uniform(-3, -1.2, (int((kind == 0).sum()), n_bands))
    rho = rng.uniform(-1, 1, (n, n_bands))
    rho[kind == 1] = rng.uniform(0.3, 1, (int((kind == 1).sum()), n_bands))
    level = 10 ** rng.uniform(-2, 1, (n, n_bands))
    s = rng.standard_normal((n, 576))
    peaky = rng.random(n) < 0.6
    s[peaky] *= np.where(rng.random((int(peaky.sum()), 576)) < 0.04, 30.0, 0.3)
    w = rng.standard_normal((n, 576))
    r_mix = rho[:, slot] * s + np.sqrt(1 - rho[:, slot] ** 2) * w
    left = s * level[:, slot]
    right = r_mix * level[:, slot] * np.sqrt(pan[:, slot])
    swap = rng.random((n, n_bands)) < 0.3  # the louder channel on the right
    left, right = (np.where(swap[:, slot], right, left), np.where(swap[:, slot], left, right))
    silent = rng.random((n, n_bands)) < 0.05
    left[silent[:, slot]] = 0.0
    right[(silent & (rng.random((n, n_bands)) < 0.5))[:, slot]] = 0.0
    tail = rng.random(n) < 0.3
    cut = 3 * 78 if short else 232
    left[tail, cut:] = 0.0
    right[tail, cut:] = 0.0
    return left.astype(np.float32), right.astype(np.float32)


def _near(x: np.ndarray, edge) -> np.ndarray:
    return np.abs(x / edge - 1) < KNIFE


def _clear(l: np.ndarray, r: np.ndarray, short: bool) -> np.ndarray:
    """Granules with no decision within KNIFE of its threshold, by float64
    statistics: the position roundings, the pan and correlation tests, the
    region energy share and the carrier flatness (per window when short)."""
    M = tdsp._is_members_short(SR) if short else tdsp._is_members_ext(SR)
    l64, r64 = l.astype(np.float64), r.astype(np.float64)
    el, er, num = (l64 * l64) @ M.T, (r64 * r64) @ M.T, (l64 * r64) @ M.T
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.arctan2(np.sqrt(el), np.sqrt(er)) * 12 / np.pi
        bad = np.abs(x - np.floor(x) - 0.5) < KNIFE
        bad |= _near(np.minimum(el, er), 0.02 * np.maximum(el, er))
        bad |= _near(num / np.sqrt(el * er), 0.5)
    lead = (l.shape[0], 12, 3) if short else (l.shape[0], 21)
    bad = bad.reshape(lead)
    er = er.reshape(lead)
    band_axis = 1
    share = np.cumsum(er[:, ::-1], axis=band_axis)[:, ::-1] / (0.02 * er.sum(axis=band_axis, keepdims=True))
    bad |= _near(share, 1.0)
    if short:
        c = (l64 + r64)[:, 48:].reshape(-1, 176, 3).transpose(0, 2, 1)
    else:
        c = (l64 + r64)[:, int(tdsp._is_bounds(SR)[8]) :]
    hb2 = c * c
    live = hb2 > 0
    nl = np.maximum(live.sum(-1), 1)
    sfm = np.exp(np.where(live, np.log(np.where(live, hb2, 1)), 0).sum(-1) / nl) / (hb2.sum(-1) / nl)
    flat_bad = _near(sfm, 0.15)
    axes = (1, 2) if short else 1
    return ~(bad.any(axis=axes) | (flat_bad.any(axis=-1) if short else flat_bad))


@functools.lru_cache(maxsize=None)
def _jax_analyze(short: bool):
    op = jdsp.intensity_analyze_short_device if short else jdsp.intensity_analyze_device
    return jax.jit(functools.partial(op, sample_rate=SR))


@pytest.mark.parametrize("short", [False, True], ids=["long", "short"])
def test_analysis_matches_jax(short):
    l, r = _pairs(512, seed=10 + short, short=short)
    op = tdsp.intensity_analyze_short_device if short else tdsp.intensity_analyze_device
    got = op(_t(l), _t(r), SR)
    want = _jax_analyze(short)(l, r)
    clear = _clear(l, r, short)
    assert clear.sum() >= 0.97 * len(clear)
    for name, g, w in zip(("pos", "region", "has_region", "line_mask"), got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, name
        assert np.array_equal(g[clear], w[clear]), name
    # every decision goes both ways
    pos, region, has_region, _ = (_np(x) for x in got)
    assert 0.1 < has_region.mean() < 0.9 and 0.1 < region.mean() < 0.9
    assert set(np.unique(pos)) == set(range(7))


@functools.lru_cache(maxsize=None)
def _jax_flat():
    return jax.jit(jdsp._carrier_noise_flat_device)


def test_carrier_noise_flat_matches_jax():
    """Flatness over the live lines only, on carriers straddling IS_SFM:
    noise, peaks over noise, zero-filled tails and all-zero carriers."""
    rng = np.random.default_rng(12)
    c = rng.standard_normal((400, 288))
    peaks = rng.random((400, 288)) < 0.05
    c = np.where(peaks, c * 10 ** rng.uniform(0, 1.3, (400, 1)), c)
    c[100:200, 150:] = 0.0
    c[:4] = 0.0
    c = c.astype(np.float32)
    got = tdsp._carrier_noise_flat_device(_t(c)).numpy()
    want = np.asarray(_jax_flat()(c))
    hb2 = c.astype(np.float64) ** 2
    live = hb2 > 0
    nl = np.maximum(live.sum(-1), 1)
    with np.errstate(divide="ignore"):
        sfm = np.exp(np.where(live, np.log(np.where(live, hb2, 1)), 0).sum(-1) / nl) / (hb2.sum(-1) / nl)
    clear = ~_near(sfm, 0.15)
    assert np.array_equal(got[clear], want[clear]) and clear.sum() >= 390
    assert 0.2 < got.mean() < 0.8 and got[:4].all()


# --- the post-walk laws ------------------------------------------------------------


def _quantized(n: int, seed: int, short: bool = False):
    """Signed quantizations [n, 576] whose extents end below, inside and past
    the knife-edge band (band 20 and the sfb21 tail; per window band 11 and
    its tail), and engaged flags."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-20, 21, (n, 576)) * (rng.random((n, 576)) < 0.5)
    if short:
        sbb = tdsp._sb_bounds_for(SR)
        z = rng.integers(int(sbb[9]), 193, (n, 3))
        line = np.arange(576) // 3
        q = np.where(line[None, :] < z[:, np.arange(576) % 3], q, 0)
        rows = np.arange(n)[:, None]
        q[rows, 3 * (z - 1) + np.arange(3)] = 7  # each window ends at its extent
    else:
        lb = tdsp._is_bounds(SR)
        z = rng.integers(int(lb[18]), 577, n)
        q = np.where(np.arange(576) < z[:, None], q, 0)
        q[np.arange(n), z - 1] = -3
    q[:3] = 0
    return q.astype(np.int32), rng.random(n) < 0.7


@functools.lru_cache(maxsize=None)
def _jax_post_walk(short: bool):
    def run(spec, block, q, pos, summed, engaged):
        sfd = jdsp.granule_scalefactors_device(spec, SR, block, iso_short=True)
        if short:
            qf = jdsp.intensity_q_fixup_short(q, engaged, SR)
            new = jdsp.intensity_sfd_short_device(sfd, qf, pos, summed, engaged, SR)
            pad = jdsp.intensity_padded_part2_short_device(sfd)
        else:
            qf = jdsp.intensity_q_fixup(q, engaged, SR)
            new = jdsp.intensity_sfd_device(sfd, qf, pos, summed, engaged, spec, SR)
            pad = jdsp.intensity_padded_part2_device(sfd, spec, SR)
        return qf, new, pad

    return jax.jit(run)


@pytest.mark.parametrize("short", [False, True], ids=["long", "short"])
def test_post_walk_laws_match_jax(short):
    """The knife-edge zeroing, the position slots with every field of the
    rebuilt scalefactor dict, and the padded part2."""
    n = 160
    rng = np.random.default_rng(20 + short)
    l, _ = _pairs(n, seed=30 + short, short=short)
    block = np.full(n, tdsp.BLOCK_SHORT if short else tdsp.BLOCK_LONG, np.int32)
    q, engaged = _quantized(n, 40 + short, short)
    shape = (n, 12, 3) if short else (n, 21)
    pos = rng.integers(0, 7, shape).astype(np.int32)
    summed = rng.random(shape) < 0.6
    want_q, want, want_pad = _jax_post_walk(short)(l, block, q, pos, summed, engaged)
    sfd = tdsp.granule_scalefactors_device(_t(l), SR, _t(block), iso_short=True)
    if short:
        got_q = tdsp.intensity_q_fixup_short(_t(q), _t(engaged), SR)
        got = tdsp.intensity_sfd_short_device(sfd, got_q, _t(pos), _t(summed), _t(engaged), SR)
        got_pad = tdsp.intensity_padded_part2_short_device(sfd)
    else:
        got_q = tdsp.intensity_q_fixup(_t(q), _t(engaged), SR)
        got = tdsp.intensity_sfd_device(sfd, got_q, _t(pos), _t(summed), _t(engaged), SR)
        got_pad = tdsp.intensity_padded_part2_device(sfd)
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert (got_q.numpy() != q).any(axis=1).sum() >= 10  # the zeroing engages
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k
    assert np.array_equal(got_pad.numpy(), np.asarray(want_pad))
    key = "sf_slots" if short else "sf"
    assert (np.asarray(want[key]) == 7).sum() > 20  # markers written


def _jax_q_fixup(q, right_long, right_short):
    """The JAX chunk program's zeroing (pipeline.py:909-923)."""
    q = jdsp.intensity_q_fixup(q, right_long, SR)
    q_nat = jdsp.reorder_stream_to_natural(q, SR, False)
    q_nat = jdsp.intensity_q_fixup_short(q_nat, right_short, SR)
    q_s = jdsp.reorder_natural_to_stream(q_nat, SR, False)
    return jax.numpy.where(right_short[..., None], q_s, q)


def test_chunk_q_fixup_matches_the_jax_program():
    """On the right channel's granules of every block type: LONG, START and
    STOP take the long law on their natural order (no reorder round trip),
    SHORT the per-window law through the short reorder and back; granules
    of frames that emit nothing are untouched."""
    n = 192
    rng = np.random.default_rng(50)
    q_long, emit = _quantized(n, 51)
    q_short, _ = _quantized(n, 52, short=True)
    block = rng.choice(
        [tdsp.BLOCK_LONG, tdsp.BLOCK_START, tdsp.BLOCK_STOP, tdsp.BLOCK_SHORT], n
    ).astype(np.int32)
    is_short = block == tdsp.BLOCK_SHORT
    # short granules' quantization arrives in stream order
    q_stream = tdsp.reorder_natural_to_stream(_t(q_short), SR, False).numpy()
    q = np.where(is_short[:, None], q_stream, q_long)
    sets = {"right_long": _t(emit & ~is_short), "right_short": _t(emit & is_short)}
    got = tpipe.intensity_q_fixup(_t(q), sets, SR).numpy()
    want = np.asarray(jax.jit(_jax_q_fixup)(q, emit & ~is_short, emit & is_short))
    assert np.array_equal(got, want)
    changed = (got != q).any(axis=1)
    for b in (tdsp.BLOCK_LONG, tdsp.BLOCK_START, tdsp.BLOCK_STOP, tdsp.BLOCK_SHORT):
        assert changed[block == b].any(), b
    assert not changed[~emit].any()


# --- sessions -------------------------------------------------------------------------


@pytest.mark.parametrize("row", IS_ROWS)
def test_is_session_matches_the_jax_bytes(row):
    assert _port_stream(row) == _read(ti.jax_path(row))


@pytest.mark.parametrize("row", IS_ROWS)
def test_is_frames_sit_where_the_jax_stream_has_them(row):
    """mode_extension 0b01 frame for frame; the panned class emits in
    every frame, the decorrelated class (no band qualifies) in none."""
    got = [f.mode_extension for f in parse_frames(_port_stream(row))]
    ref = [f.mode_extension for f in parse_frames(_read(ti.jax_path(row)))]
    assert got == ref
    if row.endswith("panned"):
        assert set(got) == {1}
    if row.endswith("decorr"):
        assert 1 not in got


@pytest.mark.parametrize("row", IS_ROWS)
def test_is_session_is_structurally_the_golden_stream(row):
    preset, stem = _row(row)
    _flips(_port_stream(row), _read(ti.golden_path(stem, preset)))


def test_is_flip_rate_vs_golden_on_the_telemetry_corpus():
    bad = total = 0
    for stem in ti.dc_is_streams("hq_is_32k"):
        ref = _read(ti.golden_path(stem, "hq_is_32k"))
        bad += _flips(_port_stream(f"hq_is_32k_{stem}"), ref)
        total += len(parse_frames(ref))
    assert total == 78 and bad <= IS_GOLDEN_FLIP_CEILING

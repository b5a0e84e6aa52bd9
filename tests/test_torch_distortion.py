"""Distortion control in the port against the JAX package (CPU).

- the step table equals the JAX ldexp reconstruction and the golden
  encoder's float64 step at every gain 0-255, and the port's exact ldexp
  equals numpy's, into the subnormal range;
- the spread of the band-peak exponents, two running maxima, equals the two
  sequential max-plus scans;
- the bumps equal the JAX op's under both laws, exactly, on seeded spectra
  whose band error energies straddle the violation threshold and every
  power-of-4 step of the proportional law (granules within 1e-4 of a
  threshold, where the two packages' float sum orders may decide apart, are
  left out and counted);
- the merged scalefactor dict equals the JAX op's in every field;
- sessions on hq mono 128 kbps with distortion control, and at its depth
  knobs (3 passes, the proportional law), equal the JAX backend's bytes
  frozen under tests/fixtures/torch/ by tests/torch_freeze_fixtures.py (no
  JAX chunk program is compiled here); every row is structurally the golden
  encoder's, and the corpus keeps the telemetry suite's flip ceiling
  against it;
- distortion control changes the bytes of stationary content, and content
  whose every frame holds a transient encodes as with the flag off;
- encode_corpus at the benchmark's hq_mono_dc configuration
  (portbench/configs/hq_mono_dc.json) writes files that walk as the golden
  sessions' do, within the same flip ceiling, and the chunk program records
  one `chunk.dc` span a pass inside `chunk.sweep` (none below the gate).

The JAX ops run under a few small jax.jit compiles.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.options import MP3EncoderOptions

from . import torch_inputs as ti
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")
SR = 44100
DC_PRESETS = ("hq_dc_mono128", "hq_dc3p_mono128")
DC_ROWS = [f"{p}_{stem}" for p in DC_PRESETS for stem in ti.dc_is_streams(p)]
# Frames of the telemetry corpus (78) whose bytes may differ from the golden
# encoder's: tests/test_ulp_telemetry.py's hq_dc_mono128 ceiling (it measured
# 34/78).
DC_GOLDEN_FLIP_CEILING = 42
# Relative distance to a threshold under which a band may decide apart in
# the two packages (their band sums run in another order).
KNIFE = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _row(row: str) -> tuple[str, str]:
    preset = next(p for p in DC_PRESETS if row.startswith(p + "_"))
    return preset, row[len(preset) + 1 :]


def _encode(o, pcm) -> bytes:
    s = new_session(o, CPU)
    return s.encode(pcm) + s.flush()


@functools.lru_cache(maxsize=None)
def _off_stream(stem: str) -> bytes:
    """The flag-off encode of a telemetry stream: hq mono 128 kbps without
    scfsi, which distortion control excludes."""
    off = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=128, sample_rate=SR, scfsi=False)
    return _encode(off, ti.dc_is_streams("hq_dc_mono128")[stem])


@functools.lru_cache(maxsize=None)
def _port_stream(row: str) -> bytes:
    preset, stem = _row(row)
    return _encode(ti.dc_is_options(preset, MP3EncoderOptions), ti.dc_is_streams(preset)[stem])


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


# --- the exact arithmetic ---------------------------------------------------------


def test_steps_equal_the_jax_ldexp_and_the_golden_step():
    """2^((g-210)/4) at every gain: the port's table, the JAX op's exact
    ldexp of the quarter powers (dsp.py:2071-2076) and the golden's
    float64 value rounded to float32."""
    gain = np.arange(256, dtype=np.int32)

    def jax_step(gain):
        e = gain - 210
        base = jax.lax.bitcast_convert_type(
            jdsp._select_tree(e & 3, jdsp._QUARTER_POS.view(np.uint32), 0, 4), jnp.float32
        )
        return jnp.ldexp(base, e >> 2).astype(jnp.float32)

    want = np.asarray(jax.jit(jax_step)(gain))
    got = tdsp._dc_table("steps", SR, CPU)[torch.from_numpy(gain).long()].numpy()
    golden = np.array([np.float32(2.0 ** ((g - 210) / 4.0)) for g in range(256)], np.float32)
    assert got.tobytes() == want.tobytes() == golden.tobytes()


def test_ldexp_exact_equals_numpy():
    """x * 2^e correctly rounded, from the normal range down past the last
    subnormal (numpy's ldexp is the golden encoder's)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1, 256, 2000), [0.0, 1.0, 192.0, 3.0]]).astype(np.float32)
    e = rng.integers(-200, 60, x.size).astype(np.int32)
    e[-4:] = [-40000, -150, -157, -149]
    got = tdsp._ldexp_exact(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    assert got.tobytes() == np.ldexp(x, e).astype(np.float32).tobytes()
    # and the JAX op's where no subnormal is involved
    normal = e > -100
    want = np.asarray(jax.jit(jnp.ldexp)(x[normal], e[normal]))
    assert got[normal].tobytes() == want.tobytes()


def test_spread_max_equals_the_sequential_scans():
    rng = np.random.default_rng(1)
    pe = rng.integers(-40, 20, (500, 21)).astype(np.int32)
    pe[rng.random(pe.shape) < 0.3] = -(1 << 14)  # empty bands
    pe[:5] = -(1 << 14)
    M = pe.copy()
    for b in range(1, 21):
        M[:, b] = np.maximum(M[:, b], M[:, b - 1] - 4)
    for b in range(19, -1, -1):
        M[:, b] = np.maximum(M[:, b], M[:, b + 1] - 4)
    assert np.array_equal(tdsp._spread_max(torch.from_numpy(pe), 4).numpy(), M)


# --- the bumps --------------------------------------------------------------------


def _bump_input(n: int = 384, seed: int = 2):
    """n granules whose band error energies run over five decades around
    the mask: band levels over four decades (a masker band or two per
    granule), scalefactors 0 to the caps, gains from far finer to far
    coarser than the level calls for, and integer noise of 0-8 steps on the
    probe quantization."""
    rng = np.random.default_rng(seed)
    lb = tdsp._long_bounds(SR)
    level = 10 ** rng.uniform(-3, 1, (n, 22))
    masker = rng.integers(0, 21, (n, 2))
    level[np.arange(n)[:, None], masker] *= 30.0
    band = np.searchsorted(lb, np.arange(576), side="right") - 1
    spec = (rng.standard_normal((n, 576)) * level[:, band]).astype(np.float32)
    spec[rng.random((n, 576)) < 0.05] = 0.0
    spec[:3, 300:] = 0.0  # silent upper bands
    sf = np.minimum(rng.integers(0, 16, (n, 21)), tdsp.DC_CAPS).astype(np.int32)
    peak = np.abs(spec).max(axis=1)
    g0 = 210 + np.trunc(16 / 3 * np.log2(np.maximum(peak, 1e-30) ** 0.75 / 2048)).astype(int)
    gain = np.clip(g0 + rng.integers(-12, 40, n), 0, 255).astype(np.int32)
    mag = np.abs(spec).astype(np.float64) ** 0.75 * 2.0 ** (0.75 * sf[:, band.clip(max=20)])
    mag[:, band > 20] = np.abs(spec[:, band > 20]) ** 0.75
    q = np.floor(mag * 2.0 ** (-0.75 * (gain[:, None] - 210) / 4) + 0.5)
    q = q + rng.integers(-8, 9, (n, 576)) * (rng.random((n, 576)) < 0.2)
    q = np.where(spec < 0, -q, q).clip(-8206, 8206).astype(np.int32)
    return spec, q, gain, sf


@functools.lru_cache(maxsize=None)
def _jax_bumps(proportional: bool):
    return jax.jit(
        functools.partial(jdsp.distortion_bumps_device, sample_rate=SR, proportional=proportional)
    )


def _ratios(spec, q, gain, sf) -> np.ndarray:
    """Each band's e2 / thr2n: the port's float32 reconstruction, the sums
    in float64."""
    s, qq, g, f = (torch.from_numpy(a) for a in (spec, q, gain, sf))
    step = tdsp._dc_table("steps", SR, CPU)[g.long()]
    mag = torch.pow(torch.abs(qq).float(), float(np.float32(4 / 3))) * step[:, None]
    xr = torch.where(qq < 0, -mag, mag)
    pow2 = torch.nn.functional.pad(tdsp._dc_table("neg_pow2", SR, CPU)[f.long()], (0, 16), value=1.0)
    err = xr * pow2[:, tdsp._rate_table("slot_maps", SR, CPU)[0]] - s
    e2 = (err.double() ** 2) @ torch.from_numpy(tdsp._band_members(SR).T).double()
    lb = tdsp._long_bounds(SR)
    pb = torch.stack([s.abs()[:, lb[b] : lb[b + 1]].amax(-1) for b in range(21)], -1)
    pe = torch.where(pb > 0, torch.frexp(pb)[1], -(1 << 14))
    thr = tdsp._spread_max(pe, 4) - 6
    thr2n = torch.from_numpy(np.diff(lb).astype(np.float64)) * torch.pow(2.0, 2 * thr.double())
    return (e2 / thr2n).numpy()


@pytest.mark.parametrize("proportional", [False, True], ids=["fixed", "proportional"])
def test_bumps_match_jax(proportional):
    spec, q, gain, sf = _bump_input()
    got = tdsp.distortion_bumps_device(
        _t(spec), _t(q), _t(gain), _t(sf), SR, proportional=proportional
    ).numpy()
    want = np.asarray(_jax_bumps(proportional)(spec, q, gain, sf))
    r = _ratios(spec, q, gain, sf)
    edges = [tdsp.DC_RATIO] + ([4.0**k for k in range(1, tdsp.DC_BUMP_MAX)] if proportional else [])
    knife = np.zeros(r.shape, bool)
    for edge in edges:
        knife |= np.abs(r / edge - 1) < KNIFE
    clear = ~knife.any(axis=1)
    assert clear.sum() >= 0.98 * len(clear)
    assert np.array_equal(got[clear], want[clear])
    # the bands straddle the threshold, and every step count is reached
    assert ((r > 2) & clear[:, None]).sum() > 500 and ((r < 2) & clear[:, None]).sum() > 500
    counts = np.bincount(got[clear].ravel(), minlength=7)
    if proportional:
        assert (counts[1:] > 20).all() and counts[0] > 500, counts
    else:
        assert set(np.unique(got)) == {0, tdsp.DC_BUMP}


@functools.lru_cache(maxsize=None)
def _jax_dc_sfd():
    def run(spec, block, bumps, engaged):
        sfd = jdsp.granule_scalefactors_device(spec, SR, block, iso_short=True)
        return sfd, jdsp.distortion_sfd_device(sfd, bumps, engaged, spec, SR)

    return jax.jit(run)


def test_distortion_sfd_matches_jax():
    """Bumps 0-6 merged into the scalefactors of engaged granules (sums past
    the slen caps among them), every field of the dict; the granules of
    every block type, engaged or not."""
    rng = np.random.default_rng(3)
    spec, _, _, _ = _bump_input(96, seed=4)
    block = rng.choice([tdsp.BLOCK_LONG, tdsp.BLOCK_SHORT, tdsp.BLOCK_MIXED], 96).astype(np.int32)
    bumps = rng.integers(0, 7, (96, 21)).astype(np.int32)
    engaged = (rng.random(96) < 0.6) & (block == tdsp.BLOCK_LONG)
    engaged[-4:] = True  # engaged switching granules rebuild the long layout too
    sfd0, want = _jax_dc_sfd()(spec, block, bumps, engaged)
    port0 = tdsp.granule_scalefactors_device(_t(spec), SR, _t(block), iso_short=True)
    got = tdsp.distortion_sfd_device(port0, _t(bumps), _t(engaged), SR)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k
    capped = (np.asarray(sfd0["sf"]) + bumps > tdsp.DC_CAPS) & engaged[:, None]
    assert capped.sum() > 20 and (np.asarray(want["sf"]) != np.asarray(sfd0["sf"])).any()


# --- sessions ---------------------------------------------------------------------


@pytest.mark.parametrize("row", DC_ROWS)
def test_dc_session_matches_the_jax_bytes(row):
    assert _port_stream(row) == _read(ti.jax_path(row))


@pytest.mark.parametrize("row", DC_ROWS)
def test_dc_session_is_structurally_the_golden_stream(row):
    preset, stem = _row(row)
    _flips(_port_stream(row), _read(ti.golden_path(stem, preset)))


def test_dc_flip_rate_vs_golden_on_the_telemetry_corpus():
    bad = total = 0
    for stem in ti.dc_is_streams("hq_dc_mono128"):
        ref = _read(ti.golden_path(stem, "hq_dc_mono128"))
        bad += _flips(_port_stream(f"hq_dc_mono128_{stem}"), ref)
        total += len(parse_frames(ref))
    assert total == 78 and bad <= DC_GOLDEN_FLIP_CEILING


def test_dc_changes_stationary_bytes():
    """On stationary classes the bumped scalefactors show in the bytes: the
    dc streams differ from the flag-off encode (hq mono 128 kbps without
    scfsi, which distortion control excludes) in most frames, with the same
    structure."""
    for stem in ("corpus_speech", "corpus_noise"):
        flips = _flips(_port_stream(f"hq_dc_mono128_{stem}"), _off_stream(stem))
        assert flips >= 8, (stem, flips)


def test_transient_frames_encode_as_dc_off():
    """Every frame holds a transient, so no frame engages: the bytes are the
    flag-off bytes (tests/test_distortion_control.py:116)."""
    n = 8 * 1152
    t = np.arange(n) / SR
    pcm = (0.35 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    env = np.zeros(n, dtype=np.float32)
    for p in range(400, n - 900, 1152):  # one attack per frame
        env[p : p + 700] = 1.0
    pcm = pcm * env
    off = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=128, scfsi=False)
    on = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=128, distortion_control=True)
    assert on.distortion_control_active
    assert _encode(on, pcm) == _encode(off, pcm)


# --- the benchmark's configuration ------------------------------------------------


def _bench_options() -> MP3EncoderOptions:
    """portbench/configs/hq_mono_dc.json's options, built as the benchmark
    builds them: MP3EncoderOptions.<preset>(**options), mode by name."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "portbench", "configs", "hq_mono_dc.json")
    with open(path) as fh:
        cfg = json.load(fh)
    kw = dict(cfg["options"], mode=cfg["options"]["mode"].lower())
    return getattr(MP3EncoderOptions, cfg["preset"])(**kw)


def test_hq_mono_dc_corpus_files_walk_as_the_golden_sessions():
    """encode_corpus at the benchmark's configuration, 4 frames a step, over
    the telemetry corpus: each file is [ID3][Xing][frames], the tag and the
    Info frame those of the golden session's file, its frames structurally
    the golden stream's and within the flip ceiling; the stationary streams
    differ from the flag-off encode (distortion control is not inert on
    the batch path)."""
    from swiftmp3_tpu_torch.io.id3 import build_id3_tag
    from swiftmp3_tpu_torch.io.xing import build_xing_header
    from swiftmp3_tpu_torch.options import ID3Tag
    from swiftmp3_tpu_torch.parallel import encode_corpus

    o = _bench_options()
    assert o == ti.dc_is_options("hq_dc_mono128", MP3EncoderOptions)
    assert o.channels == 1 and o.distortion_control_active and not o.scfsi and o.dc_passes == 1
    streams = ti.dc_is_streams("hq_dc_mono128")
    tags = [ID3Tag(title=stem, artist="dc", track=i + 1) for i, stem in enumerate(streams)]
    files = encode_corpus(o, list(streams.values()), tags=tags, device=CPU, frames_per_step=4)
    bad = total = 0
    for stem, tag, data in zip(streams, tags, files):
        ref = _read(ti.golden_path(stem, "hq_dc_mono128"))
        sizes = [f.size for f in parse_frames(ref)]
        head = build_id3_tag(tag) + build_xing_header(o, len(sizes), len(ref), sizes)
        assert data[: len(head)] == head, stem
        audio = data[len(head) :]
        bad += _flips(audio, ref)
        total += len(sizes)
        assert {f.size for f in parse_frames(audio)} <= {417, 418}
        if stem in ("corpus_speech", "corpus_noise"):
            assert _flips(audio, _off_stream(stem)) >= 8, stem
    assert total == 78 and bad <= DC_GOLDEN_FLIP_CEILING


@pytest.mark.parametrize(
    "preset,passes",
    [("hq_dc_mono128", 1), ("hq_dc3p_mono128", 3), (None, 0)],
    ids=["one_pass", "three_passes", "below_the_gate"],
)
def test_a_dc_step_records_one_chunk_dc_span_a_pass_inside_the_sweep(preset, passes):
    """Under profiling.enable(), one CPU step of a mono stream records
    `chunk.dc` once a distortion-control pass, each inside that step's
    `chunk.sweep`; hq joint stereo at 128 kbps with the flag on (64 kbps a
    channel, below the gate) records none."""
    from swiftmp3_tpu_torch.parallel import encode_corpus
    from swiftmp3_tpu_torch.utils import profiling

    if preset:
        o, ch = ti.dc_is_options(preset, MP3EncoderOptions), 1
    else:
        o, ch = MP3EncoderOptions.hq(mode="joint_stereo", bitrate_kbps=128, sample_rate=SR,
                                     distortion_control=True), 2
        assert not o.distortion_control_active
    pcm = (np.sin(np.arange(1152 * 2 * ch) * 0.05) * 12000).astype(np.int16)
    profiling.disable()
    profiling.reset()
    profiling.enable()
    try:
        encode_corpus(o, [pcm], device=CPU, frames_per_step=4)
    finally:
        profiling.disable()
    spans = profiling.snapshot()["spans"]
    profiling.reset()
    sweeps = [s for s in spans if s[0] == "chunk.sweep"]
    dcs = [s for s in spans if s[0] == "chunk.dc"]
    assert len(sweeps) == 1 and len(dcs) == passes
    (sw,) = sweeps
    # (name, start, end, thread, depth): on the sweep's thread, deeper, within it
    assert all(d[3] == sw[3] and d[4] > sw[4] and sw[1] <= d[1] <= d[2] <= sw[2] for d in dcs)

"""The port's reference inputs and frozen streams equal what the reference
produces (CPU).

`chip_smoke.py` and `tools/torch_profile_step.py` import nothing of the JAX
package, so their inputs come from numpy-only copies in `tests/torch_inputs.py`
and their golden streams from files under `tests/fixtures/torch/`. Here:

- the signal copies (`make_signal`, `corpus_stereo`) equal the originals
  (`tests/fixture_lib.py`, `tests/test_ulp_telemetry.py`), array for array;
- the 8 compat and 4 strict rows equal the rows of `fixture_lib.FIXTURES`;
- each frozen stream is what the golden numpy backend
  (`EncoderSession(options, backend="numpy")`) encodes from its input today,
  byte for byte, so the files stay pinned to the reference: under the main
  path's compat options and under the spec_strict preset
  (`torch_inputs.STRICT_OPTIONS`); of the hq presets' golden streams
  (`torch_inputs.HQ_OPTIONS`, `torch_inputs.HQ_FLAG_OPTIONS`), one short row
  each is re-encoded here;
- the hq flag configurations, their inputs and the depth-3 signal equal
  the reference tests' (`tests/test_ulp_telemetry.py`,
  `tests/test_reservoir_depth.py`).

Regenerate the compat and strict golden streams with
`python -m tests.test_torch_fixtures`, the hq and JAX-backend files with
`python -m tests.torch_freeze_fixtures`.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import pytest

from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.options import MP3EncoderOptions, Mode

from . import fixture_lib
from . import torch_inputs as ti
from .test_ulp_telemetry import _corpus_stereo

GOLDEN_STEMS = ["main_stream0", "main_stream1"] + [
    f"corpus_{k}" for k in ("tonal", "noise", "burst", "speech", "decorr", "panned")
]


@functools.lru_cache(maxsize=None)
def _golden_inputs() -> dict:
    return ti.golden_streams()


def _golden_options(preset: str) -> MP3EncoderOptions:
    if preset == "strict":
        kw = dict(ti.STRICT_OPTIONS, mode=Mode(ti.STRICT_OPTIONS["mode"]))
        return MP3EncoderOptions.spec_strict(**kw)
    return MP3EncoderOptions(**ti.MAIN_OPTIONS)


def _golden_encode(pcm: np.ndarray, preset: str = "compat") -> bytes:
    s = EncoderSession(_golden_options(preset), backend="numpy")
    return s.encode(pcm) + s.flush()


@pytest.mark.parametrize("row", fixture_lib.FIXTURES, ids=[f[0] for f in fixture_lib.FIXTURES])
def test_make_signal_copy_equals_fixture_lib(row):
    _, kw, kind, seconds, seed = row
    o = MP3EncoderOptions(**kw)
    want = fixture_lib.make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    got = ti.make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_strict_rows_equal_fixture_lib():
    ref = [f for f in fixture_lib.FIXTURES if MP3EncoderOptions(**f[1]).spec_strict_entropy]
    assert [r[0] for r in ti.STRICT_FIXTURES] == [r[0] for r in ref]
    for (name, kw, *rest), (_, ref_kw, *ref_rest) in zip(ti.STRICT_FIXTURES, ref):
        assert rest == ref_rest, name
        assert MP3EncoderOptions(**kw) == MP3EncoderOptions(**ref_kw), name
        assert ti.fixture_path(name, "tpu") == fixture_lib.fixture_path(name, "tpu")


def test_compat_rows_equal_fixture_lib():
    ref = [f for f in fixture_lib.FIXTURES if not MP3EncoderOptions(**f[1]).spec_strict_entropy]
    assert [r[0] for r in ti.COMPAT_FIXTURES] == [r[0] for r in ref]
    for (name, kw, *rest), (_, ref_kw, *ref_rest) in zip(ti.COMPAT_FIXTURES, ref):
        assert rest == ref_rest, name
        assert MP3EncoderOptions(**kw) == MP3EncoderOptions(**ref_kw), name
        assert os.path.exists(ti.fixture_path(name, "tpu"))
        assert ti.fixture_path(name, "tpu") == fixture_lib.fixture_path(name, "tpu")


def test_corpus_copy_equals_the_telemetry_corpus():
    got, want = ti.corpus_stereo(), _corpus_stereo()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_golden_inputs_cover_the_frozen_files():
    assert sorted(_golden_inputs()) == sorted(GOLDEN_STEMS)
    main = _golden_inputs()["main_stream0"]
    assert main.dtype == np.int16 and main.shape == (ti.T_MAIN * 2304,)
    frozen = sorted(os.listdir(ti.TORCH_FIXTURE_DIR))
    want = [ti.golden_path(s, p) for p in ("compat", "strict") for s in GOLDEN_STEMS]
    for preset in ti.HQ_OPTIONS:
        for stem in ti.hq_streams():
            want += [ti.golden_path(stem, preset), ti.jax_path(f"{preset}_{stem}")]
    want += [ti.jax_path(row[0]) for row in ti.STRICT_EXTRA_ROWS]
    want += [ti.checkpoint_path(side) for side in ("jax", "port")]
    for preset in ti.HQ_FLAG_OPTIONS:
        for stem in ti.hq_flag_streams(preset):
            want += [ti.golden_path(stem, preset), ti.jax_path(f"{preset}_{stem}")]
    want += [ti.checkpoint_path(side, ti.DEPTH_CHECKPOINT[1]) for side in ("jax", "port")]
    want += [ti.jax_path("corpus_file0"), ti.jax_path("cli")]
    for preset in ti.DC_IS_OPTIONS:
        for stem in ti.dc_is_streams(preset):
            want += [ti.golden_path(stem, preset), ti.jax_path(f"{preset}_{stem}")]
    want += [ti.jax_path(row) for row in (*ti.LSF_ROWS, *ti.FF_ROWS)]
    want += [ti.jax_path(f"{row}_step{ti.ODD_STEP}") for row in (*ti.LSF_ROWS, *ti.FF_ROWS)]
    want += [ti.checkpoint_path(side, ti.LSF_CHECKPOINT[0]) for side in ("jax", "port")]
    for name in ti.MESH_OPTIONS:
        want += [ti.jax_path(f"mesh_{name}_{i}") for i in range(len(ti.mesh_streams(name)))]
    want += [ti.jax_path(f"multihost_{dtype}") for dtype in ti.multihost_streams()]
    want.append(ti.ENTRY_FIXTURE)
    assert frozen == sorted(os.path.basename(p) for p in want)


@pytest.mark.parametrize("stem", GOLDEN_STEMS)
def test_frozen_golden_stream_is_the_golden_encoders(stem):
    with open(ti.golden_path(stem), "rb") as fh:
        assert fh.read() == _golden_encode(_golden_inputs()[stem])


@pytest.mark.parametrize("stem", GOLDEN_STEMS)
def test_frozen_strict_golden_stream_is_the_golden_encoders(stem):
    with open(ti.golden_path(stem, "strict"), "rb") as fh:
        assert fh.read() == _golden_encode(_golden_inputs()[stem], "strict")


def test_strict_options_are_the_telemetry_preset():
    from .test_ulp_telemetry import _CONFIGS

    want = {name: make for name, _, make, _ in _CONFIGS}["strict"]()
    assert _golden_options("strict") == want


def _hq_options(preset: str) -> MP3EncoderOptions:
    return MP3EncoderOptions.hq(**dict(ti.HQ_OPTIONS[preset], mode=Mode(ti.HQ_OPTIONS[preset]["mode"])))


def test_hq_options_are_the_telemetry_and_bench_configurations():
    from .test_ulp_telemetry import _CONFIGS

    want = {name: make for name, _, make, _ in _CONFIGS}["hq"]()
    assert _hq_options("hq_joint") == want
    # bench.py's hq cell (bench.py:163-165)
    assert _hq_options("hq_stereo") == MP3EncoderOptions.hq(
        mode=Mode.STEREO, bitrate_kbps=128, sample_rate=44100
    )


def test_hq_rows_are_the_strict_rows_signals():
    assert [r[1:] for r in ti.HQ_ROWS] == [r[2:] for r in ti.STRICT_FIXTURES]
    assert len(set(ti.hq_streams())) == len(ti.HQ_ROWS) + 6


def test_frozen_hq_golden_stream_is_the_golden_encoders():
    """One short row (13 frames): the joint-stereo hq stream of the tonal
    corpus class."""
    pcm = ti.hq_streams()["corpus_tonal"]
    s = EncoderSession(_hq_options("hq_joint"), backend="numpy")
    with open(ti.golden_path("corpus_tonal", "hq_joint"), "rb") as fh:
        assert fh.read() == s.encode(pcm) + s.flush()


def _flag_options(preset: str) -> MP3EncoderOptions:
    kw = ti.HQ_FLAG_OPTIONS[preset]
    return MP3EncoderOptions.hq(**dict(kw, mode=Mode(kw["mode"])))


def test_hq_flag_options_and_inputs_are_the_reference_tests():
    from .test_reservoir_depth import _sparse
    from .test_ulp_telemetry import _CONFIGS, _mono

    configs = {name: (make, prep) for name, _, make, prep in _CONFIGS}
    make, prep = configs["hq_vbr_demand_q5"]
    assert _flag_options("hq_vbr_demand_q5") == make() and prep is _mono
    corpus = _corpus_stereo()
    for k, pcm in ti.hq_flag_streams("hq_vbr_demand_q5").items():
        assert np.array_equal(pcm, _mono(corpus[k[len("corpus_"):]]))
    assert np.array_equal(ti.sparse_transients(16 * 1152), _sparse(16 * 1152))
    # the depth-3 configuration of tests/test_reservoir_depth.py
    assert _flag_options("hq_mono_96k_depth3") == MP3EncoderOptions.hq(
        mode=Mode.MONO, bitrate_kbps=96, reservoir_depth=3
    )
    # 96 kbps engages the preset's adaptive lowpass; the static row has none
    for preset in ("hq_mono_96k", "hq_joint_96k", "hq_mono_96k_depth3"):
        o = _flag_options(preset)
        assert o.lowpass_hz == 10000 and o.adaptive_lowpass
    o = _flag_options("hq_mono_lowpass10k")
    assert o.lowpass_hz == 10000 and not o.adaptive_lowpass


@pytest.mark.parametrize("preset", list(ti.HQ_FLAG_OPTIONS))
def test_frozen_hq_flag_golden_stream_is_the_golden_encoders(preset):
    """One stream of each configuration (13 or 17 frames)."""
    stem, pcm = next(iter(ti.hq_flag_streams(preset).items()))
    s = EncoderSession(_flag_options(preset), backend="numpy")
    with open(ti.golden_path(stem, preset), "rb") as fh:
        assert fh.read() == s.encode(pcm) + s.flush()


def test_dc_is_options_and_inputs_are_the_telemetry_configurations():
    """hq_dc_mono128 and hq_is_32k are tests/test_ulp_telemetry.py's, on its
    corpus as it feeds them (mono folded for distortion control); the depth
    knobs' row is hq_dc_mono128 at 3 proportional passes; the strict row is
    the spec_strict preset at the same rate as hq_is_32k."""
    from .test_ulp_telemetry import _CONFIGS, _mono

    configs = {name: (make, prep) for name, _, make, prep in _CONFIGS}
    opts = {p: ti.dc_is_options(p, MP3EncoderOptions, Mode) for p in ti.DC_IS_OPTIONS}
    corpus = _corpus_stereo()
    for preset in ("hq_dc_mono128", "hq_is_32k"):
        make, prep = configs[preset]
        assert opts[preset] == make()
        for k, pcm in ti.dc_is_streams(preset).items():
            want = corpus[k[len("corpus_"):]]
            assert np.array_equal(pcm, want if prep is None else prep(want))
    assert configs["hq_dc_mono128"][1] is _mono and configs["hq_is_32k"][1] is None
    assert opts["hq_dc3p_mono128"] == dataclasses.replace(
        opts["hq_dc_mono128"], dc_passes=3, dc_proportional=True
    )
    assert opts["strict_is_32k"] == MP3EncoderOptions.spec_strict(
        mode=Mode.JOINT_STEREO, bitrate_kbps=32, sample_rate=44100, intensity_stereo=True
    )
    assert all(o.distortion_control_active for p, o in opts.items() if "_dc" in p)
    assert all(o.intensity_stereo_active for p, o in opts.items() if "_is_" in p)


@pytest.mark.parametrize("preset", list(ti.DC_IS_OPTIONS))
def test_frozen_dc_is_golden_stream_is_the_golden_encoders(preset):
    """One stream of each configuration (12 or 13 frames)."""
    stem, pcm = next(iter(ti.dc_is_streams(preset).items()))
    s = EncoderSession(ti.dc_is_options(preset, MP3EncoderOptions, Mode), backend="numpy")
    with open(ti.golden_path(stem, preset), "rb") as fh:
        assert fh.read() == s.encode(pcm) + s.flush()


if __name__ == "__main__":
    os.makedirs(ti.TORCH_FIXTURE_DIR, exist_ok=True)
    for preset in ("compat", "strict"):
        for stem, pcm in _golden_inputs().items():
            data = _golden_encode(pcm, preset)
            with open(ti.golden_path(stem, preset), "wb") as fh:
                fh.write(data)
            print(f"wrote {ti.golden_path(stem, preset)} ({len(data)} bytes)")

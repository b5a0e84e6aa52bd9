"""The port stands alone: its copies of the reference's host modules equal
the originals, and nothing of the port imports the JAX package (CPU).

- An AST scan of every module of `swiftmp3_tpu_torch`, of `chip_smoke.py`,
  `tools/torch_profile_step.py`, the port's examples and the numpy-only
  test helpers they import:
  none imports `jax`, `swiftmp3_tpu` (or a module of it), `tests.fixture_lib`
  or a test module.
- Every public array and table of `swiftmp3_tpu_torch.tables` equals the
  reference's bit for bit; the verbatim copies are byte-identical sources
  (`utils.profiling.ThroughputMeter` and `encoder.GoldenBackend` the class
  alone).
- Both packages' `MP3EncoderOptions` agree in every field and derived
  property on the fixture rows' keyword arguments and the presets.
- The port's native renderer and the reference's render the same chunk
  outputs to the same bytes; a failed build of the port's raises.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

import swiftmp3_tpu.native as jnative
import swiftmp3_tpu.options as jopt
import swiftmp3_tpu.tables as jtables
import swiftmp3_tpu_torch.native.lib as tnative_lib
import swiftmp3_tpu_torch.options as topt
import swiftmp3_tpu_torch.tables as ttables
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.parallel import batch as tbatch

from .fixture_lib import FIXTURES

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- (a) no JAX package in the port -------------------------------------------


def _port_files() -> list[str]:
    files = ["chip_smoke.py", "tools/torch_profile_step.py", "tests/torch_inputs.py", "tests/util.py",
             "examples/torch_podcast_corpus.py", "examples/torch_live_serving.py"]
    pkg = os.path.join(ROOT, "swiftmp3_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        files += [
            os.path.relpath(os.path.join(dirpath, n), ROOT) for n in names if n.endswith(".py")
        ]
    return sorted(files)


def _imported_modules(relpath: str) -> set[str]:
    """Absolute names of every module a file imports (relative imports
    resolved against its package), at any depth of its code."""
    with open(os.path.join(ROOT, relpath)) as fh:
        tree = ast.parse(fh.read(), relpath)
    package = os.path.dirname(relpath).replace(os.sep, ".").split(".")
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            names.add(mod)
            names.update(f"{mod}.{a.name}" for a in node.names)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    if top in ("jax", "jaxlib", "swiftmp3_tpu"):
        return True
    parts = name.split(".")
    return top == "tests" and len(parts) > 1 and (
        parts[1] == "fixture_lib" or parts[1].startswith("test_")
    )


@pytest.mark.parametrize("relpath", _port_files())
def test_port_file_imports_nothing_of_the_jax_package(relpath):
    bad = sorted(n for n in _imported_modules(relpath) if _forbidden(n))
    assert not bad, f"{relpath} imports {bad}"


def test_the_import_scan_covers_the_entry_points():
    """The command line, the serving pool, the mesh, the utilities, the
    graft entry, the port's examples and its host oracles (the golden DSP,
    the decoder, the quality measures, the codec library bindings) are
    scanned."""
    files = set(_port_files())
    want = {"swiftmp3_tpu_torch/cli.py", "swiftmp3_tpu_torch/__main__.py",
            "swiftmp3_tpu_torch/graft_entry.py",
            "swiftmp3_tpu_torch/parallel/pool.py", "swiftmp3_tpu_torch/parallel/batch.py",
            "swiftmp3_tpu_torch/utils/__init__.py", "swiftmp3_tpu_torch/utils/wav.py",
            "swiftmp3_tpu_torch/parallel/mesh.py", "swiftmp3_tpu_torch/utils/profiling.py",
            "examples/torch_podcast_corpus.py", "examples/torch_live_serving.py",
            "swiftmp3_tpu_torch/ops/reference.py", "swiftmp3_tpu_torch/utils/quality.py",
            "swiftmp3_tpu_torch/utils/external.py",
            *(f"swiftmp3_tpu_torch/decoder/{n}" for n in (
                "__init__.py", "decoder.py", "tables.py", "_b7_data.py", "_lsf_data.py",
                "_spec_data.py"))}
    assert want <= files


def test_the_import_scan_sees_forbidden_imports():
    assert _forbidden("swiftmp3_tpu") and _forbidden("swiftmp3_tpu.options")
    assert _forbidden("jax.numpy") and _forbidden("tests.fixture_lib")
    assert _forbidden("tests.test_ulp_telemetry._corpus_stereo")
    assert not _forbidden("swiftmp3_tpu_torch.options") and not _forbidden("tests.torch_inputs")
    # relative imports resolve against the file's package
    assert "tests.fixture_lib" in _imported_modules("tests/test_torch_copies.py")


# --- (b) the copies equal the reference ---------------------------------------


def _same(a, b) -> bool:
    """Deep equality across the two packages: arrays bit for bit,
    dataclasses and enums by class name and contents."""
    if isinstance(a, np.ndarray):
        return (
            isinstance(b, np.ndarray)
            and a.dtype == b.dtype
            and a.shape == b.shape
            and a.tobytes() == b.tobytes()
        )
    if isinstance(a, enum.Enum):
        return type(a).__name__ == type(b).__name__ and a.value == b.value
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and all(
            _same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)
        )
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (
            type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
        )
    return type(a) is type(b) and a == b


def _public_tables() -> list[str]:
    return sorted(
        n
        for n in dir(jtables)
        if not n.startswith("_")
        and not callable(getattr(jtables, n))
        and not isinstance(getattr(jtables, n), type(jtables))
    )


@pytest.mark.parametrize("name", _public_tables())
def test_table_copy_is_bit_identical(name):
    assert _same(getattr(ttables, name), getattr(jtables, name))


SAMPLE_RATES = [8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000]
TABLE_FUNCTIONS = [
    ("band_table", lambda f, sr: f(sr)),
    ("short_band_table", lambda f, sr: f(sr)),
    ("short_band_bounds", lambda f, sr: f(sr)),
    ("short_reorder_src", lambda f, sr: f(sr)),
    ("mixed_reorder_src", lambda f, sr: f(sr)),
    ("switch_bound", lambda f, sr: (f(sr, False), f(sr, True))),
    ("mixed_switch_bound", lambda f, sr: f(sr)),
    ("band_count", lambda f, sr: (f(sr, False), f(sr, True))),
    ("lsf_version", lambda f, sr: f(sr)),
    ("sample_rate_index", lambda f, sr: f(sr)),
]


@pytest.mark.parametrize("name,call", TABLE_FUNCTIONS, ids=[t[0] for t in TABLE_FUNCTIONS])
def test_table_function_copy_agrees(name, call):
    for sr in SAMPLE_RATES:
        assert _same(call(getattr(ttables, name), sr), call(getattr(jtables, name), sr)), sr


def _dc_is_copies():
    """(port value, original) of each constant distortion control and
    intensity stereo copy from swiftmp3_tpu/ops/dsp.py and reference.py."""
    from swiftmp3_tpu.ops import dsp as jdsp
    from swiftmp3_tpu.ops import reference as jref
    from swiftmp3_tpu_torch.ops import dsp as tdsp

    pairs = {
        name: (getattr(tdsp, name), getattr(jref, name))
        for name in ("IS_CORR", "IS_MIN_SFB", "IS_MIN_SFB_SHORT", "IS_NEG", "IS_SFM", "DC_BUMP_MAX")
    }
    for name in ("DC_RATIO", "DC_BUMP", "DC_MASK_OFFSET", "DC_CAPS", "QUARTER_POS"):
        pairs[name] = (getattr(tdsp, name), getattr(jdsp, "_" + name))
    pairs["_IS_RATES"] = (tdsp._IS_RATES, jdsp._IS_RATES)
    for sr in jdsp._IS_RATES:
        pairs[f"_is_members_ext({sr})"] = (tdsp._is_members_ext(sr), jdsp._IS_MEMBERS_EXT[sr])
        pairs[f"_IS_BOUNDS[{sr}]"] = (tdsp._is_bounds(sr), jdsp._IS_BOUNDS[sr])
        pairs[f"_is_members_short({sr})"] = (tdsp._is_members_short(sr), jdsp._IS_MEMBERS_SHORT[sr])
        pairs[f"_sb_bounds_for({sr})"] = (tdsp._sb_bounds_for(sr), jdsp._IS_SB_BOUNDS[sr])
        pairs[f"_band_members({sr})"] = (
            tdsp._band_members(sr), jdsp._BAND_MEMBERS[sr].astype(np.float32)
        )
    return pairs


DC_IS_COPIES = [
    "IS_CORR", "IS_MIN_SFB", "IS_MIN_SFB_SHORT", "IS_NEG", "IS_SFM", "DC_BUMP_MAX", "DC_RATIO",
    "DC_BUMP", "DC_MASK_OFFSET", "DC_CAPS", "QUARTER_POS", "_IS_RATES",
    *(f"{f}({sr})" for sr in (44100, 48000, 32000)
      for f in ("_is_members_ext", "_is_members_short", "_sb_bounds_for", "_band_members")),
    *(f"_IS_BOUNDS[{sr}]" for sr in (44100, 48000, 32000)),
]


@pytest.mark.parametrize("name", DC_IS_COPIES)
def test_dc_is_constant_copies_equal_the_originals(name):
    got, want = _dc_is_copies()[name]
    assert _same(got, want)


LSF_COPIES = ["LSF_NSF_LONG", "LSF_NSF_SHORT", "LSF_NSF_MIXED", "LSF_L3_BITRATES"]


@pytest.mark.parametrize("name", LSF_COPIES)
def test_lsf_constant_copies_equal_the_originals(name):
    """The LSF scalefactor groups (ops/dsp.py) and the MPEG-2 bitrates
    demand VBR chooses among (models/pipeline.py) against
    swiftmp3_tpu/ops/reference.py."""
    from swiftmp3_tpu.ops import reference as jref
    from swiftmp3_tpu_torch.ops import dsp as tdsp

    got = getattr(tpipe if name == "LSF_L3_BITRATES" else tdsp, name)
    assert isinstance(got, tuple) and got == getattr(jref, name)


VERBATIM = [
    "options.py",
    "streaming.py",
    *(f"tables/{n}" for n in ("__init__.py", "iso.py", "filterbank.py", "mdct.py", "huffman.py",
                               "_huffman_data.py", "_iso_window_data.py", "_linbits_data.py")),
    *(f"io/{n}" for n in ("__init__.py", "bitwriter.py", "crc.py", "sideinfo.py",
                           "huffman_pack.py", "framing.py", "xing.py", "id3.py")),
    "native/frame_render.cpp",
    "utils/wav.py",
    "utils/quality.py",
    "utils/external.py",
    "ops/reference.py",
    *(f"decoder/{n}" for n in ("__init__.py", "decoder.py", "tables.py", "_b7_data.py",
                                "_lsf_data.py", "_spec_data.py")),
]


# Copies whose module docstring is the port's own (it names no host path);
# everything after the docstring is byte-identical.
OWN_DOCSTRING = {"tables/__init__.py"}


@pytest.mark.parametrize("relpath", VERBATIM)
def test_verbatim_copy_is_byte_identical(relpath):
    with open(os.path.join(ROOT, "swiftmp3_tpu", relpath), "rb") as fh:
        ref = fh.read()
    with open(os.path.join(ROOT, "swiftmp3_tpu_torch", relpath), "rb") as fh:
        got = fh.read()
    if relpath in OWN_DOCSTRING:
        ref, got = ref.split(b'"""', 2)[2], got.split(b'"""', 2)[2]
        assert len(ref) > 100
    assert got == ref


def _class_source(relpath: str, head: str) -> str:
    """A class of a module, from `head` (its decorator or class line) to the
    end of its body."""
    with open(os.path.join(ROOT, relpath)) as fh:
        text = fh.read()
    start = text.index(head)
    return text[start : text.index("\n\n\n", start)]


def test_throughput_meter_is_a_verbatim_copy():
    head = "@dataclass\nclass ThroughputMeter"
    ref = _class_source("swiftmp3_tpu/utils/profiling.py", head)
    assert len(ref) > 800
    assert _class_source("swiftmp3_tpu_torch/utils/profiling.py", head) == ref


def test_golden_backend_is_a_verbatim_copy():
    head = "class GoldenBackend:"
    ref = _class_source("swiftmp3_tpu/encoder.py", head)
    assert len(ref) > 40000
    assert _class_source("swiftmp3_tpu_torch/encoder.py", head) == ref


def _option_kwargs(kw: dict) -> dict:
    """Fixture kwargs with the reference's Mode enum as its string value."""
    return {k: (v.value if isinstance(v, enum.Enum) else v) for k, v in kw.items()}


OPTION_CASES = {f"fixture_{name}": ("init", _option_kwargs(kw)) for name, kw, *_ in FIXTURES}
OPTION_CASES.update(
    {
        "default": ("init", {}),
        "spec_strict": ("spec_strict", {}),
        "spec_strict_lsf_22k": ("spec_strict", dict(sample_rate=22050)),
        "hq": ("hq", {}),
        "hq_64k_adaptive_lowpass": ("hq", dict(bitrate_kbps=64, mode="mono")),
        "hq_intensity_48k": ("hq", dict(mode="joint_stereo", intensity_stereo=True,
                                        bitrate_kbps=48)),
        "hq_distortion_control": ("hq", dict(distortion_control=True, bitrate_kbps=256)),
    }
)
DERIVED = [
    "channels", "lsf", "n_granules", "samples_per_frame", "reservoir_cap",
    "intensity_stereo_active", "distortion_control_active", "spec_strict_entropy",
]


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_options_copy_agrees_field_by_field(case):
    how, kw = OPTION_CASES[case]
    make = {
        "init": lambda m: m.MP3EncoderOptions(**kw),
        "spec_strict": lambda m: m.MP3EncoderOptions.spec_strict(**kw),
        "hq": lambda m: m.MP3EncoderOptions.hq(**kw),
    }[how]
    t, j = make(topt), make(jopt)
    assert type(t) is topt.MP3EncoderOptions and type(j) is jopt.MP3EncoderOptions
    for f in dataclasses.fields(j):
        assert _same(getattr(t, f.name), getattr(j, f.name)), f.name
    for name in DERIVED:
        assert _same(getattr(t, name), getattr(j, name)), name


def test_native_renderers_render_equal_bytes():
    """The port's batched render (built into swiftmp3_tpu_torch/_build/,
    through `BatchEncoder.drain`) and the reference's per-stream
    `render_packed` render one chunk program's outputs to the same bytes
    and frame sizes."""
    kw = dict(mode="joint_stereo", vbr=True, quality=4, crc_protected=True)
    o, jo = topt.MP3EncoderOptions(**kw), jopt.MP3EncoderOptions(**kw)
    B, T = 2, 5
    rng = np.random.default_rng(17)
    pcm = (rng.standard_normal((B, T, 2304)) * 0.2).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 3:] = False
    enc = tbatch.BatchEncoder(o, B, T, "cpu", render_threads=1)
    step = enc.step(pcm, np.zeros((B, T), bool), valid)
    got = [d + f for d, f in zip(enc.drain(step, valid), enc.flush())]
    outs = tpipe.fetch_outputs(step, o)
    for b in range(B):
        F = int(valid[b].sum())
        fields = [outs[k][b, :F] for k in (
            "bitrate_index", "padding", "mdb", "slot", "part23", "big_values", "gain",
            "block_type", "preflag", "region0", "region1", "subblock_gain", "main_data", "hb",
        )]
        extra = {k: outs[k][b, :F] for k in (
            "table_select", "count1table", "scalefac_compress", "scfsi", "mode_ext",
        )}
        r_j = jnative.NativeStreamRenderer(jo)
        want = r_j.render_packed(*fields, **extra) + r_j.flush_buffered()
        assert len(want) > 0 and got[b] == want
        assert enc.renderers[b].frame_sizes == r_j.frame_sizes


@pytest.mark.parametrize("how", ["missing", "failing"])
def test_failed_native_build_raises(monkeypatch, tmp_path, how):
    """Unlike the reference's renderer, which reports a failed build as
    unavailable, the port's raises with the compiler's output."""
    monkeypatch.setattr(tnative_lib, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative_lib, "_SO", str(tmp_path / "libmp3render.so"))
    if how == "missing":
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "native renderer build failed"
    else:
        src = tmp_path / "broken.cpp"
        src.write_text("int broken( {\n")
        monkeypatch.setattr(tnative_lib, "_SRC", str(src))
        match = r"g\+\+ exit [1-9]"
    with pytest.raises(RuntimeError, match=match) as err:
        tnative_lib._build()
    assert not os.path.exists(tnative_lib._SO)
    if how == "failing":
        assert "broken.cpp" in str(err.value)

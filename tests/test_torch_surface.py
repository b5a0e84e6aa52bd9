"""The port's package surface on the CPU: every module and public name of the
reference has its counterpart in the port, or a reason it has none; the
reference's names at package level, loaded lazily; `utils.profiling` (the
throughput meter on the reference's own case, a Chrome trace of a CPU op
with a named span); and the port's two examples run end to end at a tiny
size, their streams walked.

Nothing here imports JAX (the reference's name lists are read from its
sources).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import swiftmp3_tpu_torch
from swiftmp3_tpu_torch.utils.profiling import ThroughputMeter, annotate, device_trace

from . import torch_inputs as ti

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))


def _exports(relpath: str) -> set:
    """The keys of a module's _EXPORTS dict, read from its source."""
    with open(os.path.join(ROOT, relpath)) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "_EXPORTS":
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"{relpath} has no _EXPORTS")


# Reference modules the port has no module for, each with its reason.
NOT_PORTED = {}
# Reference modules whose counterpart lies at another path.
MOVED = {
    "__graft_entry__.py": "swiftmp3_tpu_torch/graft_entry.py",
    "swiftmp3_tpu/ops/pallas_kernels.py": "swiftmp3_tpu_torch/ops/kernels.py",
}
# The CUDA sources: the Pallas kernels' (K1, K2, K3), and, under the port's
# wrapper name, those of the kernels no Pallas kernel stands behind (K4, K5).
CUDA_SOURCES = {
    "rate_sweep_pallas": "swiftmp3_tpu_torch/ops/csrc/rate_sweep.cu",
    "pack_pallas": "swiftmp3_tpu_torch/ops/csrc/pack.cu",
    "polyphase_chunk_pallas": "swiftmp3_tpu_torch/ops/csrc/polyphase.cu",
    "rate_loop_scan": "swiftmp3_tpu_torch/ops/csrc/rate_loop_scan.cu",
    "strict_sweep": "swiftmp3_tpu_torch/ops/csrc/strict_sweep.cu",
}
_KERNELS = "swiftmp3_tpu_torch/ops/kernels.py"
_PORT_DSP = "swiftmp3_tpu_torch/ops/dsp.py"
_PORT_PIPELINE = "swiftmp3_tpu_torch/models/pipeline.py"
# Public names of a ported module whose counterpart has another name or
# module: reference module -> {name: "port module:name"}.
RENAMED = {
    "swiftmp3_tpu/models/pipeline.py": {"TPUBackend": f"{_PORT_PIPELINE}:TorchBackend"},
    "swiftmp3_tpu/ops/dsp.py": {
        "MAX_FRAME_MAIN_BITS": f"{_PORT_PIPELINE}:MAX_FRAME_MAIN_BITS",
        "ONSET_RATIO_F": f"{_PORT_DSP}:ONSET_RATIO",
        "OFFSET_RATIO_F": f"{_PORT_DSP}:OFFSET_RATIO",
        "big_values_from_quantized": f"{_KERNELS}:rate_sweep_plain",
        "pack_main_data": f"{_KERNELS}:pack_plain",
        "polyphase_chunk": f"{_KERNELS}:polyphase_chunk_plain",
    },
    "swiftmp3_tpu/ops/pallas_kernels.py": {
        "rate_sweep_pallas": f"{_KERNELS}:rate_sweep",
        "pack_pallas": f"{_KERNELS}:pack",
        "polyphase_chunk_pallas": f"{_KERNELS}:polyphase_chunk",
    },
}
_LOOKUPS = "a TPU form (where-tree or one-hot lookup, no gather): the port indexes its tables"
_FRAME_OPS = "a frame-at-a-time op no path of the chunk program runs"
# Public names of a ported module that the port leaves out, each with its
# reason: reference module -> {name: reason}.
LEFT_OUT = {
    "swiftmp3_tpu/models/pipeline.py": {
        "make_chunk_encoder": "the cache of jitted JAX programs: the port runs make_chunk_fn eagerly",
    },
    "swiftmp3_tpu/ops/dsp.py": {
        "t15_code_lookup": _LOOKUPS,
        "t15_length_lookup": _LOOKUPS,
        "inv_step_lookup": _LOOKUPS,
        "inv_step34_lookup": _LOOKUPS,
        "sf_mult34_lookup": _LOOKUPS,
        "validate_gather_free_lookups": "the tests' check of the TPU-form lookups",
        "polyphase_frame": _FRAME_OPS,
        "mdct_frame": _FRAME_OPS,
        "rate_loop": _FRAME_OPS,
        "mdct_chunk_blocksparse": "an alternative form of mdct_chunk that no path runs",
    },
    "swiftmp3_tpu/ops/pallas_kernels.py": {
        name: "a Pallas tile size: each CUDA kernel sizes its own" for name in ("BF_B", "BG", "BN", "BT")
    },
    "swiftmp3_tpu/parallel/mesh.py": {"time_major_sharding": "deprecated in the reference"},
    "swiftmp3_tpu/native/lib.py": {
        "native_available": "the port's build raises when it fails, so there is nothing to ask",
    },
    "swiftmp3_tpu/utils/__init__.py": {
        "enable_compilation_cache": "JAX's compilation cache: the port compiles no program ahead",
    },
}


def _public_names(relpath: str) -> set:
    """Names a module binds at its top level that do not start with _."""
    with open(os.path.join(ROOT, relpath)) as fh:
        tree = ast.parse(fh.read(), relpath)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _reference_modules() -> list:
    mods = ["__graft_entry__.py"]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "swiftmp3_tpu")):
        mods += [os.path.relpath(os.path.join(dirpath, f), ROOT) for f in files if f.endswith(".py")]
    return sorted(mods)


def test_every_reference_module_has_its_counterpart():
    """Each module of the reference (and its graft entry) has the port's
    module at the same path, at the path MOVED gives, or a reason in
    NOT_PORTED; each public name of a ported module is defined in the port's
    module, has the counterpart RENAMED gives (which must exist), or a
    reason in LEFT_OUT (and is then absent). Every map entry names a real
    module and name, so none goes stale. Sources are read, not imported."""
    mods = _reference_modules()
    assert "swiftmp3_tpu/models/pipeline.py" in mods and len(mods) > 30
    seen = set()
    for mod in mods:
        skip = [p for p in NOT_PORTED if mod == p or mod.startswith(p)]
        if skip:
            seen.update(skip)
            continue
        port = MOVED.get(mod, mod.replace("swiftmp3_tpu/", "swiftmp3_tpu_torch/", 1))
        assert os.path.exists(os.path.join(ROOT, port)), f"{mod}: no {port}"
        have = _public_names(port)
        renamed, left_out = RENAMED.get(mod, {}), LEFT_OUT.get(mod, {})
        names = _public_names(mod)
        assert set(renamed) | set(left_out) <= names, f"{mod}: stale map entries"
        for name in sorted(names):
            if name in renamed:
                where, other = renamed[name].split(":")
                assert other in _public_names(where), f"{mod}:{name} -> {renamed[name]} is missing"
            elif name in left_out:
                assert name not in have, f"{mod}:{name} is ported; drop it from LEFT_OUT"
            else:
                assert name in have, f"{port} lacks {name}, the counterpart of {mod}:{name}"
    assert seen == set(NOT_PORTED), f"stale NOT_PORTED entries: {set(NOT_PORTED) - seen}"
    assert set(MOVED) <= set(mods) and set(RENAMED) | set(LEFT_OUT) <= set(mods)
    for kernel, source in CUDA_SOURCES.items():
        assert kernel in RENAMED["swiftmp3_tpu/ops/pallas_kernels.py"] or kernel in _public_names(_KERNELS)
        assert os.path.exists(os.path.join(ROOT, source)), source


def test_package_exports_the_reference_names():
    from swiftmp3_tpu_torch import EncoderSession, ID3Tag, MP3Encoder, MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch import encoder, options

    assert (MP3Encoder, EncoderSession) == (encoder.MP3Encoder, encoder.EncoderSession)
    assert (MP3EncoderOptions, Mode, ID3Tag) == (options.MP3EncoderOptions, options.Mode, options.ID3Tag)
    assert set(swiftmp3_tpu_torch.__all__) == _exports("swiftmp3_tpu/__init__.py") | {"__version__"}
    assert set(dir(swiftmp3_tpu_torch)) >= set(swiftmp3_tpu_torch.__all__)
    import swiftmp3_tpu_torch.parallel as tpar

    ref = _exports("swiftmp3_tpu/parallel/__init__.py") - {"time_major_sharding"}
    assert set(tpar.__all__) == ref and all(callable(getattr(tpar, n)) for n in ref)
    with pytest.raises(AttributeError):
        swiftmp3_tpu_torch.time_major_sharding  # noqa: B018
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    pcm = ti.make_signal("mix", 0.1, 44100, 1, 3)
    s = MP3Encoder(MP3EncoderOptions(mode=Mode.MONO), device="cpu").new_session()
    assert len(ti.walk_frames(s.encode(pcm) + s.flush())) == 4


def test_package_and_parallel_import_lazily():
    """Importing the package or its parallel layer loads neither the session
    nor the chunk program (a multi-process job can still call
    initialize_multihost first); the fp32 pin runs at import."""
    code = (
        "import sys, torch, swiftmp3_tpu_torch, swiftmp3_tpu_torch.parallel as p\n"
        "mods = [m for m in ('swiftmp3_tpu_torch.encoder', 'swiftmp3_tpu_torch.parallel.batch',"
        " 'swiftmp3_tpu_torch.models.pipeline') if m in sys.modules]\n"
        "assert not mods, mods\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "p.initialize_multihost\n"
        "assert 'swiftmp3_tpu_torch.parallel.batch' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_throughput_meter_matches_the_reference_case():
    """tests/test_components.py's case on the port's copy."""
    m = ThroughputMeter(sample_rate=44100)
    m.start()
    m.stop(frames=100, bytes_out=41700)
    s = m.summary()
    assert s["frames"] == 100
    assert s["audio_seconds"] == pytest.approx(100 * 1152 / 44100, abs=1e-3)
    assert s["realtime_factor"] > 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "traces"
    with device_trace(str(log_dir)) as prof:
        with annotate("port span"):
            torch.ones(64).cumsum(0)
    (path,) = list(log_dir.iterdir())
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "port span" in names and any("cumsum" in str(n) for n in names)
    assert any(e.key == "port span" for e in prof.key_averages())


def _split_id3(data: bytes) -> bytes:
    assert data[:3] == b"ID3"
    size = (data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14 | (data[8] & 0x7F) << 7 | data[9] & 0x7F
    return data[10 + size :]


def test_podcast_corpus_example_on_the_cpu(tmp_path):
    import torch_podcast_corpus

    out = tmp_path / "out"
    assert torch_podcast_corpus.main(["--streams", "3", "--seconds", "0.5", "--frames-per-step", "16",
                                      "--outdir", str(out), "--device", "cpu"]) == 0
    files = sorted(out.iterdir())
    assert [f.name for f in files] == [f"episode_{i:04d}.mp3" for i in range(3)]
    for f in files:
        data = f.read_bytes()
        assert b"Episode" in data[:200]
        frames = ti.walk_frames(_split_id3(data))  # the Info frame, then the audio
        assert len(frames) > 20 and {fr["bitrate_kbps"] for fr in frames} == {128}


def test_live_serving_example_on_the_cpu(monkeypatch):
    import torch_live_serving

    from swiftmp3_tpu_torch.parallel import pool

    results = {}
    result = pool.StreamPool.result

    def keep(self, sid):
        results[sid] = result(self, sid)
        return results[sid]

    monkeypatch.setattr(pool.StreamPool, "result", keep)
    assert torch_live_serving.main(["--lanes", "4", "--frames-per-step", "8", "--streams", "3",
                                    "--seconds-mean", "1", "--arrivals-per-step", "2",
                                    "--device", "cpu"]) == 0
    assert sorted(results) == [0, 1, 2]
    for data in results.values():
        frames = ti.walk_frames(data)
        assert len(frames) >= 38 and {f["mode"] for f in frames} == {0}  # >= 1 s of stereo

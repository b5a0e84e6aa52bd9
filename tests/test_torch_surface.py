"""The port's package surface on the CPU: the reference's names at package
level, loaded lazily; `utils.profiling` (the throughput meter on the
reference's own case, a Chrome trace of a CPU op with a named span); and the
port's two examples run end to end at a tiny size, their streams walked.

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

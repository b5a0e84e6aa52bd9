"""A configuration, a traffic mix, a load loop and a metric are added by
adding their files and entries only: a throwaway set made in a temporary
directory runs through the unchanged harness. A cell's chips reach its
loop. And BENCHMARK.json names only what exists."""

from __future__ import annotations

import json
import os
import re

from portbench import spec

from .conftest import TINY, bench_with, tiny_run


def test_a_config_a_mix_a_loop_and_a_metric_added_as_files_run_unchanged(tmp_path):
    root = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (root / d).mkdir(parents=True)
    (root / "configs" / "mono96.json").write_text(json.dumps({
        "name": "mono96", "preset": None,
        "options": {"mode": "MONO", "bitrate_kbps": 96, "sample_rate": 44100},
        "check": {"golden_frames": 4000, "limits": {"frames_differing_pct": 5.0}}, "reduced": [],
    }))
    mix = json.load(open(os.path.join(spec.HERE, "traffic", "corpus.json")))
    mix.update(TINY["corpus"], streams_per_job=3, loop="replay")
    (root / "traffic" / "short_clips.json").write_text(json.dumps(mix))
    # a loop of a new kind: the corpus loop, its jobs counted under a name of its own
    (root / "loops").mkdir()
    (root / "loops" / "replay.py").write_text(
        "from portbench import spec\n\n"
        "class Loop(spec.load_loop('corpus')):\n"
        "    def record(self, rec):\n"
        "        super().record(rec)\n"
        "        rec.counters['replayed'] = len(self.jobs)\n"
    )
    (root / "metrics" / "jobs_in_window.py").write_text(
        "def read(rec):\n    return rec.counters.get('replayed') or None\n"
    )
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "mono96", "source": "throwaway", "file": "bench/configs/mono96.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mono96.short_clips", "config": "mono96", "traffic": "short_clips",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["mono96.short_clips"]})
    # the stock metrics and mixes stay where they are; the new ones are found under root
    for name in ("setup_s",):
        (root / "metrics" / f"{name}.py").write_text(open(os.path.join(spec.HERE, "metrics", f"{name}.py")).read())
    result, _ = tiny_run("mono96.short_clips", bench=bench, repo=str(tmp_path), root=str(root))
    assert result["correct"], result["checks"]
    assert result["metrics"]["jobs_in_window"]["value"] >= 1
    assert set(result["metrics"]) == {"jobs_in_window", "setup_s"}
    assert result["attempted"] >= 3


def test_a_cells_chips_reach_its_loop():
    """A cell on two chips is encoded over a mesh of two positions (on the
    CPU here, each its own position) and reports the two."""
    cell = {"name": "compat128.corpus2", "config": "compat128", "traffic": "corpus", "chips": 2, "why": "a test"}
    bench = bench_with(cell)
    for m in bench["end_to_end"]:
        m.get("workloads", []).append(cell["name"])
    seen = []
    from swiftmp3_tpu_torch.parallel import batch

    encode = batch.encode_corpus

    def spy(*args, mesh=None, **kwargs):
        seen.append(mesh.size if mesh is not None else 1)
        return encode(*args, mesh=mesh, **kwargs)

    batch.encode_corpus = spy
    try:
        result, lines = tiny_run(cell["name"], bench=bench)
    finally:
        batch.encode_corpus = encode
    assert result["correct"], lines
    assert result["device"]["count"] == 2 and set(seen) == {2}
    assert "corpus_audio_s_per_s" in result["metrics"]


def test_benchmark_names_only_what_exists():
    bench = spec.load_benchmark()
    names = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for c in bench["configs"]:
        cfg = spec.load_config(bench, c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert "check" in cfg and "options" in cfg
    for w in bench["workloads"]:
        assert names.match(w["name"]) and w["chips"] == 1
        assert callable(spec.load_loop(spec.load_mix(w["traffic"])["loop"]))
        assert any(c["name"] == w["config"] for c in bench["configs"])
        e2e = [m["name"] for m in spec.cell_metrics(bench, w["name"], trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.cell_metrics(bench, w["name"], trace=True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert names.match(m["name"]), m["name"]
        assert os.path.exists(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for w in m["workloads"]:  # each cell a per-layer metric names reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)

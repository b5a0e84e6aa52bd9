"""Run one cell of `BENCHMARK.json` once, on the card, and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (importing the port, building or loading its kernels and renderer,
making the audio from the seed, warming every shape the window uses) is
timed as `setup_s`; then the cell's load loop (`loops/<name>.py`, named by
its traffic mix) runs for `--seconds` on as many cards as the cell asks
for. With `--trace 0` the result carries the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics, read from spans, counters and a
profiled stretch of the window. After the window the outputs are held against the
golden encoder (`check.py`); each number compared is printed beside its
limit as the last lines on standard error and under "checks", the last key
of the result, the last line on standard output.

The run exits with a nonzero code and prints no result without a card (or
with fewer than the cell asks for), and when `jax`, `jaxlib`, `flax` or the
JAX package `swiftmp3_tpu` is loaded once the window has closed.

`--control tf32` runs the port with TF32 matmuls, the precision below the
float32 the configuration states: the control that `correct` must refuse.
The benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "swiftmp3_tpu")
WORKERS = 8  # golden encoder processes after the window


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN (whole
    names: `swiftmp3_tpu_torch` is not `swiftmp3_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(repo: str) -> None:
    """Keep any build or kernel cache inside the checkout, at fixed paths
    (the port builds its kernels and renderer into its own `_build/`)."""
    base = os.path.join(repo, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: str | None = None, mix_overrides: dict | None = None,
             workers: int = WORKERS, repo: str | None = None, root: str | None = None) -> tuple[dict, list[str]]:
    """One run of `cell`: (the result, the lines that print each compared
    number beside its limit). Configuration files are found under `repo`
    (the checkout), mixes, load loops and metric readers under `root` (this
    package). The loop gets one device a chip of the cell."""
    import torch

    from . import check, spec
    from .readers import Record
    from .tracing import Tracer

    import swiftmp3_tpu_torch as port

    t_import = time.perf_counter()

    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    repo, root = repo or spec.REPO, root or spec.HERE
    cfg = spec.load_config(bench, cell["config"], repo)
    mix = dict(spec.load_mix(cell["traffic"], root), **(mix_overrides or {}))
    options = check.build_options(port.MP3EncoderOptions, port.Mode, cfg)
    cuda = torch.device(device).type == "cuda"
    # one device a chip of the cell: the cards 0..chips-1, or the CPU once a chip
    devices = [torch.device(device, i) if cuda else torch.device(device) for i in range(cell["chips"])]
    loop = spec.load_loop(mix["loop"], root)(options, mix, seed, devices)
    tracer = Tracer(mix["profile"]["skip_steps"], mix["profile"]["steps"], cuda, len(devices)) if trace else None
    with tracer or contextlib.nullcontext():
        loop.setup()
        t_setup = time.perf_counter()
        if cuda:
            if tracer is not None:
                tracer.warm()
            for d in devices:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - t_start
        if tracer is not None:
            tracer.on = True
        window = loop.window(seconds)
        if tracer is not None:
            tracer.on = False
    rec = Record(setup_s=setup_s, window=window)
    loop.record(rec)
    notes = [f"set-up: imports {t_import - t_start:.3f} s, audio {loop.audio_made_s:.3f} s, "
             f"warm-up {t_setup - t_import - loop.audio_made_s:.3f} s"] + loop.notes(window)
    if tracer is not None:
        rec.spans, rec.counters = dict(tracer.spans), dict(tracer.counters)
        rec.step_device_ms = tracer.step_device_ms() if cuda else []
        rec.profile = tracer.profile
        if rec.profile is not None:
            p = rec.profile
            notes.append(
                f"stretch: {p['steps']} steps, {p['kernels']} kernels, busy {p['busy_s']:.6f} of {p['window_s']:.6f} s; "
                + ", ".join(f"{k} {len(p['launches'].get(k, []))} launches, {c} kernels, {t:.6f} s"
                            for k, (c, t) in p["kernel_s"].items())
            )
    # the peak of the fullest card
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    outputs = loop.outputs()
    loop.close()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    verdict = check.compare(outputs, cfg, seed, with_header=loop.with_header, workers=workers)
    notes.append(f"window {window[1] - window[0]:.3f} s, check {time.perf_counter() - t_check:.3f} s")
    attempted, failed, own = loop.tally(verdict)
    checks = dict(verdict["checks"], **own)
    checks["jax_modules"] = {"value": len(forbidden_modules()), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = spec.read_metrics(spec.cell_metrics(bench, cell["name"], trace), rec, root)
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": len(devices),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        result["breakdown"] = {
            "device_ops": rec.profile["device_ops"],
            "idle_gaps": rec.profile["idle_gaps"],
        }
    result["checks"] = checks
    lines = notes + [
        f"sampled {verdict['sampled']} outputs ({verdict['sampled_frames']} frames) of {len(outputs)}; "
        + ", ".join(f"{k} {v}" for k, v in verdict["info"].items()),
    ] + [f"{name} {c['value']} limit {c['limit']}" for name, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from . import spec

    cache_dirs(spec.REPO)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); found {have}", file=sys.stderr)
        return 3
    result, lines = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start,
                             control=args.control)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

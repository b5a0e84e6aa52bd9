#!/usr/bin/env python3
"""Where a step of the PyTorch port's main path spends its time, on one GPU.

    python3 tools/torch_profile_step.py            # the compat main path
    python3 tools/torch_profile_step.py --strict   # the spec_strict path
    python3 tools/torch_profile_step.py --hq       # the hq path
    python3 tools/torch_profile_step.py --dc       # hq mono 128 kbps, distortion control
    python3 tools/torch_profile_step.py --is       # hq joint stereo 32 kbps, intensity stereo
    python3 tools/torch_profile_step.py --lsf      # 22.05 kHz, ISO law (the LSF K1 path)
    python3 tools/torch_profile_step.py --lsf --strict  # spec_strict joint stereo 64 kbps, 22.05 kHz
    python3 tools/torch_profile_step.py --lsf --hq      # hq mono 48 kbps, 16 kHz

Runs the port's BatchEncoder at the main path's shape (256 streams x 128
frames, bench audio; 128 kbps CBR stereo 44.1 kHz, or with --strict
MP3EncoderOptions.spec_strict(joint stereo, 128 kbps, 44.1 kHz), or with
--hq MP3EncoderOptions.hq(joint stereo, 128 kbps, 44.1 kHz), each frame's
lookahead granule built as bench.py builds it; with --dc the hq preset's
distortion control in mono at 128 kbps on the bench audio's left channel,
with --is its intensity stereo in joint stereo at 32 kbps on panned two-tone
audio, tests/torch_inputs.DC_IS_OPTIONS; with --lsf the LSF path of the
same program, tests/torch_inputs.LSF_PATHS, on 128 frames of 576 samples of
bench audio at its rate) for two warm-up steps, then:

  1. phase wall times of one step, with a device synchronise at each phase
     boundary. Compat: phase 1 up to and including the rate sweep, the
     integer loop over T, and phase 3 (finalize, pack, output assembly,
     carry-out). Strict and hq: ingest, stereo decision and filterbank,
     (hq) the window sequencing, the MDCT, the scalefactors and gains, the
     strict sweep (and the share of it in K5), the loop
     over T, finalize, the second loop and the chunks, the pack, and the
     output assembly; --dc splits each sweep and each distortion-control
     pass out (the probe selection, quantization, bumps and rebuilt
     scalefactors before its sweep), --is the intensity analysis and
     transform and the post-walk position slots;
  2. (strict, hq) CUDA-event device times of the strict sweep on that
     step's own inputs, and of K5 (`ops/csrc/strict_sweep.cu`) alone there:
     by events, device-only (a CUDA graph), the host's us a call, its plain
     version, and its bound;
  3. torch.profiler over one more step: device time by kernel, the number
     of kernel launches, and the device's busy share of the step;
  4. (compat) the filterbank stage (the counterpart of
     tools/profile_step.py's): on that step's own chunk and history,
     CUDA-event times of the plain stepwise filterbank, the production
     folded matmul, the K3 kernel (`ops/csrc/polyphase.cu`) and the one
     PyTorch call that computes the same subband samples, conv1d (a
     yardstick the port never calls).

Prints the card's name and power limit beside the numbers. Needs a CUDA
card; imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over reps runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device-only time of fn() in ms: CUDA events around replays of one
    CUDA graph of reps calls, per call. The graph holds the kernels alone,
    so the wrapper's host work (checks, allocation, the launch call) is out
    of the reading. fn runs once first, outside the graph."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def host_us(fn, reps: int = 20) -> float:
    """Host time of one fn() call in microseconds, over reps calls issued
    back to back (the card drains them after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def filterbank_input(pcm_i16: np.ndarray, device) -> torch.Tensor:
    """The main path's filterbank input for one step of stereo audio: int16
    [B, T, 2304] ingested and split into [B, 2, T*1152] float32 channels
    (pipeline.make_chunk_fn, stereo mode)."""
    from swiftmp3_tpu_torch.ops import dsp

    B = pcm_i16.shape[0]
    pcm = dsp.ingest(torch.from_numpy(pcm_i16).to(device)).reshape(B, -1)
    return torch.stack([pcm[:, 0::2], pcm[:, 1::2]], dim=1).contiguous()


def conv1d_weight(device) -> torch.Tensor:
    """C.T as [32, 1, 512]: C[u, k] = Wrev[u] * MrevT[u % 64, k], so
    conv1d(x [N, 1, L], C.T, stride=32) is S transposed."""
    from swiftmp3_tpu_torch.ops import dsp

    C = dsp.WINDOW_REV.astype(np.float64)[:, None] * dsp.MATRIX_REV_T.astype(
        np.float64
    )[np.arange(512) % 64]
    return torch.from_numpy(np.ascontiguousarray(C.T, dtype=np.float32)[:, None, :]).to(device)


def filterbank_stage(hist: torch.Tensor, chunk: torch.Tensor) -> dict:
    """Time the filterbank four ways on one chunk (hist [..., 480], chunk
    [..., T*1152] on the card): the plain stepwise version (`plain_ms`,
    with its concatenation), the production folded matmul (`matmul_ms`,
    with its concatenation), the K3 kernel alone (`ms`: S only, x is a
    concatenation outside it) and conv1d on the concatenated signal
    (`library_ms`). Launches K3 22 times."""
    import torch.nn.functional as F

    from swiftmp3_tpu_torch.ops import dsp, kernels

    x = torch.cat([hist, chunk], dim=-1).reshape(-1, 1, hist.shape[-1] + chunk.shape[-1])
    weight = conv1d_weight(chunk.device)
    return {
        "plain_ms": cuda_ms(lambda: kernels.polyphase_chunk_plain(hist, chunk), reps=5, warmup=1),
        "matmul_ms": cuda_ms(lambda: dsp.polyphase_chunk_matmul(hist, chunk), reps=20),
        "ms": cuda_ms(lambda: kernels.polyphase_subbands(hist, chunk), reps=20),
        "library_ms": cuda_ms(lambda: F.conv1d(x, weight, stride=32), reps=20),
    }


def _instrument(marks: dict, captured: dict, strict: bool):
    """Wrap the functions at the phase boundaries of a step: each wrapper
    synchronises the card and stamps marks[before] / marks[after]; K5's
    calls inside the strict sweeps add their synchronised time to
    marks["k5_s"]. The first call's arguments land in `captured`.
    Returns a function that undoes the wrapping."""
    from swiftmp3_tpu_torch.models import pipeline
    from swiftmp3_tpu_torch.ops import dsp, kernels

    if strict:
        points = [
            (dsp, "mdct_chunk", "mdct_start", "mdct_end"),
            (dsp, "rate_loop_precompute_strict", "sweep_start", "sweep_end"),
            (dsp, "strict_finalize", "loop_end", "finalize_end"),
            (kernels, "pack", "pack_start", "pack_end"),
        ]
    else:
        points = [
            (dsp, "rate_loop_precompute", None, "phase1_end"),
            (dsp, "rate_loop_finalize", "loop_end", None),
        ]
    saved = []

    def wrap(mod, name, before, after):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapper(*a, **kw):
            captured.setdefault(name, (a, kw))
            torch.cuda.synchronize()
            t = time.perf_counter()
            if before:
                marks.setdefault(before, t)
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            if after:
                marks[after] = time.perf_counter()
            if name == "strict_sweep" and "sweep_end" not in marks:
                marks["k5_s"] = marks.get("k5_s", 0.0) + time.perf_counter() - t
            if name in ("rate_loop_precompute_strict", "distortion_pass"):
                marks.setdefault(name, []).append(time.perf_counter() - t)
            return out

        setattr(mod, name, wrapper)

    for point in points:
        wrap(*point)
    if strict:
        wrap(kernels, "strict_sweep", None, None)
        wrap(dsp, "onset_wants_chunk", "seq_start", None)
        wrap(pipeline, "distortion_pass", None, None)
        wrap(pipeline, "intensity_stage", "is_start", "is_end")
        wrap(pipeline, "intensity_post_walk_sfd", "post_start", "post_end")

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return undo


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:] if argv is None else argv
    dc, intensity, lsf = "--dc" in args, "--is" in args, "--lsf" in args
    hq = "--hq" in args or dc or intensity
    strict = hq or "--strict" in args
    name = "hq dc" if dc else "hq is" if intensity else "hq" if hq else "strict" if strict else "compat"
    if lsf:
        name = "lsf hq" if hq else "lsf strict" if strict else "lsf iso"

    from swiftmp3_tpu_torch.ops import dsp, kernels
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from swiftmp3_tpu_torch.parallel.batch import BatchEncoder
    from tests.torch_inputs import B_MAIN as B
    from tests.torch_inputs import T_MAIN as T
    from tests.torch_inputs import (
        HQ_OPTIONS,
        LSF_PATHS,
        MAIN_OPTIONS,
        STRICT_OPTIONS,
        bench_audio,
        build_options,
        dc_is_options,
        panned_audio,
        step_lookahead,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    if lsf:
        opts = build_options(*LSF_PATHS[name], MP3EncoderOptions)
    elif dc:
        opts = dc_is_options("hq_dc_mono128", MP3EncoderOptions)
    elif intensity:
        opts = dc_is_options("hq_is_32k", MP3EncoderOptions)
    elif hq:
        opts = MP3EncoderOptions.hq(**HQ_OPTIONS["hq_joint"])
    elif strict:
        opts = MP3EncoderOptions.spec_strict(**STRICT_OPTIONS)
    else:
        opts = MP3EncoderOptions(**MAIN_OPTIONS)
    rng = np.random.default_rng(0)
    if intensity:
        audio = [panned_audio(rng, B, T, opts.sample_rate) for _ in range(4)]
    else:
        audio = [bench_audio(rng, B, T, 2, opts.sample_rate, opts.samples_per_frame) for _ in range(4)]
    if opts.channels == 1:  # the bench audio is dual mono
        audio = [a[..., 0::2].copy() for a in audio]
    final = np.zeros((B, T), bool)
    valid = np.ones((B, T), bool)
    enc = BatchEncoder(opts, B, T)

    def step(k):
        la = step_lookahead(audio, k, opts.channels) if opts.window_sequencing else None
        return enc.step(audio[k], final, valid, la)

    try:
        for k in range(2):
            enc.drain(step(k), valid)

        # 1. phase wall times (synchronised boundaries)
        marks, captured = {}, {}
        undo = _instrument(marks, captured, strict)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = step(2)
            outs["ready"].synchronize()
            t1 = time.perf_counter()
        finally:
            undo()
        enc.drain(outs, valid)
        ms = lambda a, b: (marks[b] - marks[a]) * 1e3  # noqa: E731
        marks["t0"], marks["t1"] = t0, t1
        if strict:
            sweep = ms("sweep_start", "sweep_end")
            first = 1e3 * marks["rate_loop_precompute_strict"][0]  # the first sweep
            k5 = marks["k5_s"] * 1e3
            front = (
                f"ingest+filterbank {ms('t0', 'seq_start'):.2f} ms, window sequencing "
                f"{ms('seq_start', 'mdct_start'):.2f} ms"
                if hq
                else f"ingest+filterbank {ms('t0', 'mdct_start'):.2f} ms"
            )
            print(f"[phases] {name} B={B} T={T} {card}: {front}, MDCT "
                  f"{ms('mdct_start', 'mdct_end'):.2f} ms, "
                  f"scalefactors+gains {ms('mdct_end', 'sweep_start'):.2f} ms, strict sweep(s) "
                  f"{sweep:.2f} ms (the first {first:.2f} ms, K5 in the sweeps {k5:.2f} ms), loop "
                  f"over T {ms('sweep_end', 'loop_end'):.2f} ms, "
                  f"finalize {ms('loop_end', 'finalize_end'):.2f} ms, second loop+chunks "
                  f"{ms('finalize_end', 'pack_start'):.2f} ms, pack {ms('pack_start', 'pack_end'):.2f} ms, "
                  f"output+carry+D2H {ms('pack_end', 't1'):.2f} ms, step {ms('t0', 't1'):.2f} ms "
                  f"(synchronised)", flush=True)
            if dc:
                sweeps = marks["rate_loop_precompute_strict"]
                passes = marks["distortion_pass"]
                print(f"[dc] {opts.dc_passes} pass(es): sweeps {['%.2f' % (1e3 * x) for x in sweeps]} "
                      f"ms, probe+bumps+scalefactors {['%.2f' % (1e3 * x) for x in passes]} ms; one "
                      f"pass (probe+bumps+scalefactors+sweep) "
                      f"{1e3 * (passes[0] + sweeps[1]):.2f} ms, {card}", flush=True)
            if intensity:
                print(f"[is] intensity analysis+transform {ms('is_start', 'is_end'):.2f} ms, "
                      f"post-walk position slots {ms('post_start', 'post_end'):.2f} ms, {card}",
                      flush=True)
            # 2. device times of the sweep and of K5 on this step's inputs
            a, kw = captured["rate_loop_precompute_strict"]
            sweep_ms = cuda_ms(lambda: dsp.rate_loop_precompute_strict(*a, **kw), reps=3, warmup=1)
            from chip_smoke import _strict_sweep_bound

            a, kw = captured["strict_sweep"]
            k5 = lambda: kernels.strict_sweep(*a, **kw)  # noqa: E731
            k5_ms, k5_device_ms, k5_host = cuda_ms(k5, reps=20), graph_ms(k5), host_us(k5)
            plain_ms = cuda_ms(lambda: kernels.strict_sweep_plain(*a, **kw), reps=3, warmup=1)
            n = a[1].numel()
            bound_ms, bound_by = _strict_sweep_bound(n)
            print(f"[sweep] {name} sweep {sweep_ms:.2f} ms device (20 gains, K5 and the torch "
                  f"ops around it); [K5] strict_sweep N={n}: {k5_ms:.4f} ms by events "
                  f"({100 * bound_ms / k5_ms:.1f}% of its bound), {k5_device_ms:.4f} ms "
                  f"device-only ({100 * bound_ms / k5_device_ms:.1f}%), host {k5_host:.1f} us a "
                  f"call, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}), {card}",
                  flush=True)
            captured.clear()
        else:
            print(f"[phases] B={B} T={T} {card}: phase1+sweep {ms('t0', 'phase1_end'):.2f} ms, "
                  f"loop over T {ms('phase1_end', 'loop_end'):.2f} ms, phase3+pack+D2H "
                  f"{ms('loop_end', 't1'):.2f} ms, step {ms('t0', 't1'):.2f} ms (synchronised)",
                  flush=True)

        # 3. profiler over one unsynchronised step
        hist = enc.carry["fb_hist"].clone()  # the profiled step's history
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            outs = step(3)
            outs["ready"].synchronize()
            wall = time.perf_counter() - t0
        enc.drain(outs, valid)
    finally:
        enc.close()

    kernel_events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
    ]
    busy_us = sum(e.device_time_total for e in kernel_events)
    print(f"[profile] {name} step wall {wall * 1e3:.2f} ms, "
          f"{len(kernel_events)} device events, device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of the step), {card}", flush=True)
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=25))

    if not (strict or lsf):
        # 4. the filterbank stage on the profiled step's chunk
        fb = filterbank_stage(hist, filterbank_input(audio[3], "cuda"))
        print(f"[filterbank] {B * 2} rows x T={T} ({36 * T} windows), {card}: "
              f"plain stepwise {fb['plain_ms']:.4f} ms, folded matmul {fb['matmul_ms']:.4f} ms, "
              f"K3 kernel {fb['ms']:.4f} ms, conv1d {fb['library_ms']:.4f} ms", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

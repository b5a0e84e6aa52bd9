#!/usr/bin/env python3
"""Where a step of the PyTorch port's main path spends its time, on one GPU.

    python3 tools/torch_profile_step.py

Runs the port's BatchEncoder at the main path's shape (256 streams x 128
frames, 128 kbps CBR stereo 44.1 kHz, bench audio) for two warm-up steps,
then:

  1. phase wall times of one step, with a device synchronise at each phase
     boundary: phase 1 up to and including the rate sweep, the integer loop
     over T, and phase 3 (finalize, pack, output assembly, carry-out);
  2. torch.profiler over one more step: device time by kernel, the number
     of kernel launches, and the device's busy share of the step.

Prints the card's name and power limit beside the numbers. Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    from chip_smoke import B_MAIN as B
    from chip_smoke import T_MAIN as T
    from chip_smoke import _bench_audio
    from swiftmp3_tpu.options import MP3EncoderOptions
    from swiftmp3_tpu_torch.ops import dsp
    from swiftmp3_tpu_torch.parallel.batch import BatchEncoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    opts = MP3EncoderOptions()
    rng = np.random.default_rng(0)
    audio = [_bench_audio(rng, B, T, 2, opts.sample_rate) for _ in range(4)]
    final = np.zeros((B, T), bool)
    valid = np.ones((B, T), bool)
    enc = BatchEncoder(opts, B, T, "cuda")
    try:
        for k in range(2):
            enc.drain(enc.step(audio[k], final, valid), valid)

        # 1. phase wall times (synchronised boundaries)
        marks = {}

        def timed(fn, before, after):
            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                if before:
                    marks[before] = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                if after:
                    marks[after] = time.perf_counter()
                return out
            return wrapper

        orig = (dsp.rate_loop_precompute, dsp.rate_loop_finalize)
        dsp.rate_loop_precompute = timed(orig[0], None, "phase1_end")
        dsp.rate_loop_finalize = timed(orig[1], "loop_end", None)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = enc.step(audio[2], final, valid)
            outs["ready"].synchronize()
            t1 = time.perf_counter()
        finally:
            dsp.rate_loop_precompute, dsp.rate_loop_finalize = orig
        enc.drain(outs, valid)
        p1 = marks["phase1_end"] - t0
        loop = marks["loop_end"] - marks["phase1_end"]
        p3 = t1 - marks["loop_end"]
        print(f"[phases] B={B} T={T} {card}: phase1+sweep {p1 * 1e3:.2f} ms, "
              f"loop over T {loop * 1e3:.2f} ms, phase3+pack+D2H {p3 * 1e3:.2f} ms, "
              f"step {(t1 - t0) * 1e3:.2f} ms (synchronised)", flush=True)

        # 2. profiler over one unsynchronised step
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            outs = enc.step(audio[3], final, valid)
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
    print(f"[profile] step wall {wall * 1e3:.2f} ms, {len(kernel_events)} device "
          f"events, device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of "
          f"the step), {card}", flush=True)
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=25))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

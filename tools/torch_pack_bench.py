#!/usr/bin/env python3
"""K2 (the main_data pack kernel) at every shape the port's paths give it,
on one GPU, optionally against another checkout's K2 in the same process.

    python3 tools/torch_pack_bench.py                      # this checkout's K2
    python3 tools/torch_pack_bench.py --against DIR        # and DIR's, in turns
    python3 tools/torch_pack_bench.py --ptxas              # also -Xptxas -v of pack.cu

For each shape (frames F, slots a frame P, main_data cap; the paths'
shapes of chip_smoke.py, PERF.md section 6) it packs
tests/torch_inputs.pack_input's seeded chunks and nbits (every frame filled
to just under the cap, live slots scattered at random), or with --real the
port's own chunk program's on that path (live slots clustered as the coder
leaves them; path_input). It holds each kernel bit-exact against the plain
version and reads it as chip_smoke.py does (_readings: CUDA events around 20
back-to-back wrapper calls, CUDA events around a CUDA graph of the same 20
launches, the wrapper's host time a call), against chip_smoke.py's bound
(_pack_bound: nbits and the chunks of live slots) and the time to move
every input byte.

With --against, the other checkout's `swiftmp3_tpu_torch/ops/kernels.py` is
loaded beside this one (its kernels built into its own `_build/`) and each
shape is read other, this, this, other. Prints the card's name and power
limit and one line a shape and reading; --json PATH also writes every
reading there.

Needs a CUDA card and nvcc; imports nothing of JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (name, F, P, cap): chip_smoke.py's K2 shapes; 256 streams x 128 frames
SHAPES = [
    ("compat", 32768, 1152, 894),
    ("serve", 2048, 1152, 894),
    ("strict", 32768, 1872, 894),
    ("hq", 32768, 4176, 894),
    ("hq96", 32768, 4176, 790),
    ("vbr demand", 32768, 2088, 1014),
    ("depth 3", 32768, 2088, 806),
    ("hq dc", 32768, 2088, 910),
    ("hq is", 32768, 4176, 582),
    ("lsf strict", 32768, 936, 444),
    ("lsf hq", 32768, 1044, 460),
    ("lsf iso", 32768, 576, 444),
    ("free format", 32768, 2088, 982),
]


def path_input(name: str, F: int, dev, streams: int = 16):
    """(chunks, nbits, cap) as the port's chunk program hands them to K2 on
    the path of shape `name` (chip_smoke.py's options and audio: bench audio,
    the serving pool's int16 noise, panned audio for intensity stereo; each
    frame's lookahead granule under window sequencing), for `streams`
    streams of 128 frames from a fresh carry, the frames repeated up to F
    (the serving shape: its own 64 lanes x 32 frames)."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from tests.torch_inputs import (
        DC_IS_OPTIONS, HQ_FLAG_OPTIONS, HQ_OPTIONS, LSF_PATHS, MAIN_OPTIONS, STRICT_OPTIONS,
        bench_audio, build_options, chunk_kernel_inputs, panned_audio, step_lookahead,
    )

    o_cls = MP3EncoderOptions
    options = {
        "compat": o_cls(**MAIN_OPTIONS),
        "serve": o_cls(**MAIN_OPTIONS),
        "strict": o_cls.spec_strict(**STRICT_OPTIONS),
        "hq": o_cls.hq(**HQ_OPTIONS["hq_joint"]),
        "hq96": o_cls.hq(**HQ_FLAG_OPTIONS["hq_joint_96k"]),
        "vbr demand": o_cls.hq(**HQ_FLAG_OPTIONS["hq_vbr_demand_q5"]),
        "depth 3": o_cls.hq(**HQ_FLAG_OPTIONS["hq_mono_96k_depth3"]),
        "hq dc": build_options(*DC_IS_OPTIONS["hq_dc_mono128"], o_cls),
        "hq is": build_options(*DC_IS_OPTIONS["hq_is_32k"], o_cls),
        **{k: build_options(*v, o_cls) for k, v in LSF_PATHS.items()},
    }[name]
    rng = np.random.default_rng(0)
    B, T = (64, 32) if name == "serve" else (streams, 128)
    spf, ch = options.samples_per_frame, options.channels
    if name == "serve":
        audio = (rng.standard_normal((B, T, spf * ch)) * 4000).astype(np.int16)
    elif name == "hq is":
        audio = panned_audio(rng, B, T)
    else:
        audio = bench_audio(rng, B, T, ch, options.sample_rate, spf=spf)
    la = step_lookahead([audio], 0, ch) if options.window_sequencing else None
    c, n, cap = chunk_kernel_inputs(options, dev, audio, la)["pack"]
    reps = -(-F // c.shape[0])
    return (c.repeat(reps, 1)[:F].contiguous(), n.repeat(reps, 1)[:F].contiguous(), cap)


def load_kernels(checkout: str):
    """The `ops/kernels.py` module of another checkout, under its own name,
    building into that checkout's `_build/`."""
    path = os.path.join(checkout, "swiftmp3_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("other_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report(kernels) -> str:
    """nvcc's -Xptxas -v lines for pack.cu (registers, shared memory, spills)."""
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(tmp, "pack.so"), os.path.join(kernels.CSRC_DIR, "pack.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return (res.stdout + res.stderr).strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout whose K2 is read in turns with this one")
    ap.add_argument("--ptxas", action="store_true", help="print -Xptxas -v for pack.cu")
    ap.add_argument("--shapes", help="comma-separated shape names (default: all)")
    ap.add_argument("--real", action="store_true",
                    help="the paths' own pack inputs (16 streams x 128 frames, repeated) in "
                         "place of the seeded ones")
    ap.add_argument("--json", help="a file to write every reading to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pack_bench: no CUDA device", file=sys.stderr)
        return 2

    from chip_smoke import _pack_bound, _readings
    from swiftmp3_tpu_torch.ops import kernels
    from tests.torch_inputs import pack_input

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    kernels.build_kernels()
    trees = {"this": kernels}
    if args.against:
        trees["other"] = load_kernels(args.against)
        trees["other"].build_kernels()
    if args.ptxas:
        print(ptxas_report(kernels), flush=True)
    packs = {name: mod.pack for name, mod in trees.items()}
    order = ["other", "this", "this", "other"] if args.against else ["this", "this"]
    wanted = set(args.shapes.split(",")) if args.shapes else None
    dev = torch.device("cuda")
    rows = []
    for name, F, P, cap in SHAPES:
        if wanted and name not in wanted:
            continue
        if args.real:
            c, n, cap_real = path_input(name, F, dev)
            if tuple(c.shape) != (F, P) or cap_real != cap:
                raise AssertionError(f"{name}: the path gave {tuple(c.shape)}, cap {cap_real}")
        else:
            ch, nb = pack_input(F, P, cap)
            c, n = torch.from_numpy(ch).to(dev), torch.from_numpy(nb).to(dev)
        pby, ptot = kernels.pack_plain(c, n, cap)
        for tree, pack in packs.items():
            by, tot = pack(c, n, cap)
            if not (torch.equal(by, pby) and torch.equal(tot, ptot)):
                raise AssertionError(f"{tree} K2 disagrees with the plain version at {name}")
        live = int((n > 0).sum())
        bound_ms, _, all_ms = _pack_bound(n, cap)
        for k, tree in enumerate(order):
            ms, dev_ms, hus = _readings((lambda pack: lambda: pack(c, n, cap))(packs[tree]))
            rows.append({"shape": name, "F": F, "P": P, "cap": cap, "tree": tree, "turn": k,
                         "inputs": "path" if args.real else "seeded",
                         "ms": ms, "device_ms": dev_ms, "host_us": hus, "bound_ms": bound_ms,
                         "every_input_byte_ms": all_ms, "live_slots": live})
            print(f"[K2 bench] {name} F={F} P={P} cap={cap} {tree}"
                  f"{' (path inputs)' if args.real else ''}: events {ms:.4f} ms "
                  f"({100 * bound_ms / ms:.1f}% of its bound, {100 * all_ms / ms:.1f}% of every "
                  f"input byte's time), graph {dev_ms:.4f} ms ({100 * bound_ms / dev_ms:.1f}%, "
                  f"{100 * all_ms / dev_ms:.1f}%), host {hus:.1f} us a call; bound "
                  f"{bound_ms:.4f} ms, every input byte {all_ms:.4f} ms ({live} live slots), "
                  f"{card}", flush=True)
        del c, n, pby, ptot
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

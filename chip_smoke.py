#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (swiftmp3_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (the kernels build from swiftmp3_tpu_torch/ops/csrc
at first use) and the repository checkout; imports nothing of JAX. Phases:

  1. card: name and power limit, kernel build time;
  2. K1 rate sweep: kernel vs plain version, bit-exact, both quantizer laws,
     on a 37-granule input, on granules at FMA knife edges and on the main
     path's 131 072 granules;
  3. K2 pack: kernel vs plain version, bit-exact, at the main path's shape and
     the reference tests' shapes, and against the host Huffman packer;
  4. the main path: BatchEncoder at 256 streams x 128 frames, 128 kbps CBR
     stereo 44.1 kHz, 3 steps of unique int16 audio rendered to bytes, with
     launch counts read around it; every stream's frame walk is checked;
  5. parity: the 8 compat fixture rows through new_session(..., "cuda")
     against the JAX backend's committed streams, and 2 main-path streams
     and the ULP-telemetry corpus against the golden numpy backend:
     structurally equal, byte flips pinned;
  6. a `kernels` JSON line, the card line, and the result line.

Exits nonzero, printing no result, when no CUDA device is present or any
phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# Frames whose bytes may differ from the reference streams: a float ULP in the
# card's matmul or reduction order can move a quantization knife edge (the
# repo's ULP-flip contract). Pinned from the card run recorded in PERF.md.
FIXTURE_FLIP_CEILING = 2  # over the 8 compat fixture rows (125 frames)
GOLDEN_FLIP_CEILING = 4  # over 2 main-path streams (256 frames)
# the JAX backend's compat ceiling on the tests/test_ulp_telemetry corpus
TELEMETRY_FLIP_CEILING = 2  # over 6 classes (72 frames)

B_MAIN, T_MAIN, STEPS_MAIN = 256, 128, 3


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over reps runs (CUDA events)."""
    import torch

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


def _bench_audio(rng, B: int, T: int, channels: int, sample_rate: int) -> np.ndarray:
    """Speech/music-like correlated audio, int16 interleaved [B, T, 1152*ch];
    unique content per call (the generator of bench.py)."""
    t_ax = np.arange(T * 1152) / sample_rate
    base = sum(
        a * np.sin(2 * np.pi * f * t_ax)
        for a, f in [(0.35, 220.0), (0.2, 467.0), (0.1, 1313.0)]
    )
    ar = rng.standard_normal((B, T * 1152)).astype(np.float32)
    for i in range(1, 8):
        ar[:, i:] += ar[:, :-i] / (i + 1)
    ar *= 0.05 / np.abs(ar).max()
    sig = (base[None, :] * rng.uniform(0.5, 1.0, (B, 1)) + ar).astype(np.float32)
    mono = (np.clip(sig, -0.99, 0.99) * 32767).astype(np.int16)
    return np.repeat(mono[..., None], channels, axis=-1).reshape(B, T, 1152 * channels)


def _frames(data: bytes) -> list[bytes]:
    """The frames of an MPEG-1 Layer III stream; raises on a bad sync word,
    a gap or trailing bytes."""
    from tests.util import parse_frames

    return [data[f.offset : f.offset + f.size] for f in parse_frames(data)]


def _compare_streams(got: bytes, ref: bytes, what: str) -> int:
    """Assert structural equality (frame count, every header and size);
    return the number of frames whose bytes differ."""
    fg, fr = _frames(got), _frames(ref)
    if [(f[:4], len(f)) for f in fg] != [(f[:4], len(f)) for f in fr]:
        raise AssertionError(f"{what}: frame structure differs ({len(fg)} vs {len(fr)} frames)")
    return sum(a != b for a, b in zip(fg, fr))


def _sweep_inputs(pcm_i16: np.ndarray, options, device):
    """The main path's rate-sweep inputs (mag, gstart) for one chunk, by the
    port's own phase-1 functions (stereo, fresh carry)."""
    import torch

    from swiftmp3_tpu_torch.models.pipeline import init_carry
    from swiftmp3_tpu_torch.ops import dsp

    B, T = pcm_i16.shape[:2]
    pcm = dsp.ingest(torch.from_numpy(pcm_i16).to(device)).reshape(B, -1)
    chunk = torch.stack([pcm[:, 0::2], pcm[:, 1::2]], dim=1)  # [B, 2, T*1152]
    carry = init_carry(B, options, device)
    S, _ = dsp.polyphase_chunk_matmul(carry["fb_hist"], chunk)
    block, _ = dsp.transient_frame(chunk.reshape(B, 2, T, 2, 576))
    spectra, _ = dsp.mdct_chunk(S, carry["overlap"], block.reshape(B, 2, 2 * T))
    spectra = spectra.reshape(B, 2, T, 2, 576)
    g0 = dsp.initial_gain(spectra)
    mag = torch.pow(torch.clamp(torch.abs(spectra), min=1e-10), 0.75).contiguous()
    return mag, torch.clamp(g0, 0, 255).to(torch.int32).contiguous()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from swiftmp3_tpu.encoder import EncoderSession
    from swiftmp3_tpu.io.huffman_pack import pack_frame_main_data
    from swiftmp3_tpu.options import MP3EncoderOptions, Mode
    from swiftmp3_tpu_torch.encoder import new_session
    from swiftmp3_tpu_torch.ops import dsp, kernels
    from swiftmp3_tpu_torch.parallel.batch import BatchEncoder
    from tests.fixture_lib import FIXTURES, fixture_path, make_signal
    from tests.test_ulp_telemetry import _corpus_stereo
    from tests.torch_inputs import knife_edge_sweep_input

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    kernels.build_kernels()
    print(f"[card] kernel build {time.perf_counter() - t0:.2f} s", flush=True)

    opts = MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128, sample_rate=44100)
    rng = np.random.default_rng(0)
    audio = [
        _bench_audio(rng, B_MAIN, T_MAIN, opts.channels, opts.sample_rate)
        for _ in range(STEPS_MAIN)
    ]
    report = {}

    # ---- 2. K1 rate sweep vs its plain version -------------------------------
    rs = np.random.default_rng(7)
    spec = (rs.standard_normal((37, 576)) * 10 ** rs.uniform(-5, 0.5, (37, 1))).astype(np.float32)
    spec[3] = 0.0  # silent granule
    mag_s = torch.from_numpy((np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32)).to(dev)
    g_s = torch.from_numpy(rs.integers(0, 256, 37).astype(np.int32)).to(dev)
    mag_m, g_m = _sweep_inputs(audio[0], opts, dev)
    n_main = g_m.numel()
    err = 0
    for iso in (False, True):
        # granules whose counts an FMA in the quantizer would flip
        mag_k, g_k = (
            torch.from_numpy(a).to(dev)
            for a in knife_edge_sweep_input(dsp.INV_STEP34 if iso else dsp.INV_STEP)
        )
        for mag, g in ((mag_s, g_s), (mag_k, g_k), (mag_m.reshape(-1, 576), g_m.reshape(-1))):
            bits, bv = kernels.rate_sweep(mag, g, iso=iso)
            torch.cuda.synchronize()
            for s in range(0, g.numel(), 8192):
                pb, pv = kernels.rate_sweep_plain(mag[s : s + 8192], g[s : s + 8192], iso)
                err = max(err, int((pb - bits[s : s + 8192]).abs().max()),
                          int((pv - bv[s : s + 8192]).abs().max()))
    if err:
        raise AssertionError(f"rate_sweep kernel disagrees with its plain version (max {err})")
    flat_m, flat_g = mag_m.reshape(-1, 576), g_m.reshape(-1)
    ms = _cuda_ms(lambda: kernels.rate_sweep(flat_m, flat_g), reps=20)

    def plain_sweep():
        for s in range(0, n_main, 8192):
            kernels.rate_sweep_plain(flat_m[s : s + 8192], flat_g[s : s + 8192])

    plain_ms = _cuda_ms(plain_sweep, reps=3, warmup=1)
    report["rate_sweep"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    print(f"[K1] rate_sweep bit-exact, both laws, N=37, FMA knife edges and N={n_main}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

    # ---- 3. K2 pack vs its plain version and the host packer ------------------
    rp = np.random.default_rng(7)
    err = 0
    for F, P, cap in [(32768, 1152, 894), (16, 1152, 894), (5, 576, 894), (8, 1812, 1536), (3, 1152, 2160)]:
        nb = rp.integers(0, 16, size=(F, P)).astype(np.int32)
        scale = (cap * 8 - 64) / max(nb.sum(axis=1).max(), 1)
        if scale < 1:  # keep every frame under the cap
            nb = np.where(rp.random((F, P)) < scale, nb, 0)
        ch = np.zeros((F, P), np.int32)
        nz = nb > 0
        ch[nz] = rp.integers(0, 1 << 15, size=nz.sum()) & ((1 << nb[nz]) - 1)
        c_d, n_d = torch.from_numpy(ch).to(dev), torch.from_numpy(nb).to(dev)
        by, tot = kernels.pack(c_d, n_d, cap)
        pby, ptot = kernels.pack_plain(c_d, n_d, cap)
        err = max(err, int((by.int() - pby.int()).abs().max()), int((tot - ptot).abs().max()))
        if F == 32768:
            ms = _cuda_ms(lambda: kernels.pack(c_d, n_d, cap), reps=20)
            plain_ms = _cuda_ms(lambda: kernels.pack_plain(c_d, n_d, cap), reps=5)
    q = rp.integers(-15, 16, size=(5, 4, 576)).astype(np.int32)
    bvh = rp.integers(0, 289, size=(5, 4)).astype(np.int32)
    chunks, nbits = dsp.pair_chunks_device(torch.from_numpy(q).to(dev), torch.from_numpy(bvh).to(dev))
    by, tot = kernels.pack(chunks.reshape(5, -1).contiguous(), nbits.reshape(5, -1).contiguous(), 2160)
    by, tot = by.cpu().numpy(), tot.cpu().numpy()
    for f in range(5):
        host_bytes, part_bits = pack_frame_main_data(q[f], bvh[f])
        if tot[f] != part_bits.sum() or by[f, : len(host_bytes)].tobytes() != host_bytes:
            raise AssertionError(f"pack kernel disagrees with the host packer on frame {f}")
    if err:
        raise AssertionError(f"pack kernel disagrees with its plain version (max {err})")
    report["pack"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    print(f"[K2] pack bit-exact at 5 shapes and vs the host packer: "
          f"F=32768 P=1152 cap=894 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

    # ---- 4. the main path -----------------------------------------------------
    enc = BatchEncoder(opts, B_MAIN, T_MAIN, dev)
    final = np.zeros((B_MAIN, T_MAIN), dtype=bool)
    valid = np.ones((B_MAIN, T_MAIN), dtype=bool)
    streams = [bytearray() for _ in range(B_MAIN)]
    step_ms, wall_s = [], []
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for k in range(STEPS_MAIN):
            w0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = enc.step(audio[k], final, valid)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            for b, chunk in enumerate(enc.drain(outs, valid)):
                streams[b] += chunk
            wall_s.append(time.perf_counter() - w0)
        for b, tail in enumerate(enc.flush()):
            streams[b] += tail
        launches = dict(kernels.LAUNCHES)
    finally:
        enc.close()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched kernel {name}")
    n_frames = STEPS_MAIN * T_MAIN
    for b, data in enumerate(streams):
        frames = _frames(bytes(data))
        if len(frames) != n_frames or {len(f) for f in frames} - {417, 418}:
            raise AssertionError(f"stream {b}: bad frame walk ({len(frames)} frames)")
    audio_s = B_MAIN * T_MAIN * 1152 / opts.sample_rate
    steady = statistics.median(step_ms[1:])
    print(f"[main] BatchEncoder B={B_MAIN} T={T_MAIN} x {STEPS_MAIN} steps, {card}: "
          f"step device ms {['%.2f' % t for t in step_ms]} (steady {steady:.2f} ms, "
          f"{audio_s / (steady / 1e3):.1f} audio-s/s); step+render wall s "
          f"{['%.3f' % t for t in wall_s]}; {B_MAIN} streams x {n_frames} frames walk OK; "
          f"launches {launches}", flush=True)

    # ---- 5. parity ---------------------------------------------------------
    fixture_flips, fixture_frames = 0, 0
    for name, kw, sig_kind, seconds, seed in FIXTURES:
        o = MP3EncoderOptions(**kw)
        if o.spec_strict_entropy:
            continue  # the 8 compat rows
        pcm = make_signal(sig_kind, seconds, o.sample_rate, o.channels, seed)
        s = new_session(o, "cuda")
        got = s.encode(pcm) + s.flush()
        with open(fixture_path(name, "tpu"), "rb") as fh:
            ref = fh.read()
        flips = _compare_streams(got, ref, name)
        fixture_flips += flips
        fixture_frames += len(_frames(ref))
        print(f"[parity] {name}: structure equal, {flips} frames differ", flush=True)
    def vs_golden(pcms, what):
        flips = frames = 0
        for i, pcm in enumerate(pcms):
            s = new_session(opts, "cuda")
            got = s.encode(pcm) + s.flush()
            g = EncoderSession(opts, backend="numpy")
            ref = g.encode(pcm) + g.flush()
            flips += _compare_streams(got, ref, f"{what} {i} vs golden")
            frames += len(_frames(ref))
        return flips, frames

    golden_flips, golden_frames = vs_golden(
        [audio[0][b].reshape(-1) for b in range(2)], "main-path stream"
    )
    corpus_flips, corpus_frames = vs_golden(list(_corpus_stereo().values()), "corpus class")
    print(f"[parity] fixtures {fixture_flips}/{fixture_frames} frames differ "
          f"(ceiling {FIXTURE_FLIP_CEILING}); golden {golden_flips}/{golden_frames} "
          f"(ceiling {GOLDEN_FLIP_CEILING}); telemetry corpus vs golden "
          f"{corpus_flips}/{corpus_frames} (ceiling {TELEMETRY_FLIP_CEILING})", flush=True)
    if (
        fixture_flips > FIXTURE_FLIP_CEILING
        or golden_flips > GOLDEN_FLIP_CEILING
        or corpus_flips > TELEMETRY_FLIP_CEILING
    ):
        raise AssertionError("byte flips above the pinned ceiling")

    # ---- 6. result lines ----------------------------------------------------
    rows = [
        ("rate_sweep", "swiftmp3_tpu_torch/ops/csrc/rate_sweep.cu",
         "swiftmp3_tpu/ops/pallas_kernels.py:347"),
        ("pack", "swiftmp3_tpu_torch/ops/csrc/pack.cu",
         "swiftmp3_tpu/ops/pallas_kernels.py:237"),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[n], **report[n]}
        for n, src, rep in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

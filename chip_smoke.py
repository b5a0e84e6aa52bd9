#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (swiftmp3_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (the kernels build from swiftmp3_tpu_torch/ops/csrc
at first use), `g++` (the native frame renderer) and the repository
checkout; imports nothing of JAX and nothing of the JAX package (its
reference streams are committed files; the golden encoder and the decoder
it runs are the port's copies). Phases:

  1. card: name and power limit, kernel build time;
  2. K1 rate sweep: kernel vs plain version, bit-exact, both quantizer laws,
     on a 37-granule input, on granules at FMA knife edges and on the main
     path's 131 072 granules; its time there as a share of its bound;
  3. K2 pack: kernel vs plain version, bit-exact, at the main path's shape and
     the reference tests' shapes, and against the port's host Huffman packer;
  3b. K3 polyphase filterbank: kernel vs plain version and vs the folded
     matmul within 2e-5 (x identical) at the main path's shape (512 rows,
     T = 128), at session shapes (T = 8, T = 3) and on an LSF chunk of an
     odd number of frames (512 rows x 127 frames of 576 samples, 2286
     windows: the folded matmul pads them to its 4-a-row packing); then
     the path that runs K3, the filterbank stage of
     tools/torch_profile_step.py, with launch counts read around it, and
     K3's time as a share of its bound, read three ways as K1 and K2 are;
  4. the main path: BatchEncoder at 256 streams x 128 frames, 128 kbps CBR
     stereo 44.1 kHz, 2 steps of unique int16 audio rendered to bytes, with
     launch counts read around it (K4's selection scan once a step, its
     placement scan never); every stream's frame walk is checked; then
     ([K4 compat]) K4 against its plain version, bit-exact, on the scan
     inputs the main path gave it (256 streams x 128 frames, 4 granules),
     with its time as K1's is read, its plain version's and its byte bound;
  4b. the strict path: BatchEncoder at MP3EncoderOptions.spec_strict(joint
     stereo, 128 kbps, 44.1 kHz), 256 streams x 128 frames, 2 steps of the
     same audio, launch counts read around it, every frame walk checked;
     then K2 against its plain version, bit-exact, on the pack input the
     strict path gave it (P = 1872 slots a frame) and on the same slots
     three times over (frames past the cap), with its time and bound;
  4c. the hq paths: BatchEncoder at MP3EncoderOptions.hq(joint stereo, 128
     kbps, 44.1 kHz), 256 streams x 128 frames, 2 steps of the same audio
     with each frame's lookahead granule (built as bench.py builds it), and
     one step of hq(stereo, ...), bench.py's hq cell; launch counts read
     around each, every frame walk checked; then K2 against its plain
     version, bit-exact, on the pack input the hq path gave it (P = 4176
     slots a frame) and on the same slots three times over (every frame past
     the cap), with its time, bound and share; K4's two scans once a step on
     each strict and hq path, and ([K4 hq]) both against their plain
     versions, bit-exact, on the hq joint path's first scan inputs, with
     their times and bounds; K5 (the strict sweep) once a step on each
     strict and hq path and never on the compat paths, and ([K5 hq]) K5
     against its plain version, bit-exact, on the hq joint path's first
     strict-sweep input (131 072 granules), with its time and bound;
  4d. serving ([serve]): a StreamPool at bench.py's serving configuration
     (128 kbps CBR stereo 44.1 kHz, 64 lanes x 32 frames a step), unique
     int16 noise feeds (bench.py's: seed 7, normal x 4000), one warm step
     and SERVE_STEPS timed steps (median, min, max), launch counts read
     around them, every stream's frame walk checked after closing; then the
     step's attribution as bench.py makes it: chained compute over resident
     inputs (CUDA events), the pinned int16 upload, one drain of a ready
     chunk; then K1 and K2 against their plain versions, bit-exact, on the
     inputs the pool gave them (8192 granules; P = 1152 slots a frame, and
     those slots three times over), with their times and bounds, and
     ([K4 serve]) K4 on the pool's first scan inputs (64 x 32 frames);
  4e. lane churn ([serve churn]): a pipelined pool at the serving shape that
     recycles lanes (1.5 x lanes streams, mixed lengths and dtypes, some
     drip-fed, some closed empty), a sample of streams (the recycled lanes'
     among them) byte-equal to sessions on the card; then a smaller
     hq(stereo, 128 kbps) pool, window sequencing's preroll and holdback,
     pipelined and synchronous, every stream byte-equal to its session and
     the two modes' streams equal;
  4f. files ([corpus], [cli]): encode_corpus on the card equal to ID3 + Xing
     + session bytes, and the command line's file for the frozen WAV input,
     each against the JAX package's frozen file (structure, flips pinned);
  4g. hq at 96 kbps ([hq96]): BatchEncoder at MP3EncoderOptions.hq(joint
     stereo, 96 kbps, 44.1 kHz), the preset's own adaptive lowpass, 256
     streams x 128 frames, 2 steps, then K2 bit-exact on that path's pack
     input; demand VBR and reservoir depth 3 ([hq flags]), one step each at
     the same width (mono), K2 bit-exact on each one's pack input, past the
     cap too;
  4h. distortion control ([hq dc]): BatchEncoder at
     MP3EncoderOptions.hq(mono, 128 kbps, 44.1 kHz, distortion_control=True),
     256 streams x 128 frames of the bench audio's left channel, 2 steps,
     the same 2 steps with the flag off (the bytes must differ), and one
     step at dc_passes=3, dc_proportional=True; then K2 bit-exact on the dc
     path's pack input (P = 2088 slots a frame, cap 910);
  4i. intensity stereo ([hq is]): BatchEncoder at MP3EncoderOptions.hq(joint
     stereo, 32 kbps, 44.1 kHz, intensity_stereo=True), the preset's
     adaptive lowpass, 256 streams x 128 frames of panned two-tone audio, 2
     steps, counting the frames that emit intensity (mode_extension 0b01;
     there must be some); then K2 bit-exact on the IS path's pack input
     (P = 4176, cap 582);
  4j. LSF sample rates and free format ([lsf strict], [lsf hq], [lsf iso],
     [free format]; tests/torch_inputs.LSF_PATHS): BatchEncoder at
     spec_strict(joint stereo, 64 kbps, 22.05 kHz), hq(mono, 48 kbps, 16
     kHz) with each frame's lookahead granule, and the non-strict program at
     22.05 kHz under the ISO law, each 256 streams x 128 frames of 576
     samples, 2 steps, and free format (spec_strict mono 150 kbps with
     linbits at 44.1 kHz) one step at the same width; every frame walk
     checked (MPEG-2 headers and 576 samples a frame; free format: bitrate
     index 0, 489 or 490 bytes); then K1 bit-exact on the lsf iso path's
     sweep input (65 536 granules, ISO law), ([K5 lsf strict]) K5
     bit-exact on the lsf strict path's strict-sweep input (65 536
     granules) with its time and bound, and K2 bit-exact on each path's
     pack input (P = 936, 1044, 576, 2088) and past the cap;
  4k. the mesh ([mesh]): encode_batch of the main path's 256 streams x 256
     frames (the two steps of bench audio joined, 128 frames a step) over
     make_mesh() (every card), over a 4-position mesh on cuda:0 (64 streams
     a position) and with device="cuda" and no mesh, launch counts read
     around each (K1 and K2 once a step a position); every frame walk
     checked; the every-card mesh byte-equal to the one-card run where it
     is one position (else, like the 4-position mesh, structurally equal
     with its flips pinned); then K1 and K2 bit-exact against their plain
     versions on one position's own first inputs, and, with two cards or
     more, on the last card while the first is current;
  4l. two processes ([multihost]): chip_smoke.py --multihost-worker twice,
     joined by initialize_multihost over gloo on localhost, both on cuda:0,
     each passing 128 of the 256 streams to encode_batch_multihost (two
     calls, the second timed warm); their bytes, concatenated, equal one
     process's encode_batch of the 256 over the same layout (a 2-position
     mesh on cuda:0) and are structurally equal to the one-card run, flips
     pinned; each process's wall times and launch counts, and the one
     process's wall time;
  4m. the graft entry ([entry]; swiftmp3_tpu_torch/graft_entry.py, the
     twin of __graft_entry__.py): entry()'s chunk program called twice on
     the card (cold, warm), K1 and K2 bit-exact against their plain
     versions on its first inputs, its outputs against entry("cpu") and
     the JAX entry's frozen outputs (tests/fixtures/torch/jax_entry.npz);
     dryrun_multichip(4) and dryrun_multichip(every card) at the
     reference's shapes against the frozen JAX dry runs; then the bulk
     shape, dryrun_multichip(4, batch=256, frames=128) (64 streams a
     position on cuda:0: compat joint-stereo VBR at quality 3, then the hq
     preset) against dryrun_multichip(1, ...) of the same rows, the dry
     run's own checks holding at that size, with K1 and K2 bit-exact on a
     position's first inputs ([K1 entry] N = 32 768, [K2 entry] F = 8192 at
     the VBR cap 1104) with their times and bounds; every call's launches
     checked (K1 once a position, K2 twice) and its wall s printed; frames
     that differ anywhere are pinned by ENTRY_FLIP_CEILING and
     ENTRY_BULK_FLIP_CEILING;
  4n. decode and score ([decode], run after 4j): the first DECODE_ROWS (4)
     of the bulk streams of [main], [strict], [hq_joint], [lsf hq] and [hq
     is] (256 frames each), and the port's golden encoder
     (new_session(o, backend="numpy")) run on the host over the same rows,
     fed as BatchEncoder was (each step's frames, each frame's lookahead
     granule under window sequencing): structure equal, flips pinned by
     DECODE_FLIP_CEILING; both decoded by the port's decode_mp3 (every frame
     parses, CRCs verify where the options protect them, equal sample
     counts), each channel scored against its input (measure_quality's
     gain-compensated SNR, masked_noise_ratio), the card's and the golden's
     scores side by side and their largest difference pinned by
     DECODE_SCORE_CEILING_DB; the card's streams through libmpg123 where
     the host has it (agreement with the oracle at least
     MPG123_AGREEMENT_FLOOR_DB on conforming streams), else a line saying it
     is absent; the rows run in worker processes (spawned, one BLAS thread
     each), and the phase's wall time is printed. It launches no kernel.
  5. parity: the 8 compat fixture rows through new_session(o) against the
     JAX backend's committed streams (tests/fixtures/*.tpu.mp3), and 2
     main-path streams and the ULP-telemetry corpus against the golden numpy
     backend's frozen streams (tests/fixtures/torch/): structurally equal,
     byte flips pinned; the same for the 4 strict fixture rows and the
     golden strict streams; for each hq configuration, the hq fixture rows
     and the corpus against the JAX backend's frozen bytes and the corpus
     against the golden encoder's frozen hq streams; the hq flag
     configurations' rows against the JAX backend's frozen bytes and demand
     VBR's corpus against the golden encoder's ([parity hq flags]); the same
     for the distortion-control and intensity rows ([parity dc is]), each
     configuration's rows as one batch: the card's own bytes within a
     ceiling per configuration, exact with the CPU filterbank and MDCT, the
     telemetry corpus against the golden encoder's within the telemetry
     suite's ceilings (42/78, 19/78); the LSF and free-format rows ([parity
     lsf]), each as a card batch of 7-frame steps against the JAX package's
     frozen batch at 7 frames a step and as a card session against the JAX
     backend's frozen session, within a ceiling per row, and exact with the
     CPU filterbank and MDCT;
  6. a `kernels` JSON line (K1 and K2 as the compat main path, the serving
     pool, the LSF and free-format paths, the mesh runs, the two processes
     and the graft entry launched them, K3 as the filterbank stage did, K4
     as the main, strict, hq, serving, LSF and mesh paths did, K5 as the
     strict, hq, dc, IS, LSF and mesh paths did, read at the hq path's
     input), the card line, and the result line. Each phase's wall time is printed
     ([time]).

Each kernel's bound_ms is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its lane operations over 33.5 T/s (the
67 TFLOP/s of fp32 outside the tensor cores, an FMA counting as one lane
operation), the H100 SXM's published peaks, from this run's shapes. K1 and
K2 are read three ways at each shape they are checked at: `ms`, CUDA events
around 20 back-to-back wrapper calls; `device_ms`, CUDA events around a CUDA
graph of the same 20 launches (the kernel alone, without the wrapper's host
work); `host_us`, the wrapper's host time a call. Each line gives the share
of the bound both ways. K2's bound counts the chunks of live slots only (a
dead slot's chunk is not needed, and the kernel does not read it); its lines
also print the time to move every input byte, the measure the earlier K2
kernel was read against, which the kernel beats where most slots are dead
and so is not a bound.

Exits nonzero, printing no result, when no CUDA device is present or any
phase fails (a [multihost] worker that fails or runs past
MULTIHOST_TIMEOUT_S included).
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
# The same on the strict path: the 4 strict fixture rows (66 frames), the 2
# main-path streams (256 frames) against the golden strict streams, and the
# JAX backend's strict ceiling on the telemetry corpus.
STRICT_FIXTURE_FLIP_CEILING = 2
STRICT_GOLDEN_FLIP_CEILING = 4
STRICT_TELEMETRY_FLIP_CEILING = 16
# The hq paths, against the golden encoder's frozen streams of the telemetry
# corpus (78 frames): the JAX backend's hq ceiling (it measured 16/78), and
# for stereo the JAX backend's own rate on the frozen files (25/78) under the
# telemetry suite's rule, max(2x, +2). Against the JAX backend's frozen bytes
# (the port on the CPU: 0 of 64 fixture-row frames, 7 of 78 corpus frames in
# joint stereo, on two float knife edges), the rate 24/78 over the hq
# fixture rows (64 frames) and the corpus.
HQ_GOLDEN_FLIP_CEILING = {"hq_joint": 24, "hq_stereo": 50}
HQ_JAX_FLIP_RATE = (24, 78)
# demand VBR's corpus against the golden encoder's (78 frames): the JAX
# backend's ceiling in tests/test_ulp_telemetry.py (it measured 12/78)
VBR_DEMAND_GOLDEN_FLIP_CEILING = 20
# The hq flag rows against the JAX backend's frozen bytes, with the port's
# CPU filterbank and MDCT in place of the card's (the card's sum in another
# order, which moves linbits knife edges in whole mono streams): the frames
# the port's CPU session differs in too (tests/test_torch_hq_flags.py
# KNIFE_EDGE_ROWS), and no other.
HQ_FLAG_CPU_FILTERBANK_FLIPS = {"hq_joint_96k_corpus_burst": 1, "hq_mono_96k_depth3_sparse": 1}
# The same rows on the card's own filterbank and MDCT against the JAX
# backend's frozen bytes, per configuration: the frames the card differed in
# (H100 80GB HBM3, 700 W: 31/78, 0/78, 20/78, 18/78, 10/17) under the
# telemetry suite's rule max(2x, +2); depth 3's 17 frames take +2 alone, as 2x
# would pass every frame.
HQ_FLAG_JAX_FLIP_CEILING = {
    "hq_mono_96k": 62,
    "hq_joint_96k": 2,
    "hq_mono_lowpass10k": 40,
    "hq_vbr_demand_q5": 36,
    "hq_mono_96k_depth3": 12,
}
# The distortion-control and intensity rows (tests/torch_inputs.DC_IS_OPTIONS),
# each configuration's rows as one card batch on its own filterbank and MDCT,
# against the JAX backend's frozen bytes: the frames that batch differed in
# (H100 80GB HBM3, 700 W: 0/78, 0/26, 0/78, 0/24) under the telemetry suite's
# rule max(2x, +2). (One card session a stream differed in 32/78 and 10/26 of
# the mono rows: cuBLAS sums a one-stream filterbank in another order.) With
# the CPU filterbank and MDCT they must be exact (the CPU session is, on
# every row).
DC_IS_JAX_FLIP_CEILING = {
    "hq_dc_mono128": 2,
    "hq_dc3p_mono128": 2,
    "hq_is_32k": 2,
    "strict_is_32k": 2,
}
# the telemetry corpus against the golden encoder's (78 frames): the JAX
# backend's ceilings in tests/test_ulp_telemetry.py (it measured 34/78, 11/78)
DC_IS_GOLDEN_FLIP_CEILING = {"hq_dc_mono128": 42, "hq_is_32k": 19}
# The LSF and free-format rows (tests/torch_inputs.LSF_ROWS, FF_ROWS) on the
# card's own filterbank and MDCT against the JAX package's frozen bytes: the
# frames a card batch or a card session of a row differed in (H100 80GB
# HBM3, 700 W: 0 in every row both ways) under the telemetry suite's rule
# max(2x, +2). With the CPU filterbank and MDCT they must be exact (the CPU
# session and batch are on every row).
LSF_JAX_FLIP_CEILING = {
    "lsf_strict_joint64_22k_burst": 2,
    "lsf_hq_mono48_16k_content": 2,
    "lsf_hq_joint80_24k_content": 2,
    "lsf_strict_mono48_8k_mixed": 2,
    "lsf_strict_noshort_joint48_22k_mixed": 2,
    "lsf_strict_vbr_q3_22k_content": 2,
    "lsf_iso_stereo64_22k_burst": 2,
    "ff_strict_mono150_44k_noise": 2,
}

# [mesh] and [multihost]: the 4-position mesh's and the two processes' frames
# that differ from the one-card encode_batch of the same streams (a smaller
# batch a position may take another cuBLAS algorithm), under the telemetry
# suite's rule max(2x, +2) from the card's count (H100 80GB HBM3, 700 W: 0
# of 65 536 both ways).
MESH_FLIP_CEILING = 2
MESH_POSITIONS = 4  # [mesh] and [entry]: positions on cuda:0, 64 streams each
# [entry]: the frames (stream, time) in which any fetched field or main_data
# byte of a card run differs, under the telemetry suite's rule max(2x, +2)
# from the card's count: the entry step against entry("cpu") and against the
# JAX entry, and each small dry run's steps against the JAX dry run's (H100
# 80GB HBM3, 700 W: 0 of 32 frames both ways, 0 of 4 and 0 of 16 a step);
# the bulk 4-position dry run against the 1-position one, both steps (0 of
# 65 536).
ENTRY_FLIP_CEILING = 2
ENTRY_BULK_FLIP_CEILING = 2
MULTIHOST_TIMEOUT_S = 300  # [multihost]: each worker, start-up included
# [decode]: the first DECODE_ROWS streams of five bulk paths against the
# golden encoder run on the host over the same rows. The frames whose bytes
# differ, under the telemetry suite's rule max(2x, +2) of the card's count,
# and the largest difference between the card's and the golden's decoded
# score of a channel (gain-compensated SNR and masked NMR, dB), under
# max(2x, +0.2 dB) of the card's. Pinned from the card run recorded in
# PERF.md (H100 80GB HBM3, 700 W: 0, 2, 4, 1 and 4 of 1024 frames; every
# score difference under 0.0005 dB).
DECODE_ROWS = 4
DECODE_FLIP_CEILING = {"main": 2, "strict": 4, "hq_joint": 8, "lsf hq": 3, "hq is": 8}
DECODE_SCORE_CEILING_DB = 0.2
# the oracle against libmpg123 on a conforming stream (iso_ms_matrix), where
# the card host has the library; compat streams decode with the reference's
# data placement, which the two decoders read differently
MPG123_AGREEMENT_FLOOR_DB = 60.0

STEPS_MAIN = 2
STEPS_STRICT = 2
STEPS_HQ = 2  # joint stereo; stereo takes one
STEPS_HQ96 = 2
STEPS_DC = 2  # and one step at dc_passes=3, dc_proportional=True
STEPS_IS = 2
STEPS_LSF = 2  # each LSF path; free format takes one
# bench.py's serving cell (bench.py:207-226)
SERVE_LANES, SERVE_FRAMES, SERVE_STEPS = 64, 32, 10
K3_TOLERANCE = 2e-5  # tests/test_pallas.py, the JAX package's own for K3

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
LANE_OPS_PER_S = 67e12 / 2  # fp32 outside the tensor cores, FMA = 1 lane op


def _bound(nbytes: float, lane_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the memory and operation times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lane_ops / LANE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _readings(fn) -> tuple[float, float, float]:
    """A kernel wrapper's three readings: ms by CUDA events around 20
    back-to-back calls, device-only ms by CUDA events around a CUDA graph of
    the same 20 launches, and the host's microseconds a call."""
    from tools.torch_profile_step import cuda_ms, graph_ms, host_us

    return cuda_ms(fn, reps=20), graph_ms(fn, reps=20), host_us(fn, reps=20)


def _shares(ms: float, device_ms: float, host: float, bound_ms: float,
            all_ms: float = None) -> str:
    """The readings and their shares of the bound (and, for K2, of the time
    to move every input byte)."""
    text = (f"kernel {ms:.4f} ms by events ({100 * bound_ms / ms:.1f}% of its bound), "
            f"{device_ms:.4f} ms device-only ({100 * bound_ms / device_ms:.1f}% of its bound), "
            f"host {host:.1f} us a call")
    if all_ms is not None:
        text += (f"; every input byte (not a bound) {all_ms:.4f} ms: {100 * all_ms / ms:.1f}% "
                 f"by events, {100 * all_ms / device_ms:.1f}% device-only")
    return text


def _frames(data: bytes, free_kbps: int = None) -> list[bytes]:
    """The frames of a Layer III stream (MPEG-1, 2 or 2.5; free-format
    frames sized by free_kbps); raises on a bad sync word, a gap or trailing
    bytes."""
    from tests.torch_inputs import walk_frames

    return [data[f["offset"] : f["offset"] + f["size"]] for f in walk_frames(data, free_kbps)]


def _split_id3(data: bytes) -> tuple[bytes, bytes]:
    """(the ID3v2 tag, the frames after it) of a complete file."""
    if data[:3] != b"ID3":
        return b"", data
    size = (data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14 | (data[8] & 0x7F) << 7 | data[9] & 0x7F
    return data[: 10 + size], data[10 + size :]


def _compare_files(got: bytes, ref: bytes, what: str) -> int:
    """Equal ID3 tags, then _compare_streams on the frames (Xing first)."""
    (tag_g, body_g), (tag_r, body_r) = _split_id3(got), _split_id3(ref)
    if tag_g != tag_r:
        raise AssertionError(f"{what}: ID3 tags differ")
    return _compare_streams(body_g, body_r, what)


class _CpuFilterbank:
    """Within it, the chunk program runs its filterbank and MDCT on the CPU
    (the port's plain versions, the CPU session's float order) and every
    other op on the card."""

    def __enter__(self):
        from swiftmp3_tpu_torch.ops import dsp

        self.dsp, self.saved = dsp, (dsp.polyphase_chunk_matmul, dsp.mdct_chunk)
        pm, md = self.saved

        def pm_cpu(hist, pcm):
            return tuple(x.to(hist.device) for x in pm(hist.cpu(), pcm.cpu()))

        def md_cpu(S, overlap, block, *args, **kwargs):
            return tuple(x.to(S.device) for x in md(S.cpu(), overlap.cpu(), block.cpu(), *args, **kwargs))

        dsp.polyphase_chunk_matmul, dsp.mdct_chunk = pm_cpu, md_cpu
        return self

    def __exit__(self, *exc):
        self.dsp.polyphase_chunk_matmul, self.dsp.mdct_chunk = self.saved


class _FirstInputs:
    """Within it, the wrappers kernels.rate_sweep, kernels.pack,
    kernels.rate_loop_scan, kernels.placement_scan and kernels.strict_sweep
    keep a copy of their first call's inputs, `sweep` (mag, gstart, iso),
    `pack` (chunks, nbits, cap), `scan` (config, carry, keyword inputs),
    `placement` (config, carry, hb, slot, final, valid) and `strict`
    (arguments, keyword options), and launch and count as before."""

    def __enter__(self):
        from swiftmp3_tpu_torch.ops import kernels

        self.kernels = kernels
        self.saved = (kernels.rate_sweep, kernels.pack, kernels.rate_loop_scan,
                      kernels.placement_scan, kernels.strict_sweep)
        self.sweep = self.pack = self.scan = self.placement = self.strict = None
        sweep, pack, scan, placement, strict = self.saved

        def clone(x):
            if isinstance(x, dict):
                return {k: clone(v) for k, v in x.items()}
            return x.clone() if hasattr(x, "clone") else x

        def rec_sweep(mag, gstart, iso=False):
            if self.sweep is None:
                self.sweep = (mag.clone(), gstart.clone(), iso)
            return sweep(mag, gstart, iso=iso)

        def rec_pack(chunks, nbits, cap):
            if self.pack is None:
                self.pack = (chunks.clone(), nbits.clone(), cap)
            return pack(chunks, nbits, cap)

        def rec_scan(cfg, carry, *args, **kwargs):
            if self.scan is None:
                names = ("bits", "evaluated", "k_budget", "granule_e", "final", "valid")
                self.scan = (cfg, clone(carry), clone({**dict(zip(names, args)), **kwargs}))
            return scan(cfg, carry, *args, **kwargs)

        def rec_placement(cfg, carry, *args):
            if self.placement is None:
                self.placement = (cfg, clone(carry), *clone(list(args)))
            return placement(cfg, carry, *args)

        def rec_strict(*args, **kwargs):
            if self.strict is None:
                self.strict = ([clone(a) for a in args], dict(kwargs))
            return strict(*args, **kwargs)

        kernels.rate_sweep, kernels.pack = rec_sweep, rec_pack
        kernels.rate_loop_scan, kernels.placement_scan = rec_scan, rec_placement
        kernels.strict_sweep = rec_strict
        return self

    def __exit__(self, *exc):
        (self.kernels.rate_sweep, self.kernels.pack, self.kernels.rate_loop_scan,
         self.kernels.placement_scan, self.kernels.strict_sweep) = self.saved


def _sweep_bound(n: int) -> tuple[float, str]:
    """K1's bound over n granules: read mag and gstart, write bits and bv;
    per granule and gain 576 x (multiply, add, floor, min, convert) + 288 x
    (index, lookup, add, max)."""
    return _bound(4 * (576 * n + n + 2 * 20 * n), n * 20 * (576 * 5 + 288 * 4))


def _strict_sweep_bound(n: int) -> tuple[float, str]:
    """K5's bound over n granules: read mag, gstart, is_long, b0_switch and
    part2, write the [n, 20] bits; per granule and gain 576 x (multiply,
    add, min, floor, the q > 0 and q > 1 line maxima) + 288 x (the bv test,
    pair maximum, region maximum, table index, lookup, masked add) + 144 x
    (pattern, popcount, lookup, two masked adds) lane operations."""
    return _bound(4 * (576 * n + 3 * n + 20 * n) + n, n * 20 * (576 * 6 + 288 * 6 + 144 * 5))


def _pack_bound(nbits, cap: int) -> tuple[float, str, float]:
    """K2's bound on these inputs: read nbits and the chunks of the live
    slots (nbits > 0; a dead slot's chunk is not needed), write the images
    and totals; per slot: scan add, offset, shift, up to three ORs. Also the
    time to move every input byte, the measure the earlier K2 kernel was read
    against: (bound_ms, bound_by, all_inputs_ms)."""
    F, P = nbits.shape
    live = int((nbits > 0).sum())
    bound_ms, bound_by = _bound(4 * F * P + 4 * live + F * cap + 4 * F, 6 * F * P)
    return bound_ms, bound_by, _bound(4 * 2 * F * P + F * cap + 4 * F, 6 * F * P)[0]


def _sweep_on(sweep_input, dev) -> int:
    """K1 on `dev` against its plain version there: the max difference."""
    from swiftmp3_tpu_torch.ops import kernels

    mag, g, iso = sweep_input
    mag, g = mag.to(dev).reshape(-1, 576).contiguous(), g.to(dev).reshape(-1).contiguous()
    bits, bv = kernels.rate_sweep(mag, g, iso=iso)
    err = 0
    for s in range(0, g.numel(), 8192):
        pb, pv = kernels.rate_sweep_plain(mag[s : s + 8192], g[s : s + 8192], iso)
        err = max(err, int((pb - bits[s : s + 8192]).abs().max()),
                  int((pv - bv[s : s + 8192]).abs().max()))
    return err


def _check_sweep(sweep_input, what: str, card: str) -> None:
    """K1 against its plain version, bit-exact, on a path's own sweep input;
    its time, bound and share."""
    import torch

    from swiftmp3_tpu_torch.ops import kernels
    from tools.torch_profile_step import cuda_ms

    mag, g, iso = sweep_input
    mag, g = mag.reshape(-1, 576).contiguous(), g.reshape(-1).contiguous()
    n = g.numel()
    err = _sweep_on(sweep_input, mag.device)
    if err:
        raise AssertionError(f"rate_sweep kernel disagrees with its plain version on the {what} "
                             f"input (max {err})")
    ms, device_ms, host = _readings(lambda: kernels.rate_sweep(mag, g, iso=iso))
    plain_ms = cuda_ms(lambda: kernels.rate_sweep_plain(mag, g, iso), reps=3, warmup=1)
    bound_ms, bound_by = _sweep_bound(n)
    print(f"[K1 {what}] rate_sweep bit-exact on the {what} path's input N={n} "
          f"({'iso' if iso else 'compat'} law), {card}: "
          f"{_shares(ms, device_ms, host, bound_ms)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)


def _k5_launches(options, steps: int) -> int:
    """K5's launches in `steps` chunk steps under `options`: one a strict
    sweep, 1 + dc_passes a step under distortion control, none off the
    strict entropy layout."""
    if not options.spec_strict_entropy:
        return 0
    return steps * (1 + options.dc_passes * options.distortion_control_active)


def _expect_k5(launches: dict, options, steps: int, what: str) -> int:
    """K5's launches in a run read around it, held to _k5_launches."""
    want = _k5_launches(options, steps)
    if launches["strict_sweep"] != want:
        raise AssertionError(f"the {what} path launched strict_sweep {launches['strict_sweep']} "
                             f"times in {steps} steps, want {want}")
    return want


def _check_strict_sweep(strict_input, what: str, card: str) -> dict:
    """K5 against its plain version, bit for bit, on a path's own first
    strict-sweep input at full width; its time as events, device-only and
    host readings, its plain version's time, and its bound."""
    import torch

    from swiftmp3_tpu_torch.ops import kernels
    from tools.torch_profile_step import cuda_ms

    args, kw = strict_input
    n = args[1].numel()
    bits = kernels.strict_sweep(*args, **kw)
    torch.cuda.synchronize()
    plain = kernels.strict_sweep_plain(*args, **kw)
    if not torch.equal(bits, plain):
        raise AssertionError(f"[K5 {what}] strict_sweep disagrees with its plain version on "
                             f"{int((bits != plain).any(dim=-1).sum())} of {n} granules")
    ms, device_ms, host = _readings(lambda: kernels.strict_sweep(*args, **kw))
    plain_ms = cuda_ms(lambda: kernels.strict_sweep_plain(*args, **kw), reps=3, warmup=1)
    bound_ms, bound_by = _strict_sweep_bound(n)
    flags = [k for k in ("count1_coding", "region_table_select", "linbits") if kw[k]]
    print(f"[K5 {what}] strict_sweep bit-exact on the {what} path's first input N={n} "
          f"{tuple(args[1].shape)} ({', '.join(flags) or 'no flags'}, {kw['sample_rate']} Hz, "
          f"b0_switch {'set' if args[4] is not None else 'none'}, part2 "
          f"{'set' if args[5] is not None else 'none'}), {card}: "
          f"{_shares(ms, device_ms, host, bound_ms)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "device_ms": device_ms, "host_us": host}


def _tensor_bytes(*groups) -> int:
    """The bytes of every tensor in the given dicts and tuples."""
    total = 0
    for group in groups:
        for t in (group.values() if isinstance(group, dict) else group):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


def _check_scans(first, what: str, card: str) -> dict:
    """K4 against its plain versions, bit for bit, on a path's own first
    scan inputs (and its placement scan's, on the strict paths); the
    selection scan's time as events, device-only and host readings, its
    plain version's time, and its bound: every byte of its inputs, outputs
    and carry moved once (its work is a serial chain over T, which no
    bound of bytes or operations sees)."""
    import torch

    from swiftmp3_tpu_torch.ops import kernels
    from tools.torch_profile_step import cuda_ms

    cfg, carry, ins = first.scan
    T, B = ins["valid"].shape
    K = carry["slot_fifo"].shape[1]
    new, outs = kernels.rate_loop_scan(cfg, carry, **ins)
    torch.cuda.synchronize()
    p_new, p_outs = kernels.rate_loop_scan_plain(cfg, carry, **ins)
    names = ("br_idx", "padding", "mdb", "slot", "k_sel", "has_fit", "bits_sel")
    bad = [n for n, a, b in zip(names, outs, p_outs) if not torch.equal(a, b)]
    bad += [k for k in new if not torch.equal(new[k], p_new[k])]
    text = ""
    if first.placement is not None:
        p_cfg, p_carry, hb, slot, final, valid = first.placement
        c2, mdb = kernels.placement_scan(p_cfg, p_carry, hb, slot, final, valid)
        pc2, pmdb = kernels.placement_scan_plain(p_cfg, p_carry, hb, slot, final, valid)
        bad += [f"placement {k}" for k in c2 if not torch.equal(c2[k], pc2[k])]
        bad += ["placement mdb"] if not torch.equal(mdb, pmdb) else []
        pl_ms, pl_device_ms, pl_host = _readings(
            lambda: kernels.placement_scan(p_cfg, p_carry, hb, slot, final, valid))
        pl_plain = cuda_ms(
            lambda: kernels.placement_scan_plain(p_cfg, p_carry, hb, slot, final, valid),
            reps=3, warmup=1,
        )
        pl_bound, _ = _bound(_tensor_bytes(p_carry, (hb, slot, final, valid, mdb), c2), 0)
        text = (f"; placement_scan bit-exact: {_shares(pl_ms, pl_device_ms, pl_host, pl_bound)}, "
                f"plain {pl_plain:.4f} ms, bound {pl_bound:.5f} ms (bytes)")
    if bad:
        raise AssertionError(f"[K4 {what}] the scans disagree with their plain versions on {bad}")
    ms, device_ms, host = _readings(lambda: kernels.rate_loop_scan(cfg, carry, **ins))
    plain_ms = cuda_ms(lambda: kernels.rate_loop_scan_plain(cfg, carry, **ins), reps=3, warmup=1)
    bound_ms, bound_by = _bound(_tensor_bytes(carry, ins, outs, new), 0)
    print(f"[K4 {what}] rate_loop_scan bit-exact on the {what} path's first inputs B={B} T={T} "
          f"G={cfg.n_gran} K={K} ({cfg.rate_law}{', aligned' * cfg.aligned}"
          f"{', demand budget' * cfg.demand_budget}), {card}: "
          f"{_shares(ms, device_ms, host, bound_ms)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}){text}", flush=True)
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "device_ms": device_ms, "host_us": host}


def _check_polyphase(hist, pcm, what: str) -> float:
    """K3 against its plain version and the folded matmul within
    K3_TOLERANCE, x identical; returns the error against the plain
    version."""
    import torch

    from swiftmp3_tpu_torch.ops import dsp, kernels

    hist, pcm = hist.contiguous(), pcm.contiguous()
    rows = hist.shape[0] * hist.shape[1]
    S, x = kernels.polyphase_chunk(hist, pcm)
    S_p, x_p = kernels.polyphase_chunk_plain(hist, pcm)
    S_m, _ = dsp.polyphase_chunk_matmul(hist, pcm)
    e_p = float((S - S_p).abs().max())
    e_m = float((S - S_m).abs().max())
    if not (e_p <= K3_TOLERANCE and e_m <= K3_TOLERANCE and torch.equal(x, x_p)):
        raise AssertionError(
            f"polyphase kernel at {rows} rows x {what}: max err {e_p:.3g} vs plain, "
            f"{e_m:.3g} vs the folded matmul (tolerance {K3_TOLERANCE}), "
            f"x equal {torch.equal(x, x_p)}"
        )
    print(f"[K3] polyphase {rows} rows x {what} ({pcm.shape[-1] // 32} windows): max err "
          f"{e_p:.3g} vs plain, {e_m:.3g} vs folded matmul, x identical", flush=True)
    return e_p


def _compare_streams(got: bytes, ref: bytes, what: str, free_kbps: int = None) -> int:
    """Assert structural equality (frame count, every header and size);
    return the number of frames whose bytes differ."""
    fg, fr = _frames(got, free_kbps), _frames(ref, free_kbps)
    if [(f[:4], len(f)) for f in fg] != [(f[:4], len(f)) for f in fr]:
        raise AssertionError(f"{what}: frame structure differs ({len(fg)} vs {len(fr)} frames)")
    return sum(a != b for a, b in zip(fg, fr))


def _sweep_inputs(chunk, options, device):
    """The main path's rate-sweep inputs (mag, gstart) for one chunk
    [B, 2, T*1152], by the port's own phase-1 functions (stereo, fresh
    carry)."""
    import torch

    from swiftmp3_tpu_torch.models.pipeline import init_carry
    from swiftmp3_tpu_torch.ops import dsp

    B, T = chunk.shape[0], chunk.shape[-1] // 1152
    carry = init_carry(B, options, device)
    S, _ = dsp.polyphase_chunk_matmul(carry["fb_hist"], chunk)
    block, _ = dsp.transient_frame(chunk.reshape(B, 2, T, 2, 576))
    spectra, _ = dsp.mdct_chunk(S, carry["overlap"], block.reshape(B, 2, 2 * T))
    spectra = spectra.reshape(B, 2, T, 2, 576)
    g0 = dsp.initial_gain(spectra)
    mag = torch.pow(torch.clamp(torch.abs(spectra), min=1e-10), 0.75).contiguous()
    return mag, torch.clamp(g0, 0, 255).to(torch.int32).contiguous()


def _check_walks(streams, n_frames: int, options=None) -> None:
    """Every stream: n_frames frames of a valid walk, each of the CBR frame
    size of `options` or one byte more (417 or 418 at 128 kbps, 44.1 kHz),
    any size under VBR; each header of `options`' sample rate and frame
    length (an MPEG-2 or 2.5 header and 576 samples at LSF rates) and, in
    free format, bitrate index 0."""
    from tests.torch_inputs import walk_frames

    sizes, rate, samples, free = {417, 418}, 44100, 1152, None
    if options is not None:
        slots = 72 if options.lsf else 144
        base = slots * options.bitrate_kbps * 1000 // options.sample_rate
        sizes = None if options.vbr else {base, base + 1}
        rate, samples = options.sample_rate, options.samples_per_frame
        free = options.bitrate_kbps if options.free_format else None
    for b, data in enumerate(streams):
        frames = walk_frames(bytes(data), free)
        if (
            len(frames) != n_frames
            or (sizes and {f["size"] for f in frames} - sizes)
            or {(f["sample_rate"], f["samples"]) for f in frames} != {(rate, samples)}
            or (free and {f["bitrate_index"] for f in frames} != {0})
        ):
            raise AssertionError(f"stream {b}: bad frame walk ({len(frames)} frames)")


def _check_pack(pack_input, what: str, card: str, repeat: int = 3, frames: int = None) -> int:
    """K2 against its plain version, bit-exact, on a path's own pack input
    and on its slots `repeat` times over (frames past the cap; the first
    `frames` frames only, if given; repeat=None: the fewest times over, 3
    at least and 16 at most, that take the fullest frame past the cap); its
    time, bound and share. Returns the number of frames past the cap."""
    import torch

    from swiftmp3_tpu_torch.ops import kernels
    from tools.torch_profile_step import cuda_ms

    c_d, n_d, cap = pack_input
    err, over = 0, 0
    c_r, n_r = c_d[:frames], n_d[:frames]
    if repeat is None:
        fullest = max(int(n_r.sum(dim=1).max()), 1)
        repeat = min(max(3, 8 * cap // fullest + 1), 16)
    for c, n in ((c_d, n_d), (torch.cat([c_r] * repeat, 1).contiguous(),
                              torch.cat([n_r] * repeat, 1).contiguous())):
        by, tot = kernels.pack(c, n, cap)
        pby, ptot = kernels.pack_plain(c, n, cap)
        err = max(err, int((by.int() - pby.int()).abs().max()), int((tot - ptot).abs().max()))
        over = int((ptot > 8 * cap).sum())
    if err:
        raise AssertionError(f"pack kernel disagrees with its plain version on the {what} input (max {err})")
    F, P = c_d.shape
    ms, device_ms, host = _readings(lambda: kernels.pack(c_d, n_d, cap))
    plain_ms = cuda_ms(lambda: kernels.pack_plain(c_d, n_d, cap), reps=5)
    bound_ms, bound_by, all_ms = _pack_bound(n_d, cap)
    print(f"[K2 {what}] pack bit-exact on the {what} path's input F={F} P={P} cap={cap} "
          f"({int((n_d > 0).sum())} live slots, widest {int(n_d.max())} bits) and on its slots "
          f"{repeat} times over ({over} of {c_r.shape[0]} frames past the cap), {card}: "
          f"{_shares(ms, device_ms, host, bound_ms, all_ms)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return over


def _serve(options, card: str) -> dict:
    """Phase 4d: the serving pool at bench.py's configuration, then K1 and
    K2 against their plain versions on the pool's own first sweep and pack
    inputs; returns the launch counts of its timed run (warm step
    included)."""
    import torch

    from swiftmp3_tpu_torch.ops import kernels
    from swiftmp3_tpu_torch.parallel import StreamPool

    lanes, fps, steps = SERVE_LANES, SERVE_FRAMES, SERVE_STEPS
    n = 1152 * options.channels
    srng = np.random.default_rng(7)
    feeds = [
        [(srng.standard_normal(fps * n) * 4000).astype(np.int16) for _ in range(lanes)]
        for _ in range(steps + 2)
    ]
    pool = StreamPool(options, lanes=lanes, frames_per_step=fps)
    try:
        sids = [pool.submit() for _ in range(lanes)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with _FirstInputs() as first:  # copies in the warm step
            for sid in sids:
                pool.feed(sid, feeds[0][sid])
            pool.step()  # warm
            times = []
            for k in range(steps):
                for sid in sids:
                    pool.feed(sid, feeds[k + 1][sid])
                t0 = time.perf_counter()
                pool.step()
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        for name in ("rate_sweep", "pack"):
            if launches[name] <= 0:
                raise AssertionError(f"the serving pool never launched kernel {name}")
        for sid in sids:
            pool.close(sid)
        pool.run_until_idle()
        _check_walks([pool.result(sid) for sid in sids], (steps + 1) * fps, options)

        # attribution at the pool's shape (bench.py:239-290)
        enc = pool.enc
        sp_pcm = np.stack([f.reshape(fps, n) for f in feeds[-1]])
        sp_fin = np.zeros((lanes, fps), dtype=bool)
        sp_val = np.ones((lanes, fps), dtype=bool)
        resident = enc.prepare(sp_pcm, sp_fin, sp_val)
        c, _ = enc._run(enc.carry, *resident)  # warm
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(4):
            c, _ = enc._run(c, *resident)
        end.record()
        end.synchronize()
        compute_ms = start.elapsed_time(end) / 4
        up = []
        for k in range(3):
            buf = np.stack([f.reshape(fps, n) for f in feeds[k]])
            t0 = time.perf_counter()
            enc._put(buf)
            torch.cuda.synchronize()
            up.append((time.perf_counter() - t0) * 1e3)
        upload_ms = statistics.median(up)
        outs = enc.step(sp_pcm, sp_fin, sp_val)
        if "ready" in outs:
            outs["ready"].synchronize()
        t0 = time.perf_counter()
        enc.drain(outs, sp_val)
        render_ms = (time.perf_counter() - t0) * 1e3
    finally:
        pool.shutdown()
    parts = {"compute": compute_ms, "upload": upload_ms, "render": render_ms}
    audio_s = lanes * fps * 1152 / options.sample_rate
    med = statistics.median(times)
    print(f"[serve] StreamPool lanes={lanes} frames_per_step={fps} ({audio_s:.2f} audio-s a step), "
          f"{card}: {steps} timed steps after 1 warm, step ms median {med:.2f} min "
          f"{min(times):.2f} max {max(times):.2f} ({audio_s / (med / 1e3):.1f} audio-s/s); "
          f"steps {['%.2f' % t for t in times]}; compute {compute_ms:.2f} ms (chained, CUDA "
          f"events), pinned int16 upload {upload_ms:.2f} ms, render {render_ms:.2f} ms (one "
          f"drain); bound by {max(parts, key=parts.get)}; {lanes} streams x "
          f"{(steps + 1) * fps} frames walk OK; launches {launches}", flush=True)
    # the kernels on the inputs the pool gave them (after the counts were read)
    _check_sweep(first.sweep, "serve", card)
    _check_pack(first.pack, "serve", card)
    _check_scans(first, "serve", card)
    return launches


def _churn_streams(rng, n_streams: int, fps: int, channels: int) -> list:
    """Mixed lengths (1 to 3 steps of frames, partial tails, exact frame
    multiples, every eighth stream empty), int16 and float32 in turns."""
    n = 1152 * channels
    t = np.arange(3 * fps * 1152) / 44100
    streams = []
    for i in range(n_streams):
        frames = int(rng.integers(1, 3 * fps))
        tail = 0 if i % 3 == 0 else int(rng.integers(1, 1152)) * channels
        length = 0 if i % 8 == 5 else frames * n + tail
        tone = np.sin(2 * np.pi * rng.uniform(100, 3000) * t)[: length // channels]
        x = np.repeat(0.3 * tone, channels) + 0.05 * rng.standard_normal(length)
        x = np.clip(x, -0.99, 0.99).astype(np.float32)
        streams.append((x * 32767).astype(np.int16) if i % 2 == 0 else x)
    return streams


def _churn(options, lanes: int, fps: int, streams: list, pipelined: bool, sample) -> tuple:
    """Runs `streams` through a pool of `lanes` lanes (every fourth one
    drip-fed across steps, the rest whole) and holds the streams of `sample`
    byte for byte to sessions on the card. Returns (each stream's bytes and
    Xing header, feeding steps, wall s)."""
    from swiftmp3_tpu_torch.encoder import new_session
    from swiftmp3_tpu_torch.parallel import StreamPool

    t0 = time.perf_counter()
    pool = StreamPool(options, lanes=lanes, frames_per_step=fps, pipelined=pipelined)
    try:
        sids = [pool.submit() for _ in streams]
        pos = [0] * len(streams)
        drip = [i for i in range(len(streams)) if i % 4 == 1]
        for i, (sid, pcm) in enumerate(zip(sids, streams)):
            if i not in drip:
                pool.feed(sid, pcm)
                pool.close(sid)
        piece = (fps * 1152 // 3 + 7) * options.channels  # a third of a step, ends mid-frame
        steps = 0
        while drip:
            for i in list(drip):
                pool.feed(sids[i], streams[i][pos[i] : pos[i] + piece])
                pos[i] += piece
                if pos[i] >= len(streams[i]):
                    pool.close(sids[i])
                    drip.remove(i)
            pool.step()
            steps += 1
        pool.run_until_idle()
        out = [(pool.result(sid), pool.xing_header(sid)) for sid in sids]
        for data, _ in out:
            _frames(data)
        for i in sample:
            s = new_session(options)
            want = s.encode(streams[i]) + s.flush()
            if pool.result(sids[i]) != want:
                raise AssertionError(
                    f"pool stream {i} ({len(streams[i])} samples, pipelined={pipelined}) "
                    f"differs from its session on the card: {_compare_streams(pool.result(sids[i]), want, 'pool')} frames"
                )
            if pool.xing_header(sids[i]) != s.generate_xing_header():
                raise AssertionError(f"pool stream {i}: Xing header differs from the session's")
    finally:
        pool.shutdown()
    return out, steps, time.perf_counter() - t0


def _drive(options, audio, steps: int):
    """BatchEncoder over `steps` chunks of `audio` [B, T, 2304] int16, each
    rendered to bytes (under window_sequencing with each frame's lookahead
    granule); the launch counts are set to 0 just before and read just
    after. Returns (streams, step device ms, step+render wall s, launches,
    the _FirstInputs with the first sweep and pack calls' inputs)."""
    from tests.torch_inputs import step_lookahead

    import torch

    from swiftmp3_tpu_torch.ops import kernels
    from swiftmp3_tpu_torch.parallel.batch import BatchEncoder

    B, T = audio[0].shape[:2]
    enc = BatchEncoder(options, B, T)
    final = np.zeros((B, T), dtype=bool)
    valid = np.ones((B, T), dtype=bool)
    streams = [bytearray() for _ in range(B)]
    step_ms, wall_s = [], []
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with _FirstInputs() as first:
            for k in range(steps):
                w0 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                la = step_lookahead(audio, k, options.channels) if options.window_sequencing else None
                outs = enc.step(audio[k], final, valid, la)
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
    return streams, step_ms, wall_s, launches, first


def _hq_dc(mono_audio, card: str) -> int:
    """Phase 4h: distortion control at full width (2 steps), the flag-off
    encode of the same audio (2 steps; the bytes must differ), one step at
    the depth knobs; K2 on the dc path's pack input. Returns K5's launches
    in the three runs."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from tests.torch_inputs import B_MAIN, DC_IS_OPTIONS, T_MAIN, dc_is_options

    dc_opts = dc_is_options("hq_dc_mono128", MP3EncoderOptions)
    dc_off = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=128, sample_rate=44100, scfsi=False)
    audio_s = B_MAIN * T_MAIN * 1152 / dc_opts.sample_rate
    runs = {}
    k5 = 0
    for label, o, steps in (("off", dc_off, STEPS_DC), ("dc", dc_opts, STEPS_DC),
                            ("dc3p", dc_is_options("hq_dc3p_mono128", MP3EncoderOptions), 1)):
        d_streams, d_step_ms, _, d_launches, d_first = _drive(o, mono_audio, steps)
        if d_launches["pack"] < steps:
            raise AssertionError(f"the hq dc path ({label}) launched pack {d_launches['pack']} times")
        k5 += _expect_k5(d_launches, o, steps, f"hq dc ({label})")
        _check_walks(d_streams, steps * T_MAIN, o)
        runs[label] = (d_streams, d_step_ms, d_launches)
        if label == "dc":
            dc_pack = d_first.pack
        del d_first
    dc_flips = sum(_compare_streams(bytes(a), bytes(b), "hq dc vs dc off")
                   for a, b in zip(runs["dc"][0], runs["off"][0]))
    if dc_flips == 0:
        raise AssertionError("distortion control left every frame's bytes as with the flag off")
    print(f"[hq dc] BatchEncoder hq {DC_IS_OPTIONS['hq_dc_mono128'][1]} B={B_MAIN} T={T_MAIN} x "
          f"{STEPS_DC} steps, {card}: {B_MAIN} streams x {STEPS_DC * T_MAIN} frames walk OK; "
          f"{dc_flips} of {B_MAIN * STEPS_DC * T_MAIN} frames differ from the flag-off encode of "
          f"the same audio; launches {runs['dc'][2]}", flush=True)
    for label, what in (("off", "flag off (scfsi off)"), ("dc", "dc_passes=1"),
                        ("dc3p", "dc_passes=3, dc_proportional=True")):
        for k, t in enumerate(runs[label][1]):
            print(f"[hq dc] {what} step {k} device ms {t:.2f} ({audio_s / (t / 1e3):.1f} audio-s/s)",
                  flush=True)
    print(f"[hq dc] one pass by step differences (the host-bound loops vary more): dc_passes=1 "
          f"- off {runs['dc'][1][-1] - runs['off'][1][-1]:.2f} ms (last steps), (dc_passes=3 - "
          f"dc_passes=1) / 2 {(runs['dc3p'][1][0] - runs['dc'][1][-1]) / 2:.2f} ms", flush=True)
    del runs
    if _check_pack(dc_pack, "hq dc", card) == 0:
        raise AssertionError("no frame of the hq dc pack check ran past the cap")
    return k5


def _hq_is(card: str) -> tuple:
    """Phase 4i: intensity stereo at full width on panned two-tone audio (2
    steps), some frames emitting intensity; K2 on the IS path's pack
    input. Returns ((options, audio, streams) of the first DECODE_ROWS rows
    for [decode], K5's launches)."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from tests.torch_inputs import (
        B_MAIN,
        DC_IS_OPTIONS,
        T_MAIN,
        dc_is_options,
        panned_audio,
        walk_frames,
    )

    is_opts = dc_is_options("hq_is_32k", MP3EncoderOptions)
    audio_s = B_MAIN * T_MAIN * 1152 / is_opts.sample_rate
    irng = np.random.default_rng(12)
    is_audio = [panned_audio(irng, B_MAIN, T_MAIN) for _ in range(STEPS_IS)]
    i_streams, i_step_ms, i_wall_s, i_launches, i_first = _drive(is_opts, is_audio, STEPS_IS)
    if i_launches["pack"] < STEPS_IS:
        raise AssertionError(f"the hq is path launched pack {i_launches['pack']} times")
    k5 = _expect_k5(i_launches, is_opts, STEPS_IS, "hq is")
    _check_walks(i_streams, STEPS_IS * T_MAIN, is_opts)
    emit = sum(f["mode_extension"] == 1 for d in i_streams for f in walk_frames(bytes(d)))
    if emit == 0:
        raise AssertionError("the hq is path emitted no intensity frame")
    print(f"[hq is] BatchEncoder hq {DC_IS_OPTIONS['hq_is_32k'][1]} (lowpass_hz "
          f"{is_opts.lowpass_hz}, adaptive) B={B_MAIN} T={T_MAIN} x {STEPS_IS} steps of panned "
          f"two-tone audio, {card}: {B_MAIN} streams x {STEPS_IS * T_MAIN} frames walk OK; {emit} "
          f"of {B_MAIN * STEPS_IS * T_MAIN} frames emit intensity (mode_extension 0b01); "
          f"step+render wall s {['%.3f' % t for t in i_wall_s]}; launches {i_launches}", flush=True)
    for k, t in enumerate(i_step_ms):
        print(f"[hq is] step {k} device ms {t:.2f} ({audio_s / (t / 1e3):.1f} audio-s/s)", flush=True)
    rows = (is_opts, [a[:DECODE_ROWS].copy() for a in is_audio], i_streams[:DECODE_ROWS])
    del i_streams
    # a 32 kbps frame holds a fifth of the 128 kbps slots' bits: 8 times over
    # (on the first 4096 frames, within the plain version's memory) runs
    # frames past the cap
    if _check_pack(i_first.pack, "hq is", card, repeat=8, frames=4096) == 0:
        raise AssertionError("no frame of the hq is pack check ran past the cap")
    return rows, k5


def _parity_dc_is() -> None:
    """The distortion-control and intensity rows against the JAX backend's
    frozen bytes (the card's own within a ceiling per configuration; with
    the CPU filterbank and MDCT exact) and the golden encoder's (the
    telemetry corpus within the telemetry suite's ceilings). Each
    configuration's rows run as one batch (encode_batch, whose bytes are
    its sessions')."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from swiftmp3_tpu_torch.parallel import encode_batch
    from tests.torch_inputs import DC_IS_OPTIONS, dc_is_options, dc_is_streams, golden_path, jax_path

    for preset in DC_IS_OPTIONS:
        o = dc_is_options(preset, MP3EncoderOptions)
        flips = {"jax": 0, "golden": 0}
        n_frames = 0
        streams = dc_is_streams(preset)
        card = encode_batch(o, list(streams.values()), frames_per_step=16)
        with _CpuFilterbank():
            swapped = encode_batch(o, list(streams.values()), frames_per_step=16)
        for stem, got, got_cpu_fb in zip(streams, card, swapped):
            with open(jax_path(f"{preset}_{stem}"), "rb") as fh:
                ref = fh.read()
            flips["jax"] += _compare_streams(got, ref, f"{preset} {stem} vs JAX")
            n_frames += len(_frames(ref))
            with open(golden_path(stem, preset), "rb") as fh:
                flips["golden"] += _compare_streams(got, fh.read(), f"{preset} {stem} vs golden")
            if got_cpu_fb != ref:
                raise AssertionError(f"{preset} {stem}: {_compare_streams(got_cpu_fb, ref, preset)} "
                                     "frames differ from the JAX bytes with the CPU filterbank and MDCT")
        ceiling = DC_IS_GOLDEN_FLIP_CEILING.get(preset)
        print(f"[parity dc is] {preset}: vs JAX {flips['jax']}/{n_frames} (ceiling "
              f"{DC_IS_JAX_FLIP_CEILING[preset]}), with the CPU filterbank and MDCT 0/{n_frames}; "
              f"vs golden {flips['golden']}/{n_frames}"
              + (f" (ceiling {ceiling})" if ceiling is not None else " (structure)"), flush=True)
        if flips["jax"] > DC_IS_JAX_FLIP_CEILING[preset] or (
            ceiling is not None and flips["golden"] > ceiling
        ):
            raise AssertionError(f"{preset} byte flips above the pinned ceiling")


def _lsf(mono_audio, card: str) -> tuple:
    """Phase 4j: the LSF paths at full width ([lsf strict], [lsf hq], [lsf
    iso]: 256 streams x 128 frames of 576 samples of bench audio at their
    rates, STEPS_LSF steps each) and free format ([free format]: one step of
    the main bench audio's left channel); every frame walk checked, step
    times printed; K1 against its plain version on the lsf iso path's sweep
    input, K5 on the lsf strict path's ([K5 lsf strict]), K2 on each path's
    pack input and on its slots three times over
    (past the cap). Returns (each path's launch counts, the [lsf hq] path's
    options, audio and streams of the first DECODE_ROWS rows for
    [decode])."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from tests.torch_inputs import B_MAIN, LSF_PATHS, T_MAIN, bench_audio, build_options, walk_frames

    lrng = np.random.default_rng(13)
    audio_of = {}  # (channels, rate) -> STEPS_LSF steps of LSF bench audio
    launches = {}
    for path, (factory, kw) in LSF_PATHS.items():
        o = build_options(factory, kw, MP3EncoderOptions)
        if o.free_format:
            audio, steps = mono_audio, 1
        else:
            key = (o.channels, o.sample_rate)
            if key not in audio_of:
                audio_of[key] = [bench_audio(lrng, B_MAIN, T_MAIN, o.channels, o.sample_rate, spf=576)
                                 for _ in range(STEPS_LSF)]
            audio, steps = audio_of[key], STEPS_LSF
        streams, step_ms, wall_s, p_launches, first = _drive(o, audio, steps)
        for name in ("rate_sweep", "pack") if path == "lsf iso" else ("pack",):
            if p_launches[name] < steps:
                raise AssertionError(f"the {path} path launched {name} {p_launches[name]} times "
                                     f"in {steps} steps")
        _expect_k5(p_launches, o, steps, path)
        _check_walks(streams, steps * T_MAIN, o)
        f0 = walk_frames(bytes(streams[0]), o.bitrate_kbps if o.free_format else None)[0]
        audio_s = B_MAIN * T_MAIN * o.samples_per_frame / o.sample_rate
        print(f"[{path}] BatchEncoder {factory or 'MP3EncoderOptions'}({kw}) B={B_MAIN} T={T_MAIN} x "
              f"{steps} steps, {card}: {B_MAIN} streams x {steps * T_MAIN} frames walk OK (MPEG-"
              f"{f0['version']} headers, bitrate index {f0['bitrate_index']}, {f0['samples']} samples "
              f"a frame, main_data cap {first.pack[2]} B); step+render wall s "
              f"{['%.3f' % t for t in wall_s]}; launches {p_launches}", flush=True)
        for k, t in enumerate(step_ms):
            print(f"[{path}] step {k} device ms {t:.2f} ({audio_s / (t / 1e3):.1f} audio-s/s)", flush=True)
        if path == "lsf hq":
            rows = (o, [a[:DECODE_ROWS].copy() for a in audio], streams[:DECODE_ROWS])
        del streams
        if path == "lsf iso":
            _check_sweep(first.sweep, path, card)
        if path == "lsf strict":
            _check_strict_sweep(first.strict, path, card)
        # an LSF frame's slots hold a fraction of the cap's bits: enough
        # times over (on the first 4096 frames) runs frames past it
        if _check_pack(first.pack, path, card, repeat=None, frames=4096) == 0:
            raise AssertionError(f"no frame of the {path} pack check ran past the cap")
        del first
        launches[path] = p_launches
    return launches, rows


def _parity_lsf() -> None:
    """The LSF and free-format rows against the JAX package's frozen bytes,
    each as a card batch of ODD_STEP (7) frames a step (LSF chunks of an
    odd number of frames) against the JAX batch at 7 a step, and as a card
    session against the JAX session: the card's own bytes within a ceiling
    per row, and with the CPU filterbank and MDCT exact both ways."""
    from swiftmp3_tpu_torch.encoder import new_session
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from swiftmp3_tpu_torch.parallel import encode_batch
    from tests.torch_inputs import FF_ROWS, LSF_ROWS, ODD_STEP, jax_path, lsf_row_options, lsf_row_pcm

    for row in (*LSF_ROWS, *FF_ROWS):
        o = lsf_row_options(row, MP3EncoderOptions)
        pcm = lsf_row_pcm(row)
        free = o.bitrate_kbps if o.free_format else None
        refs = []
        for stem in (f"{row}_step{ODD_STEP}", row):
            with open(jax_path(stem), "rb") as fh:
                refs.append(fh.read())
        n_frames = len(_frames(refs[1], free))

        def batch_and_session():
            s = new_session(o)
            return encode_batch(o, [pcm], frames_per_step=ODD_STEP)[0], s.encode(pcm) + s.flush()

        got = batch_and_session()
        with _CpuFilterbank():
            swapped = batch_and_session()
        for how, data, ref in zip(("batch", "session"), swapped, refs):
            if data != ref:
                raise AssertionError(f"{row}: the card {how} with the CPU filterbank and MDCT differs "
                                     f"from the JAX bytes in {_compare_streams(data, ref, row, free)} frames")
        flips = [_compare_streams(data, ref, f"{row} vs JAX", free) for data, ref in zip(got, refs)]
        print(f"[parity lsf] {row}: vs JAX as a card batch {flips[0]}/{n_frames}, as a card session "
              f"{flips[1]}/{n_frames} (ceiling {LSF_JAX_FLIP_CEILING[row]}); with the CPU filterbank "
              f"and MDCT 0/{n_frames} both ways", flush=True)
        if max(flips) > LSF_JAX_FLIP_CEILING[row]:
            raise AssertionError(f"{row} byte flips above the pinned ceiling")


def _golden_rows(options, audio: list) -> list:
    """The golden encoder's streams of the rows of `audio` (steps [R, T, n]
    int16), fed as BatchEncoder was fed: each step's frames, under
    window_sequencing with each frame's lookahead granule (bench.py's
    contract, no preroll: the session's encode() would prepend one), then
    the buffered frames flushed."""
    from swiftmp3_tpu_torch.encoder import new_session
    from tests.torch_inputs import step_lookahead

    scale = np.float32(32768.0)
    out = []
    for r in range(audio[0].shape[0]):
        s = new_session(options, backend="numpy")
        data = bytearray()
        for k, step in enumerate(audio):
            la = None
            if options.window_sequencing:
                la = step_lookahead(audio, k, options.channels)[r].astype(np.float32) / scale
            frames = step[r].astype(np.float32) / scale
            for fr in s.backend.encode_frames(frames, np.zeros(len(frames), bool), lookahead=la):
                data += s.assembler.push(fr)
        out.append(bytes(data + s.assembler.flush_buffered()))
    return out


def _decode_row(options, audio: list, card_data: bytes) -> dict:
    """[decode] for one row: the golden encoder's stream of the row's audio
    (steps [1, T, n] int16), held structurally equal to the card's stream;
    both decoded by the port's oracle (every frame must parse, CRCs verify
    where the options protect them, equal sample counts; a compat stream's
    frame whose main_data reaches before the stream's start decodes to
    nothing, the reference's data placement) and scored per
    channel against the input; the card's stream through libmpg123 where
    the host has it. Runs in a worker process: numpy only."""
    from swiftmp3_tpu_torch.decoder.decoder import decode_mp3, verify_frame_crcs
    from swiftmp3_tpu_torch.utils.external import have_mpg123, mpg123_decode
    from swiftmp3_tpu_torch.utils.quality import (
        decode_agreement_snr,
        masked_noise_ratio,
        measure_quality,
    )

    t0 = time.perf_counter()
    (golden,) = _golden_rows(options, audio)
    _compare_streams(card_data, golden, "card vs golden")
    fc, fg = _frames(card_data), _frames(golden)
    n_frames = len(fc)
    ch, sr = options.channels, options.sample_rate
    pcm = np.concatenate([a[0].reshape(-1) for a in audio]).astype(np.float32).reshape(-1, ch) / 32768
    out = {"differ": [i for i, (a, b) in enumerate(zip(fc, fg)) if a != b], "frames": n_frames}
    decoded = {}
    for who, data in (("card", card_data), ("golden", golden)):
        dec = decode_mp3(data, iso_conventions=options.iso_ms_matrix)
        if dec.frame_count != n_frames or dec.pcm.shape[1] != ch:
            raise AssertionError(f"{who}: parsed {dec.frame_count} of {n_frames} frames, "
                                 f"{dec.pcm.shape[1]} channels")
        crcs = verify_frame_crcs(data)
        if options.crc_protected and (len(crcs) != n_frames or not all(crcs)):
            raise AssertionError(f"{who}: {crcs.count(False)} of {n_frames} frames fail their CRC")
        decoded[who] = dec.pcm
        out[who] = {
            "snr": [measure_quality(pcm[:, c], dec.pcm[:, c], sr).snr_db for c in range(ch)],
            "nmr": [masked_noise_ratio(pcm[:, c], dec.pcm[:, c], sr) for c in range(ch)],
        }
    if decoded["card"].shape != decoded["golden"].shape:
        raise AssertionError(f"decoded {decoded['card'].shape} from the card's stream, "
                             f"{decoded['golden'].shape} from the golden's")
    out["decoded_frames"] = len(decoded["card"]) // options.samples_per_frame
    out["mpg123"] = None
    if have_mpg123():
        ext, rate = mpg123_decode(card_data)
        if rate != sr or ext.shape[1] != ch:
            raise AssertionError(f"libmpg123 decoded {ext.shape} at {rate} Hz")
        out["mpg123"] = min(decode_agreement_snr(decoded["card"][:, c], ext[:, c]) for c in range(ch))
    out["seconds"] = time.perf_counter() - t0
    return out


_ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _decode_phase(paths: dict, card: str) -> None:
    """[decode]: for each bulk path {name: (options, audio, streams)} (the
    phase's steps of audio and its streams, first DECODE_ROWS rows), each
    row through _decode_row in a pool of worker processes; per path, the
    card's and the golden's scores side by side, the flips and the score
    differences against their ceilings, the libmpg123 agreement."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from unittest import mock

    from swiftmp3_tpu_torch.utils.external import have_mpg123

    t0 = time.perf_counter()
    jobs = [(name, o, [a[r : r + 1] for a in audio], bytes(streams[r]))
            for name, (o, audio, streams) in paths.items() for r in range(DECODE_ROWS)]
    workers = min(len(jobs), os.cpu_count() or 1)
    # one BLAS thread a worker: the workers take the environment at start
    with mock.patch.dict(os.environ, _ONE_THREAD), ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        futures = [pool.submit(_decode_row, o, audio, data) for _, o, audio, data in jobs]
        rows = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    failed = []
    for name in paths:
        got = [row for (n, *_), row in zip(jobs, rows) if n == name]
        differ = [f"{r}:{i}" for r, row in enumerate(got) for i in row["differ"]]
        flips, frames = len(differ), sum(r["frames"] for r in got)
        decoded = sum(r["decoded_frames"] for r in got)
        means, diffs = {}, {}
        for key in ("snr", "nmr"):
            for who in ("card", "golden"):
                means[key, who] = statistics.fmean(v for r in got for v in r[who][key])
            diffs[key] = max(abs(a - b) for r in got for a, b in zip(r["card"][key], r["golden"][key]))
        agree = [r["mpg123"] for r in got]
        mpg = (f"libmpg123 agreement with the oracle min {min(agree):.1f} dB" if have_mpg123()
               else "libmpg123 absent on this host")
        o = paths[name][0]
        print(f"[decode] {name}: {DECODE_ROWS} streams x {frames // DECODE_ROWS} frames, {card}: structure "
              f"equal to the golden encoder's, {flips}/{frames} frames differ (ceiling "
              f"{DECODE_FLIP_CEILING[name]}; row:frame {differ}); every frame parses"
              + (", CRCs verify" if o.crc_protected else " (no CRC)")
              + f", {decoded}/{frames} decode to samples, as many as the golden's"
              + f"; SNR card {means['snr', 'card']:.2f} golden {means['snr', 'golden']:.2f} dB (mean of "
              f"channels), NMR card {means['nmr', 'card']:.2f} golden {means['nmr', 'golden']:.2f} dB; "
              f"largest difference of a channel SNR {diffs['snr']:.6f} NMR {diffs['nmr']:.6f} dB "
              f"(ceiling {DECODE_SCORE_CEILING_DB}); {mpg}", flush=True)
        if flips > DECODE_FLIP_CEILING[name] or max(diffs.values()) > DECODE_SCORE_CEILING_DB:
            failed.append(name)
        if have_mpg123() and o.iso_ms_matrix and min(agree) < MPG123_AGREEMENT_FLOOR_DB:
            failed.append(f"{name} (libmpg123)")
    print(f"[decode] {len(jobs)} streams in {workers} worker processes: {wall:.2f} s wall, "
          f"{sum(r['seconds'] for r in rows):.2f} s of work", flush=True)
    if failed:
        raise AssertionError(f"[decode] above the pinned ceilings: {failed}")


def _stream_rows(audio) -> list:
    """The bench audio's steps [B, T, n] joined per stream: B int16 streams
    of len(audio) * T frames."""
    return [np.concatenate([a[b].reshape(-1) for a in audio]) for b in range(audio[0].shape[0])]


def _mesh(opts, audio, card: str) -> tuple:
    """Phase 4k: encode_batch of the main path's streams over every card,
    over MESH_POSITIONS positions on cuda:0 and on one card without a mesh;
    K1 and K2 on one position's first inputs (and on the last card, given
    two). Returns (the launch counts of the three runs, summed; the
    one-card bytes)."""
    import torch

    from swiftmp3_tpu_torch.ops import kernels
    from swiftmp3_tpu_torch.parallel import encode_batch, make_mesh

    streams = _stream_rows(audio)
    steps, T = len(audio), audio[0].shape[1]
    runs = {}
    for label, kw in (("every card", dict(mesh=make_mesh())),
                      (f"{MESH_POSITIONS} positions on cuda:0",
                       dict(mesh=make_mesh(["cuda:0"] * MESH_POSITIONS))),
                      ("one card", dict(device="cuda"))):
        positions = kw["mesh"].size if "mesh" in kw else 1
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with _FirstInputs() as first:
            t0 = time.perf_counter()
            out = encode_batch(opts, streams, frames_per_step=T, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for name in ("rate_sweep", "pack", "rate_loop_scan"):
            if launches[name] != steps * positions:
                raise AssertionError(f"[mesh] {label}: {launches[name]} launches of {name} in {steps} "
                                     f"steps over {positions} positions")
        _expect_k5(launches, opts, steps * positions, f"[mesh] {label}")
        _check_walks(out, steps * T)
        runs[label] = (out, wall, positions, launches)
        if positions == MESH_POSITIONS:
            position_inputs = first
        del first
    one = runs["one card"][0]
    n_frames = len(one) * steps * T
    text = []
    for label, (out, wall, positions, launches) in runs.items():
        text.append(f"{label} ({positions} position{'s' * (positions > 1)}, {len(one) // positions} "
                    f"streams each) {wall:.3f} s, {wall / steps:.3f} s a step, launches "
                    f"{launches['rate_sweep']}/{launches['pack']}")
        if label == "one card":
            continue
        if positions == 1:
            if out != one:
                raise AssertionError(f"[mesh] {label}: one position differs from the one-card run")
            text[-1] += ": byte-equal to the one-card run"
            continue
        flips = sum(_compare_streams(a, b, f"[mesh] {label}") for a, b in zip(out, one))
        text[-1] += (f": structure equal to the one-card run, {flips}/{n_frames} frames differ "
                     f"(ceiling {MESH_FLIP_CEILING})")
        if flips > MESH_FLIP_CEILING:
            raise AssertionError(f"[mesh] {label}: byte flips above the pinned ceiling")
    print(f"[mesh] encode_batch {opts.mode.value} {opts.bitrate_kbps} kbps, {len(one)} streams x "
          f"{steps * T} frames, {T} a step, {card}: " + "; ".join(text)
          + f"; every frame walk OK (wall times with the render; launches K1/K2)", flush=True)
    _check_sweep(position_inputs.sweep, "mesh", card)
    _check_pack(position_inputs.pack, "mesh", card)
    n = torch.cuda.device_count()
    if n > 1:
        dev = torch.device("cuda", n - 1)
        torch.cuda.set_device(0)
        c, nb, cap = position_inputs.pack
        by, tot = kernels.pack(c.to(dev), nb.to(dev), cap)
        pby, ptot = kernels.pack_plain(c.to(dev), nb.to(dev), cap)
        err = max(_sweep_on(position_inputs.sweep, dev), int((by.int() - pby.int()).abs().max()),
                  int((tot - ptot).abs().max()))
        if err:
            raise AssertionError(f"[mesh] K1/K2 on {dev} disagree with their plain versions (max {err})")
        print(f"[mesh] K1 and K2 bit-exact on {dev} while cuda:0 is current, {card}", flush=True)
    else:
        print("[mesh] this host has 1 card: the mesh of every card is one position, and K1 and K2 "
              "on a card other than the current one were not run (they need two cards)", flush=True)
    total = {k: sum(r[3][k] for r in runs.values())
             for k in ("rate_sweep", "pack", "rate_loop_scan", "placement_scan", "strict_sweep")}
    return total, one


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multihost_worker(port: str, pid: str, out_dir: str) -> int:
    """One process of [multihost]: joins the group of two, takes its half
    of the main path's streams and encodes them twice with
    encode_batch_multihost over make_mesh() (both processes' cuda:0);
    writes its bytes to out_dir and prints one JSON line of its wall times
    and launch counts."""
    import torch

    from swiftmp3_tpu_torch.parallel import initialize_multihost

    pid = int(pid)
    initialize_multihost(f"127.0.0.1:{port}", 2, pid)
    from swiftmp3_tpu_torch.ops import kernels
    from swiftmp3_tpu_torch.options import MP3EncoderOptions
    from swiftmp3_tpu_torch.parallel import encode_batch_multihost, make_mesh
    from tests.torch_inputs import B_MAIN, MAIN_OPTIONS, T_MAIN, bench_audio

    opts = MP3EncoderOptions(**MAIN_OPTIONS)
    rng = np.random.default_rng(0)  # the main path's audio
    audio = [bench_audio(rng, B_MAIN, T_MAIN, opts.channels, opts.sample_rate) for _ in range(STEPS_MAIN)]
    half = B_MAIN // 2
    mine = _stream_rows(audio)[pid * half : (pid + 1) * half]
    del audio
    mesh = make_mesh()
    kernels.build_kernels()
    walls, launches, blobs = [], [], None
    for _ in range(2):  # the first call warms the process up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = encode_batch_multihost(opts, mine, frames_per_step=T_MAIN, mesh=mesh)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(dict(kernels.LAUNCHES))
        if blobs is not None and got != blobs:
            raise AssertionError(f"process {pid}: the second call's bytes differ from the first's")
        blobs = got
    np.savez(os.path.join(out_dir, f"streams_{pid}.npz"),
             lengths=np.array([len(b) for b in blobs]), data=np.frombuffer(b"".join(blobs), np.uint8))
    torch.distributed.destroy_process_group()
    print(json.dumps({"pid": pid, "mesh": [[p, str(d)] for p, d in mesh.positions],
                      "walls_s": walls, "launches": launches}), flush=True)
    return 0


def _multihost(opts, audio, one_card: list, card: str) -> dict:
    """Phase 4l: two worker processes on cuda:0 (their bytes against one
    process's encode_batch over the same layout, and the one-card run's);
    returns the launch counts of both processes' calls, summed."""
    import tempfile

    import torch

    from swiftmp3_tpu_torch.parallel import encode_batch, make_mesh

    streams = _stream_rows(audio)
    steps, T = len(audio), audio[0].shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = encode_batch(opts, streams, frames_per_step=T, mesh=make_mesh(["cuda:0"] * 2))
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multihost-worker", str(port), str(pid), tmp],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for pid in range(2)
        ]
        try:
            outs = [p.communicate(timeout=MULTIHOST_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        span = time.perf_counter() - t0
        for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"[multihost] process {pid} failed (exit {p.returncode}):\n"
                                     f"{so[-2000:]}\n{se[-4000:]}")
        reports = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
        got = []
        for pid in range(2):
            z = np.load(os.path.join(tmp, f"streams_{pid}.npz"))
            ends = np.cumsum(z["lengths"])
            data = z["data"].tobytes()
            got += [data[e - n : e] for n, e in zip(z["lengths"], ends)]
    if got != one:
        differ = sum(a != b for a, b in zip(got, one))
        raise AssertionError(f"[multihost] the two processes' bytes differ from one process's in {differ} "
                             "streams")
    _check_walks(got, steps * T)
    flips = sum(_compare_streams(a, b, "[multihost] vs one card") for a, b in zip(got, one_card))
    if flips > MESH_FLIP_CEILING:
        raise AssertionError("[multihost] byte flips against the one-card run above the pinned ceiling")
    for r in reports:
        for calls in r["launches"]:
            if calls["rate_sweep"] != steps or calls["pack"] != steps:
                raise AssertionError(f"[multihost] process {r['pid']} launched {calls} in {steps} steps")
    print(f"[multihost] two processes (gloo on localhost), mesh {reports[0]['mesh']}, each "
          f"encode_batch_multihost of {len(one) // 2} streams x {steps * T} frames, {card}: "
          + "; ".join(f"process {r['pid']} wall s {['%.3f' % w for w in r['walls_s']]} (cold, warm), "
                      f"launches {r['launches'][-1]}" for r in reports)
          + f"; both processes {span:.2f} s from start to exit; one process, the same streams over the "
          f"same 2 positions: {one_wall:.3f} s; bytes equal to the one process's, structure equal to the "
          f"one-card run with {flips}/{len(one) * steps * T} frames differing (ceiling "
          f"{MESH_FLIP_CEILING})", flush=True)
    return {k: sum(c[k] for r in reports for c in r["launches"]) for k in ("rate_sweep", "pack")}


def _entry_phase(card: str) -> dict:
    """Phase 4m: the graft entry (swiftmp3_tpu_torch/graft_entry.py) on the
    card; returns the launch counts of its driven calls, summed (the
    comparisons with the plain versions not counted)."""
    import torch

    from swiftmp3_tpu_torch.graft_entry import dryrun_multichip, entry
    from swiftmp3_tpu_torch.models.pipeline import fetch_outputs
    from swiftmp3_tpu_torch.ops import kernels
    from swiftmp3_tpu_torch.options import MP3EncoderOptions, Mode
    from tests.torch_inputs import B_MAIN, T_MAIN, differing_frames, frozen_entry

    total = {"rate_sweep": 0, "pack": 0}

    def driven(call, want: tuple, what: str):
        """call() with the launch counts set to 0 just before and read just
        after; (its result, wall s)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (kernels.LAUNCHES["rate_sweep"], kernels.LAUNCHES["pack"])
        if got != want:
            raise AssertionError(f"[entry] {what}: launches K1/K2 {got}, want {want}")
        total["rate_sweep"] += got[0]
        total["pack"] += got[1]
        return out, wall

    def check_flips(flips: int, ceiling: int, what: str) -> None:
        if flips > ceiling:
            raise AssertionError(f"[entry] {what}: {flips} frames differ (ceiling {ceiling})")

    dev = torch.device("cuda")
    o = MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128)
    fn, args = entry()
    with _FirstInputs() as first:
        (_, outs), cold = driven(lambda: fn(*args), (1, 1), "entry, cold")
    (_, again), warm = driven(lambda: fn(*args), (1, 1), "entry, warm")
    got = fetch_outputs(outs, o)
    if differing_frames(fetch_outputs(again, o), got):
        raise AssertionError("[entry] the warm call's outputs differ from the cold call's")
    c, nb, cap = first.pack
    by, tot = kernels.pack(c, nb, cap)
    pby, ptot = kernels.pack_plain(c, nb, cap)
    err = max(_sweep_on(first.sweep, dev), int((by.int() - pby.int()).abs().max()),
              int((tot - ptot).abs().max()))
    if err:
        raise AssertionError(f"[entry] K1/K2 disagree with their plain versions on the entry's inputs ({err})")
    cpu_fn, cpu_args = entry("cpu")
    flips_cpu = differing_frames(got, fetch_outputs(cpu_fn(*cpu_args)[1], o))
    flips_jax = differing_frames(got, frozen_entry("entry")[0])
    n_frames = got["part23"].shape[0] * got["part23"].shape[1]
    print(f"[entry] entry(): 8 streams x 4 frames, 128 kbps CBR stereo, {card}: cold {1e3 * cold:.2f} ms, "
          f"warm {1e3 * warm:.2f} ms a step (wall, synchronised); K1 N={first.sweep[1].numel()} and K2 "
          f"F={c.shape[0]} P={c.shape[1]} cap={cap} bit-exact on its first inputs; frames differing vs "
          f"entry('cpu') {flips_cpu}/{n_frames}, vs the JAX entry {flips_jax}/{n_frames} (ceiling "
          f"{ENTRY_FLIP_CEILING})", flush=True)
    check_flips(flips_cpu, ENTRY_FLIP_CEILING, "entry vs entry('cpu')")
    check_flips(flips_jax, ENTRY_FLIP_CEILING, "entry vs the JAX entry")

    for n in sorted({MESH_POSITIONS, torch.cuda.device_count()}):
        res, wall = driven(lambda: dryrun_multichip(n), (n, 2 * n), f"dryrun_multichip({n})")
        # frozen at ENTRY_DRYRUN_POSITIONS: a host of another card count raises here
        flips = {k: differing_frames(res[k][0], frozen_entry(f"dry{n}.{k}")[0]) for k in res}
        print(f"[entry] dryrun_multichip({n}) batch {2 * n}, {card}: {wall:.3f} s; frames differing vs "
              f"the JAX dry run {flips} of {2 * n * 2} a step (ceiling {ENTRY_FLIP_CEILING})", flush=True)
        for k, f in flips.items():
            check_flips(f, ENTRY_FLIP_CEILING, f"dryrun_multichip({n}) {k}")

    B, T = B_MAIN, T_MAIN
    with _FirstInputs() as first:
        four, wall4 = driven(lambda: dryrun_multichip(MESH_POSITIONS, batch=B, frames=T),
                             (MESH_POSITIONS, 2 * MESH_POSITIONS), "the bulk dry run over 4 positions")
    one, wall1 = driven(lambda: dryrun_multichip(1, batch=B, frames=T), (1, 2),
                        "the bulk dry run over 1 position")
    flips = {k: differing_frames(four[k][0], one[k][0]) for k in four}
    print(f"[entry] bulk dryrun_multichip, {B} streams x {T} frames (compat joint-stereo VBR q3, then hq "
          f"joint stereo), {card}: {MESH_POSITIONS} positions on cuda:0 ({B // MESH_POSITIONS} streams "
          f"each) {wall4:.3f} s, 1 position {wall1:.3f} s (wall, inputs drawn and outputs fetched "
          f"included); the dry run's checks hold; frames differing, 4 positions vs 1: {flips} of "
          f"{B * T} a step (ceiling {ENTRY_BULK_FLIP_CEILING} over both)", flush=True)
    check_flips(sum(flips.values()), ENTRY_BULK_FLIP_CEILING, "the bulk dry run, 4 positions vs 1")
    _check_sweep(first.sweep, "entry", card)
    _check_pack(first.pack, "entry", card)
    return total


def main() -> int:
    import torch

    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        print(f"[time] {name} {now - t_phase[0]:.2f} s", flush=True)
        t_phase[0] = now

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from swiftmp3_tpu_torch import cli
    from swiftmp3_tpu_torch.encoder import new_session
    from swiftmp3_tpu_torch.io.huffman_pack import pack_frame_main_data
    from swiftmp3_tpu_torch.ops import dsp, kernels
    from swiftmp3_tpu_torch.options import ID3Tag, MP3EncoderOptions
    from swiftmp3_tpu_torch.parallel import encode_corpus
    from swiftmp3_tpu_torch.utils import read_wav, write_wav
    from tests.torch_inputs import (
        B_MAIN,
        CLI_ARGS,
        CLI_SIGNAL,
        COMPAT_FIXTURES,
        CORPUS_OPTIONS,
        CORPUS_TAGS,
        HQ_FLAG_OPTIONS,
        HQ_OPTIONS,
        MAIN_OPTIONS,
        STRICT_FIXTURES,
        STRICT_OPTIONS,
        T_MAIN,
        bench_audio,
        cli_pcm,
        corpus_streams,
        fixture_path,
        golden_path,
        golden_streams,
        hq_flag_streams,
        hq_streams,
        jax_path,
        knife_edge_sweep_input,
        make_signal,
        walk_frames,
    )
    from tools.torch_profile_step import cuda_ms, filterbank_input, filterbank_stage

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
    phase_done("card and build")

    opts = MP3EncoderOptions(**MAIN_OPTIONS)
    rng = np.random.default_rng(0)
    audio = [
        bench_audio(rng, B_MAIN, T_MAIN, opts.channels, opts.sample_rate)
        for _ in range(STEPS_MAIN)
    ]
    chunk_main = filterbank_input(audio[0], dev)  # [256, 2, 128*1152]
    report = {}

    # ---- 2. K1 rate sweep vs its plain version -------------------------------
    rs = np.random.default_rng(7)
    spec = (rs.standard_normal((37, 576)) * 10 ** rs.uniform(-5, 0.5, (37, 1))).astype(np.float32)
    spec[3] = 0.0  # silent granule
    mag_s = torch.from_numpy((np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32)).to(dev)
    g_s = torch.from_numpy(rs.integers(0, 256, 37).astype(np.int32)).to(dev)
    mag_m, g_m = _sweep_inputs(chunk_main, opts, dev)
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
    ms, device_ms, host = _readings(lambda: kernels.rate_sweep(flat_m, flat_g))

    def plain_sweep():
        for s in range(0, n_main, 8192):
            kernels.rate_sweep_plain(flat_m[s : s + 8192], flat_g[s : s + 8192])

    plain_ms = cuda_ms(plain_sweep, reps=3, warmup=1)
    bound_ms, bound_by = _sweep_bound(n_main)
    report["rate_sweep"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                            "device_ms": device_ms, "host_us": host}
    print(f"[K1] rate_sweep bit-exact, both laws, N=37, FMA knife edges and N={n_main}: "
          f"{_shares(ms, device_ms, host, bound_ms)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    print(f"[K1] rate_sweep at {100 * bound_ms / ms:.1f}% of its bound, {card}", flush=True)
    phase_done("K1")

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
            ms, device_ms, host = _readings(lambda: kernels.pack(c_d, n_d, cap))
            plain_ms = cuda_ms(lambda: kernels.pack_plain(c_d, n_d, cap), reps=5)
            bound_ms, bound_by, all_ms = _pack_bound(n_d, cap)
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
    report["pack"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                      "device_ms": device_ms, "host_us": host}
    print(f"[K2] pack bit-exact at 5 shapes and vs the host packer: F=32768 P=1152 cap=894 "
          f"{_shares(ms, device_ms, host, bound_ms, all_ms)}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {card}", flush=True)
    phase_done("K2")

    # ---- 3b. K3 polyphase filterbank vs its plain version and the matmul ------
    hist_main = chunk_main[..., -480:].roll(1, dims=0).contiguous()  # nonzero history
    err = 0
    # the main path's shape, session shapes, and an LSF chunk of an odd
    # number of frames (127 x 576 samples: 2286 windows, not a multiple of 4)
    for rows, n, what in ((B_MAIN, T_MAIN * 1152, f"T={T_MAIN}"), (1, 8 * 1152, "T=8"),
                          (3, 3 * 1152, "T=3"), (B_MAIN, 127 * 576, "LSF T=127")):
        err = max(err, _check_polyphase(hist_main[:rows], chunk_main[:rows, :, :n], what))
    # the path that runs K3: the filterbank stage of tools/torch_profile_step.py
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fb = filterbank_stage(hist_main, chunk_main)
    torch.cuda.synchronize()
    k3_launches = kernels.LAUNCHES["polyphase"]
    if k3_launches <= 0:
        raise AssertionError("the filterbank stage never launched kernel polyphase")
    n_rows, n_pcm = 2 * B_MAIN, chunk_main.shape[-1]
    n_out = n_rows * (n_pcm // 32) * 32
    # read hist and pcm, write S; 16 + 64 FMAs per output
    bound_ms, bound_by = _bound(4 * (n_rows * 480 + n_rows * n_pcm + n_out), 80 * n_out)
    k3_hist, k3_pcm = hist_main.contiguous(), chunk_main.contiguous()
    k3_ms, k3_device_ms, k3_host = _readings(lambda: kernels.polyphase_subbands(k3_hist, k3_pcm))
    del k3_hist, k3_pcm
    report["polyphase"] = {"max_abs_err": err, "ms": fb["ms"], "plain_ms": fb["plain_ms"],
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": fb["library_ms"], "device_ms": k3_device_ms,
                           "host_us": k3_host}
    print(f"[K3] filterbank stage, {n_rows} rows x T={T_MAIN}, {card}: kernel {fb['ms']:.4f} ms; "
          f"alone {_shares(k3_ms, k3_device_ms, k3_host, bound_ms)}; "
          f"plain {fb['plain_ms']:.4f} ms, folded matmul {fb['matmul_ms']:.4f} ms, "
          f"conv1d {fb['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"launches {k3_launches}", flush=True)
    print(f"[K3] polyphase at {100 * bound_ms / fb['ms']:.1f}% of its bound, {card}", flush=True)
    phase_done("K3")

    # ---- 4. the main path -----------------------------------------------------
    streams, step_ms, wall_s, main_launches, main_first = _drive(opts, audio, STEPS_MAIN)
    for name in ("rate_sweep", "pack"):
        if main_launches[name] <= 0:
            raise AssertionError(f"the main path never launched kernel {name}")
    if (main_launches["rate_loop_scan"], main_launches["placement_scan"]) != (STEPS_MAIN, 0):
        raise AssertionError(f"the main path's scans over T: launches {main_launches}")
    _expect_k5(main_launches, opts, STEPS_MAIN, "main")
    _check_walks(streams, STEPS_MAIN * T_MAIN)
    decode_paths = {"main": (opts, [a[:DECODE_ROWS] for a in audio], streams[:DECODE_ROWS])}
    audio_s = B_MAIN * T_MAIN * 1152 / opts.sample_rate
    steady = statistics.median(step_ms[1:])
    print(f"[main] BatchEncoder B={B_MAIN} T={T_MAIN} x {STEPS_MAIN} steps, {card}: "
          f"step device ms {['%.2f' % t for t in step_ms]} (steady {steady:.2f} ms, "
          f"{audio_s / (steady / 1e3):.1f} audio-s/s); step+render wall s "
          f"{['%.3f' % t for t in wall_s]}; {B_MAIN} streams x {STEPS_MAIN * T_MAIN} frames "
          f"walk OK; launches {main_launches}", flush=True)
    report["rate_loop_scan"] = _check_scans(main_first, "compat", card)
    del main_first
    phase_done("main")

    # ---- 4b. the strict path ---------------------------------------------------
    s_opts = MP3EncoderOptions.spec_strict(**STRICT_OPTIONS)
    s_streams, s_step_ms, s_wall_s, s_launches, s_first = _drive(s_opts, audio, STEPS_STRICT)
    if s_launches["pack"] < STEPS_STRICT:
        raise AssertionError(f"the strict path launched pack {s_launches['pack']} times "
                             f"in {STEPS_STRICT} steps")
    if (s_launches["rate_loop_scan"], s_launches["placement_scan"]) != (STEPS_STRICT,) * 2:
        raise AssertionError(f"the strict path's scans over T: launches {s_launches}")
    k5_launches = _expect_k5(s_launches, s_opts, STEPS_STRICT, "strict")
    _check_walks(s_streams, STEPS_STRICT * T_MAIN)
    print(f"[strict] BatchEncoder spec_strict {STRICT_OPTIONS} B={B_MAIN} T={T_MAIN} x "
          f"{STEPS_STRICT} steps, {card}: step device ms {['%.2f' % t for t in s_step_ms]} "
          f"({audio_s / (s_step_ms[-1] / 1e3):.1f} audio-s/s at the last step); step+render "
          f"wall s {['%.3f' % t for t in s_wall_s]}; {B_MAIN} streams x "
          f"{STEPS_STRICT * T_MAIN} frames walk OK; launches {s_launches}", flush=True)
    decode_paths["strict"] = (s_opts, [a[:DECODE_ROWS] for a in audio], s_streams[:DECODE_ROWS])
    del s_streams
    _check_pack(s_first.pack, "strict", card)
    del s_first
    phase_done("strict")

    # ---- 4c. the hq paths ---------------------------------------------------------
    hq_opts = {p: MP3EncoderOptions.hq(**kw) for p, kw in HQ_OPTIONS.items()}
    hq_launches = {}
    for preset, steps in (("hq_joint", STEPS_HQ), ("hq_stereo", 1)):
        h_streams, h_step_ms, h_wall_s, h_launches, h_first = _drive(
            hq_opts[preset], audio, steps
        )
        if h_launches["pack"] < steps:
            raise AssertionError(f"the {preset} path launched pack {h_launches['pack']} "
                                 f"times in {steps} steps")
        if (h_launches["rate_loop_scan"], h_launches["placement_scan"]) != (steps, steps):
            raise AssertionError(f"the {preset} path's scans over T: launches {h_launches}")
        k5_launches += _expect_k5(h_launches, hq_opts[preset], steps, preset)
        _check_walks(h_streams, steps * T_MAIN)
        hq_launches[preset] = h_launches
        print(f"[{preset}] BatchEncoder hq {HQ_OPTIONS[preset]} B={B_MAIN} T={T_MAIN} x {steps} "
              f"steps, {card}: step device ms {['%.2f' % t for t in h_step_ms]} "
              f"({audio_s / (h_step_ms[-1] / 1e3):.1f} audio-s/s at the last step); step+render "
              f"wall s {['%.3f' % t for t in h_wall_s]}; {B_MAIN} streams x {steps * T_MAIN} "
              f"frames walk OK; launches {h_launches}", flush=True)
        if preset == "hq_joint":
            hq_pack = h_first.pack
            _check_scans(h_first, "hq", card)
            report["strict_sweep"] = _check_strict_sweep(h_first.strict, "hq", card)
            decode_paths[preset] = (hq_opts[preset], [a[:DECODE_ROWS] for a in audio],
                                    h_streams[:DECODE_ROWS])
        del h_streams, h_first
    _check_pack(hq_pack, "hq", card)
    print(f"[K2 hq] launches on the hq paths {({p: v['pack'] for p, v in hq_launches.items()})}",
          flush=True)
    del hq_pack
    phase_done("hq")

    # ---- 4d. serving -----------------------------------------------------------
    serve_launches = _serve(opts, card)
    _expect_k5(serve_launches, opts, SERVE_STEPS + 1, "serving")
    phase_done("serve")

    # ---- 4e. lane churn, compat at the serving shape, then hq ----------------------
    crng = np.random.default_rng(8)
    n_churn = SERVE_LANES * 3 // 2
    churn = _churn_streams(crng, n_churn, SERVE_FRAMES, opts.channels)
    # from the first cohort and from the recycled lanes (streams past the
    # first SERVE_LANES): whole, drip-fed (i % 4 == 1) and empty (i % 8 == 5)
    sample = sorted({i for i in (0, 1, 5, 6, SERVE_LANES, SERVE_LANES + 1, SERVE_LANES + 5,
                                 SERVE_LANES + 6, SERVE_LANES + 9, n_churn - 1) if i < n_churn})
    # the pipelined pool (the serving mode) against sessions; the synchronous
    # mode runs on the hq pool below
    _, steps, wall = _churn(opts, SERVE_LANES, SERVE_FRAMES, churn, True, sample)
    print(f"[serve churn] compat pool lanes={SERVE_LANES} T={SERVE_FRAMES}, {n_churn} streams "
          f"({sum(len(x) == 0 for x in churn)} empty, {n_churn // 4} drip-fed over {steps} feeding "
          f"steps), {wall:.2f} s pipelined: {len(sample)} sampled streams "
          f"({sum(i >= SERVE_LANES for i in sample)} on recycled lanes) byte-equal to card "
          f"sessions, 0 differing bytes", flush=True)
    hq_s = MP3EncoderOptions.hq(**HQ_OPTIONS["hq_stereo"])
    churn_hq = _churn_streams(np.random.default_rng(9), 12, 8, hq_s.channels)
    churn_hq[3] = np.resize(churn_hq[3], 2 * 1152 * 5)  # an exact frame multiple
    piped, _, wall = _churn(hq_s, 8, 8, churn_hq, True, range(len(churn_hq)))
    sync, _, wall_sync = _churn(hq_s, 8, 8, churn_hq, False, [])
    if sync != piped:
        raise AssertionError("the synchronous hq pool's streams differ from the pipelined pool's")
    print(f"[serve churn] hq {HQ_OPTIONS['hq_stereo']} pool lanes=8 T=8, 12 streams (window "
          f"sequencing: preroll, holdback, an exact frame multiple, drip-fed and empty streams), "
          f"{wall:.2f} s pipelined, {wall_sync:.2f} s synchronous: all 12 byte-equal to card "
          f"sessions, and the synchronous pool's to the pipelined pool's", flush=True)
    phase_done("serve churn")

    # ---- 4f. complete files: encode_corpus and the command line ---------------
    c_opts = MP3EncoderOptions(**CORPUS_OPTIONS)
    c_streams = corpus_streams() + [churn[i] for i in (0, 1)]
    tags = [ID3Tag(title=t, artist=a) for t, a in CORPUS_TAGS] + [None, ID3Tag(title="x")]
    files = encode_corpus(c_opts, c_streams, tags=tags, frames_per_step=16)
    for b, (pcm, data) in enumerate(zip(c_streams, files)):
        s = new_session(MP3EncoderOptions(**CORPUS_OPTIONS, id3_tag=tags[b]))
        audio_b = s.encode(pcm) + s.flush()
        if data != s.generate_id3_tag() + s.generate_xing_header() + audio_b:
            raise AssertionError(f"encode_corpus file {b} differs from ID3 + Xing + session bytes")
    with open(jax_path("corpus_file0"), "rb") as fh:
        ref = fh.read()
    corpus_flips = _compare_files(files[0], ref, "corpus file vs JAX")
    if corpus_flips > FIXTURE_FLIP_CEILING:
        raise AssertionError("encode_corpus file differs from the JAX package's")
    print(f"[corpus] encode_corpus {len(files)} complete files ([ID3][Xing][frames]) equal to "
          f"ID3 + Xing + session bytes on the card; file 0 against the JAX package's frozen "
          f"file: structure equal, {corpus_flips} frames differ (ceiling "
          f"{FIXTURE_FLIP_CEILING})", flush=True)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        wav, out = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.mp3")
        write_wav(wav, cli_pcm(), CLI_SIGNAL[2], CLI_SIGNAL[3])
        t0 = time.perf_counter()
        if cli.main([wav, out, *CLI_ARGS]) != 0:
            raise AssertionError("the command line failed")
        cli_s = time.perf_counter() - t0
        with open(out, "rb") as fh:
            got = fh.read()
        pcm, sr, ch = read_wav(wav)
        s = new_session(MP3EncoderOptions.hq(
            mode="mono" if ch == 1 else "stereo", sample_rate=sr, bitrate_kbps=96,
            lowpass_hz=11000, gapless_info=True, id3_tag=ID3Tag(title="Port", artist="swiftmp3"),
        ))
        audio_c = s.encode(pcm) + s.flush()
        if got != s.generate_id3_tag() + s.generate_xing_header() + audio_c:
            raise AssertionError("the command line's file differs from its session's on the card")
    with open(jax_path("cli"), "rb") as fh:
        ref = fh.read()
    cli_flips = _compare_files(got, ref, "command line vs JAX")
    cli_frames = len(_frames(_split_id3(ref)[1]))
    if cli_flips * HQ_JAX_FLIP_RATE[1] > HQ_JAX_FLIP_RATE[0] * cli_frames:
        raise AssertionError("the command line's file differs from the JAX package's")
    print(f"[cli] python -m swiftmp3_tpu_torch in.wav out.mp3 {' '.join(CLI_ARGS)} on the card "
          f"({cli_s:.2f} s): against the JAX command line's frozen file, structure equal, "
          f"{cli_flips}/{cli_frames} frames differ", flush=True)
    phase_done("corpus and cli")

    # ---- 4g. hq at 96 kbps (the adaptive lowpass), demand VBR, depth 3 -----------
    hq96 = MP3EncoderOptions.hq(**HQ_FLAG_OPTIONS["hq_joint_96k"])
    h_streams, h_step_ms, h_wall_s, h_launches, h_first = _drive(hq96, audio, STEPS_HQ96)
    if h_launches["pack"] < STEPS_HQ96:
        raise AssertionError(f"the hq96 path launched pack {h_launches['pack']} times")
    k5_launches += _expect_k5(h_launches, hq96, STEPS_HQ96, "hq96")
    _check_walks(h_streams, STEPS_HQ96 * T_MAIN, hq96)
    audio96 = B_MAIN * T_MAIN * 1152 / hq96.sample_rate
    print(f"[hq96] BatchEncoder hq {HQ_FLAG_OPTIONS['hq_joint_96k']} (lowpass_hz "
          f"{hq96.lowpass_hz}, adaptive) B={B_MAIN} T={T_MAIN} x {STEPS_HQ96} steps, {card}: "
          f"step+render wall s {['%.3f' % t for t in h_wall_s]}; {B_MAIN} streams x "
          f"{STEPS_HQ96 * T_MAIN} frames walk OK; launches {h_launches}", flush=True)
    for k, t in enumerate(h_step_ms):
        print(f"[hq96] step {k} device ms {t:.2f} ({audio96 / (t / 1e3):.1f} audio-s/s)", flush=True)
    del h_streams
    _check_pack(h_first.pack, "hq96", card)
    del h_first
    mono_audio = [a[..., 0::2].copy() for a in audio[:2]]  # bench audio is dual mono
    for preset in ("hq_vbr_demand_q5", "hq_mono_96k_depth3"):
        o = MP3EncoderOptions.hq(**HQ_FLAG_OPTIONS[preset])
        f_streams, f_step_ms, _, f_launches, f_first = _drive(o, mono_audio, 1)
        if f_launches["pack"] < 1:
            raise AssertionError(f"the {preset} path never launched pack")
        k5_launches += _expect_k5(f_launches, o, 1, preset)
        _check_walks(f_streams, T_MAIN, o)
        rates = sorted({f["bitrate_kbps"] for d in f_streams[:32] for f in walk_frames(bytes(d))})
        print(f"[hq flags] {preset} {HQ_FLAG_OPTIONS[preset]} B={B_MAIN} T={T_MAIN} x 1 step, "
              f"{card}: step device ms {f_step_ms[0]:.2f}; walks OK; bitrates in use "
              f"(32 streams) {rates}; launches {f_launches}", flush=True)
        del f_streams
        _check_pack(f_first.pack, preset, card)
        del f_first
    phase_done("hq96 and hq flags")

    k5_launches += _hq_dc(mono_audio, card)
    phase_done("hq dc")
    decode_paths["hq is"], is_k5 = _hq_is(card)
    k5_launches += is_k5
    phase_done("hq is")
    lsf_launches, decode_paths["lsf hq"] = _lsf(mono_audio, card)
    k5_launches += sum(v["strict_sweep"] for v in lsf_launches.values())
    phase_done("lsf and free format")
    _decode_phase(decode_paths, card)
    del decode_paths
    phase_done("decode")
    mesh_launches, one_card = _mesh(opts, audio, card)
    phase_done("mesh")
    multihost_launches = _multihost(opts, audio, one_card, card)
    del one_card
    phase_done("multihost")
    entry_launches = _entry_phase(card)
    phase_done("entry")

    # ---- 5. parity ---------------------------------------------------------
    fixture_flips, fixture_frames = 0, 0
    for name, kw, sig_kind, seconds, seed in COMPAT_FIXTURES:
        o = MP3EncoderOptions(**kw)
        pcm = make_signal(sig_kind, seconds, o.sample_rate, o.channels, seed)
        s = new_session(o)
        got = s.encode(pcm) + s.flush()
        with open(fixture_path(name, "tpu"), "rb") as fh:
            ref = fh.read()
        flips = _compare_streams(got, ref, name)
        fixture_flips += flips
        fixture_frames += len(_frames(ref))
        print(f"[parity] {name}: structure equal, {flips} frames differ", flush=True)
    flips = {"main": 0, "corpus": 0}
    frames = {"main": 0, "corpus": 0}
    for stem, pcm in golden_streams(audio[0]).items():
        s = new_session(opts)
        got = s.encode(pcm) + s.flush()
        with open(golden_path(stem), "rb") as fh:
            ref = fh.read()
        group = stem.split("_")[0]
        flips[group] += _compare_streams(got, ref, f"{stem} vs golden")
        frames[group] += len(_frames(ref))
    print(f"[parity] fixtures {fixture_flips}/{fixture_frames} frames differ "
          f"(ceiling {FIXTURE_FLIP_CEILING}); golden {flips['main']}/{frames['main']} "
          f"(ceiling {GOLDEN_FLIP_CEILING}); telemetry corpus vs golden "
          f"{flips['corpus']}/{frames['corpus']} (ceiling {TELEMETRY_FLIP_CEILING})", flush=True)
    if (
        fixture_flips > FIXTURE_FLIP_CEILING
        or flips["main"] > GOLDEN_FLIP_CEILING
        or flips["corpus"] > TELEMETRY_FLIP_CEILING
    ):
        raise AssertionError("byte flips above the pinned ceiling")
    s_fixture_flips, s_fixture_frames = 0, 0
    for name, kw, sig_kind, seconds, seed in STRICT_FIXTURES:
        o = MP3EncoderOptions(**kw)
        pcm = make_signal(sig_kind, seconds, o.sample_rate, o.channels, seed)
        s = new_session(o)
        got = s.encode(pcm) + s.flush()
        with open(fixture_path(name, "tpu"), "rb") as fh:
            ref = fh.read()
        f = _compare_streams(got, ref, name)
        s_fixture_flips += f
        s_fixture_frames += len(_frames(ref))
        print(f"[parity] {name}: structure equal, {f} frames differ", flush=True)
    flips = {"main": 0, "corpus": 0}
    frames = {"main": 0, "corpus": 0}
    for stem, pcm in golden_streams(audio[0]).items():
        s = new_session(s_opts)
        got = s.encode(pcm) + s.flush()
        with open(golden_path(stem, "strict"), "rb") as fh:
            ref = fh.read()
        group = stem.split("_")[0]
        flips[group] += _compare_streams(got, ref, f"{stem} vs golden strict")
        frames[group] += len(_frames(ref))
    print(f"[parity strict] fixtures {s_fixture_flips}/{s_fixture_frames} frames differ "
          f"(ceiling {STRICT_FIXTURE_FLIP_CEILING}); golden {flips['main']}/{frames['main']} "
          f"(ceiling {STRICT_GOLDEN_FLIP_CEILING}); telemetry corpus vs golden "
          f"{flips['corpus']}/{frames['corpus']} (ceiling {STRICT_TELEMETRY_FLIP_CEILING})",
          flush=True)
    if (
        s_fixture_flips > STRICT_FIXTURE_FLIP_CEILING
        or flips["main"] > STRICT_GOLDEN_FLIP_CEILING
        or flips["corpus"] > STRICT_TELEMETRY_FLIP_CEILING
    ):
        raise AssertionError("strict byte flips above the pinned ceiling")
    phase_done("parity compat and strict")
    num, den = HQ_JAX_FLIP_RATE
    for preset, o in hq_opts.items():
        flips = {"row": 0, "corpus": 0, "golden": 0}
        frames = {"row": 0, "corpus": 0}
        for stem, pcm in hq_streams().items():
            s = new_session(o)
            got = s.encode(pcm) + s.flush()
            with open(jax_path(f"{preset}_{stem}"), "rb") as fh:
                ref = fh.read()
            group = stem.split("_")[0]
            flips[group] += _compare_streams(got, ref, f"{preset} {stem} vs JAX")
            frames[group] += len(_frames(ref))
            if group == "corpus":
                with open(golden_path(stem, preset), "rb") as fh:
                    flips["golden"] += _compare_streams(got, fh.read(), f"{preset} {stem} vs golden")
        print(f"[parity {preset}] fixture rows vs JAX {flips['row']}/{frames['row']}, corpus vs "
              f"JAX {flips['corpus']}/{frames['corpus']} (ceiling rate {num}/{den}); telemetry "
              f"corpus vs golden {flips['golden']}/{frames['corpus']} (ceiling "
              f"{HQ_GOLDEN_FLIP_CEILING[preset]})", flush=True)
        if (
            flips["row"] * den > num * frames["row"]
            or flips["corpus"] * den > num * frames["corpus"]
            or flips["golden"] > HQ_GOLDEN_FLIP_CEILING[preset]
        ):
            raise AssertionError(f"{preset} byte flips above the pinned ceiling")
    phase_done("parity hq")
    for preset, kw in HQ_FLAG_OPTIONS.items():
        o = MP3EncoderOptions.hq(**kw)
        flips = {"jax": 0, "golden": 0, "cpu_fb": 0}
        n_frames = 0
        for stem, pcm in hq_flag_streams(preset).items():
            s = new_session(o)
            got = s.encode(pcm) + s.flush()
            with open(jax_path(f"{preset}_{stem}"), "rb") as fh:
                ref = fh.read()
            flips["jax"] += _compare_streams(got, ref, f"{preset} {stem} vs JAX")
            n_frames += len(_frames(ref))
            with open(golden_path(stem, preset), "rb") as fh:
                flips["golden"] += _compare_streams(got, fh.read(), f"{preset} {stem} vs golden")
            with _CpuFilterbank():
                s = new_session(o)
                got = s.encode(pcm) + s.flush()
            f = _compare_streams(got, ref, f"{preset} {stem} vs JAX, CPU filterbank")
            if f != HQ_FLAG_CPU_FILTERBANK_FLIPS.get(f"{preset}_{stem}", 0):
                raise AssertionError(f"{preset} {stem}: {f} frames differ from the JAX bytes with the "
                                     "CPU filterbank and MDCT")
            flips["cpu_fb"] += f
        ceiling = VBR_DEMAND_GOLDEN_FLIP_CEILING if preset == "hq_vbr_demand_q5" else None
        print(f"[parity hq flags] {preset}: vs JAX {flips['jax']}/{n_frames} (ceiling "
              f"{HQ_FLAG_JAX_FLIP_CEILING[preset]}), with the CPU filterbank and MDCT "
              f"{flips['cpu_fb']}/{n_frames} (the CPU session's knife edges); vs golden "
              f"{flips['golden']}/{n_frames}"
              + (f" (ceiling {ceiling})" if ceiling is not None else " (structure)"), flush=True)
        if flips["jax"] > HQ_FLAG_JAX_FLIP_CEILING[preset] or (
            ceiling is not None and flips["golden"] > ceiling
        ):
            raise AssertionError(f"{preset} byte flips above the pinned ceiling")
    phase_done("parity hq flags")
    _parity_dc_is()
    phase_done("parity dc is")
    _parity_lsf()
    phase_done("parity lsf")

    # ---- 6. result lines ----------------------------------------------------
    rows = [
        ("rate_sweep", "swiftmp3_tpu_torch/ops/csrc/rate_sweep.cu",
         "swiftmp3_tpu/ops/pallas_kernels.py:347"),
        ("pack", "swiftmp3_tpu_torch/ops/csrc/pack.cu",
         "swiftmp3_tpu/ops/pallas_kernels.py:237"),
        ("polyphase", "swiftmp3_tpu_torch/ops/csrc/polyphase.cu",
         "swiftmp3_tpu/ops/pallas_kernels.py:77"),
        ("rate_loop_scan", "swiftmp3_tpu_torch/ops/csrc/rate_loop_scan.cu",
         "none: the Phase 2 lax.scan of swiftmp3_tpu/models/pipeline.py"),
        ("strict_sweep", "swiftmp3_tpu_torch/ops/csrc/strict_sweep.cu",
         "none: the strict sweep in XLA, swiftmp3_tpu/ops/dsp.py:1604-1736"),
    ]
    # K1 and K2 counted on the main path, the serving pool, the LSF and
    # free-format paths, the mesh runs, the two processes and the graft
    # entry, K3 on the filterbank stage
    launches = {
        n: main_launches[n] + serve_launches[n] + sum(v[n] for v in lsf_launches.values())
        + mesh_launches[n] + multihost_launches[n] + entry_launches[n]
        for n in ("rate_sweep", "pack")
    }
    launches["polyphase"] = k3_launches
    # K4's two entry points on the main, strict, hq, serving, LSF and mesh paths
    launches["rate_loop_scan"] = sum(
        main_launches[n] + s_launches[n] + sum(v[n] for v in hq_launches.values())
        + serve_launches[n] + sum(v[n] for v in lsf_launches.values()) + mesh_launches[n]
        for n in ("rate_loop_scan", "placement_scan")
    )
    # K5 on the strict, hq, hq96, hq flag, dc, IS and LSF paths (0 on the
    # main, serving and mesh paths, each checked)
    launches["strict_sweep"] = k5_launches + mesh_launches["strict_sweep"]
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
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(_multihost_worker(*sys.argv[2:5]))
    sys.exit(main())

"""Batched multi-stream encoding on one device or over a data mesh (twin of
`swiftmp3_tpu.parallel.batch`).

`BatchEncoder` encodes B independent streams in lockstep: PCM rides as
batch-major [B, T, frame] chunks, the chunk program runs on the device, and
the packed outputs render to bytes through the port's native renderer, one
call a range of streams reading the packed host buffer in place
(`swiftmp3_tpu_torch.native.lib.render_batch`, each stream's state a
`NativeStreamRenderer`). `reset_lanes` recycles finished lanes for new
streams (the serving layer, `parallel.pool.StreamPool`). Pinned host
buffers with non-blocking copies stand in for the JAX version's
`device_put` and `copy_to_host_async`, so uploads and downloads overlap
other work.

Given a mesh (`parallel.mesh`), the batch is cut into one contiguous span a
mesh position; each position holds its rows' carry on its own device and
runs the chunk program on them, dispatched in position order from the one
host thread, and the positions' outputs render as one batch, in row order.

`encode_batch` encodes a list of streams, each as one session would;
`encode_corpus` makes complete files of them ([ID3][Xing][frames]);
`encode_batch_multihost` encodes each process's own streams over a mesh
that spans processes.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from ..encoder import GAPLESS_DECODER_DELAY, GAPLESS_ENCODER_DELAY
from ..io.id3 import build_id3_tag
from ..io.xing import build_xing_header
from ..models.pipeline import (
    init_carry,
    main_data_cap,
    make_chunk_fn,
    max_frame_bytes,
    meta_layout,
    resolve_device,
)
from ..native import NativeStreamRenderer
from ..native.lib import BATCH_FIELDS, check_written, render_batch
from ..options import SAMPLES_PER_GRANULE, MP3EncoderOptions
from ..utils import profiling
from ..utils.profiling import annotate
from .mesh import (
    carry_sharding,
    make_mesh,
    process_batch_bounds,
    process_count,
    put_global,
    to_device,
)


class BatchEncoder:
    """Encode a fixed-size batch of streams on `device` (the card by default)
    with one chunk program, or with `mesh` over its positions (`device` is
    then unused; `batch` is the global batch, which must divide evenly over
    the mesh, and the encoder holds, takes and renders this process's
    `process_batch_bounds` rows: all of them in one process). The outputs of
    a step stay readable until `drain` is called on them; several steps may
    be in flight.

    Host rendering runs the native C++ renderer (a failed build raises): one
    call a range of rows, at most render_threads (default: the cores, at
    most 8) ranges in parallel."""

    def __init__(
        self,
        options: MP3EncoderOptions,
        batch: int,
        frames_per_step: int,
        device="cuda",
        render_threads: int | None = None,
        mesh=None,
    ):
        self._run = make_chunk_fn(options)
        self.options = options
        self.batch = batch
        self.frames_per_step = frames_per_step
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            spans = [(self.device, 0, batch)]
            rows = batch
        else:
            self.device = None
            lo, hi = process_batch_bounds(mesh, batch)
            rows = hi - lo
            spans = carry_sharding(mesh).spans(rows)
        self._spans = spans  # (device, lo, hi) of each local position's rows
        if render_threads is None:
            render_threads = min(os.cpu_count() or 1, 8)
        self._pool = (
            ThreadPoolExecutor(max_workers=render_threads)
            if render_threads > 1 and rows > 1
            else None
        )
        self._render_threads = render_threads
        self._carries = [init_carry(hi - lo, options, dev) for dev, lo, hi in spans]
        self._init = None  # the fresh carries reset_lanes selects from, built once
        self.renderers = [NativeStreamRenderer(options) for _ in range(rows)]
        # the packed output's frame as the native render reads it: main_data
        # to the cap, then the meta fields' words
        layout = meta_layout(options)
        meta_words = sum(n for _, n in layout.values())
        self._cap = main_data_cap(options)
        self._frame_stride = self._cap + 4 * meta_words
        self._layout = np.array([layout[f][0] for f in BATCH_FIELDS] + [meta_words], dtype=np.int32)
        self._frame_bytes = max_frame_bytes(options)  # a frame's most bytes out
        self._arena = None  # the render's output, a row a stream, reused drain to drain

    @property
    def carry(self) -> dict:
        """The carry of this process's rows, batch-leading (with a mesh, the
        positions' carries joined in position order on the first one's
        device)."""
        if len(self._carries) == 1:
            return self._carries[0]
        first = self._carries[0]
        return {
            k: torch.cat([c[k].to(first[k].device) for c in self._carries]) for k in first
        }

    def close(self) -> None:
        """Release the render thread pool (idempotent; drain then renders
        serially)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _put(self, arr):
        """Upload a batch-leading input: a tensor, or with a mesh a list of
        tensors, one a local position."""
        if self.mesh is None:
            return to_device(arr, self.device)
        if isinstance(arr, list):
            return arr
        return put_global(self.mesh, arr)

    def _parts(self, arr) -> list:
        """A batch-leading input as one tensor a local position."""
        return self._put(arr) if self.mesh is not None else [self._put(arr)]

    def prepare(
        self, pcm: np.ndarray, final: np.ndarray, valid: np.ndarray, lookahead=None
    ):
        """Start the host->device upload of a chunk's inputs; pass the
        result to step() so the transfer overlaps other work."""
        with annotate("batch.prepare"):
            out = (self._put(pcm), self._put(final), self._put(valid))
            if lookahead is not None:
                out = out + (self._put(lookahead),)
            return out

    def step(self, pcm, final, valid, lookahead=None) -> dict:
        """Run one chunk. pcm: [B, T, 1152*ch] float32 or int16 (normalized
        by 1/32768 on the device); final/valid: [B, T] bool. Accepts numpy
        arrays or the tensors from prepare(). Under window_sequencing,
        `lookahead` [B, T, 576*ch] is required: each frame's next raw
        granule, zeros past a stream's end. Returns the outputs, their
        device->host copy already in flight (with a mesh of several local
        positions, {"parts": one output a position})."""
        with annotate("batch.step"):
            n = len(self._spans)
            la = [None] * n
            if self.options.window_sequencing:
                if lookahead is None:
                    raise ValueError(
                        "window_sequencing needs the per-frame lookahead chunk "
                        "[B, T, 576*ch] (each frame's next raw granule)"
                    )
                la = self._parts(lookahead)
            pcm, final, valid = self._parts(pcm), self._parts(final), self._parts(valid)
            parts = []
            for k, (dev, _, _) in enumerate(self._spans):
                self._carries[k], outs = self._run(
                    self._carries[k], pcm[k], final[k], valid[k], la[k]
                )
                parts.append(self._fetch(outs["packed"], dev))
            return parts[0] if n == 1 else {"parts": parts}

    @staticmethod
    def _fetch(packed: torch.Tensor, device: torch.device) -> dict:
        """Start the copy of a position's packed output to pinned host
        memory behind an event (on the CPU, the tensor itself)."""
        with annotate("batch.fetch"):
            if device.type != "cuda":
                return {"packed": packed}
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
            return {"packed": host, "ready": ready}

    def reset_lanes(self, lanes) -> None:
        """Give the masked lanes a fresh stream's state: the device carry of
        init_carry and a new renderer (continuous batching: a finished
        stream's lane takes the next stream). lanes: [B] bool. Unmasked
        lanes keep their carry bit for bit; an all-False mask does nothing.
        The select is queued on the device after every step already queued
        and rebinds the carry, so no queued step reads a tensor it
        writes."""
        mask = np.asarray(lanes, dtype=bool)
        if not mask.any():
            return
        if self._init is None:
            self._init = [init_carry(hi - lo, self.options, dev) for dev, lo, hi in self._spans]
        for k, (dev, lo, hi) in enumerate(self._spans):
            if not mask[lo:hi].any():
                continue
            m = to_device(mask[lo:hi], dev)
            init = self._init[k]
            self._carries[k] = {
                key: torch.where(m.view((hi - lo,) + (1,) * (v.dim() - 1)), init[key], v)
                for key, v in self._carries[k].items()
            }
        for b in np.flatnonzero(mask).tolist():
            self.renderers[b] = NativeStreamRenderer(self.options)

    def drain(self, outs: dict, valid: np.ndarray) -> List[bytes]:
        """Render one chunk's outputs to bytes per stream (ranges of streams
        render in parallel; the native renderer runs without the interpreter
        lock)."""
        with annotate("batch.drain"):
            parts = outs["parts"] if "parts" in outs else [outs]
            with annotate("drain.wait"):
                for p in parts:
                    if "ready" in p:
                        p["ready"].synchronize()
            with annotate("drain.render"):
                return self._render(parts, valid)

    def _render(self, parts: list, valid: np.ndarray) -> List[bytes]:
        """drain's host half, once the copies have landed: the rows split
        into at most render_threads contiguous ranges, one native call a
        range (`native.render_batch`) reading the packed output in place.
        Traced, the render counts its pool's size (`render.threads`), its
        native calls (`render.native_calls`) and their time
        (`render.busy_ns`, summed over the pool's threads)."""
        traced = profiling.enabled()
        if traced:
            threads = self._render_threads if self._pool is not None else 1
            profiling.count("render.threads", threads)
        valid = np.asarray(valid)
        B, T = valid.shape
        if B != len(self.renderers):
            raise ValueError(f"valid has {B} rows; the encoder renders {len(self.renderers)}")
        packed, rows = [], []
        for p in parts:
            p = torch.as_tensor(p["packed"])
            if p.device.type != "cpu" or p.dtype != torch.uint8 or p.shape[1:] != (T, self._frame_stride):
                raise ValueError(
                    f"packed output {tuple(p.shape)} {p.dtype} on {p.device}: expected host "
                    f"uint8 [rows, {T}, {self._frame_stride}]"
                )
            p = p.contiguous()
            packed.append(p)  # held until the calls return
            rows.append(np.arange(p.shape[0], dtype=np.uintp) * p.stride(0) + p.data_ptr())
        rows = np.concatenate(rows)
        states = np.array([r.handle for r in self.renderers], dtype=np.uintp)
        counts = valid.sum(axis=1, dtype=np.int32)  # valid is a prefix along T
        slot = T * self._frame_bytes
        if self._arena is None or self._arena.shape != (B, slot):
            self._arena = np.empty((B, slot), dtype=np.uint8)
        arena = self._arena
        sizes = np.empty((B, T), dtype=np.int32)
        written = np.empty(B, dtype=np.int64)
        emitted = np.empty(B, dtype=np.int32)
        calls = min(self._render_threads, B) if self._pool is not None else 1  # the pool: B > 1
        edges = [B * k // calls for k in range(calls + 1)]

        def render_range(k: int) -> int:
            lo, hi = edges[k], edges[k + 1]
            t0 = time.perf_counter_ns()
            render_batch(
                states[lo:hi], rows[lo:hi], counts[lo:hi], self._cap, self._frame_stride,
                self._layout, arena[lo:hi], sizes[lo:hi], written[lo:hi], emitted[lo:hi],
            )
            return time.perf_counter_ns() - t0

        busy = [render_range(0)] if calls == 1 else list(self._pool.map(render_range, range(calls)))
        if traced:
            profiling.count("render.native_calls", calls)
            profiling.count("render.busy_ns", sum(busy))
        failed = np.flatnonzero(written < 0)
        if failed.size:
            check_written(int(written[failed[0]]))
        out = []
        for b, r in enumerate(self.renderers):
            r.frame_sizes.extend(sizes[b, : emitted[b]].tolist())
            out.append(arena[b, : written[b]].tobytes())
        return out

    def flush(self) -> List[bytes]:
        return [r.flush_buffered() for r in self.renderers]


class _Chunks:
    """The chunk inputs of a list of streams in `rows` batch rows (rows past
    the streams are empty): as many frames a stream as one session encodes,
    int16 transport when every stream is int16, and the session's is_final
    rule. Under window_sequencing each nonempty stream is delayed by one
    granule (the session's encoder delay) and each frame gets its lookahead
    granule from the delayed stream."""

    def __init__(self, options: MP3EncoderOptions, streams: Sequence, rows: int, frames_per_step: int):
        ch = options.channels
        self.frame_len = options.samples_per_frame * ch  # 1152 (MPEG-1) / 576 (LSF)
        self.la_len = SAMPLES_PER_GRANULE * ch if options.window_sequencing else 0
        if self.la_len:
            streams = [
                np.concatenate([np.zeros(self.la_len, dtype=np.asarray(s).dtype), np.asarray(s)])
                if len(s)
                else np.asarray(s)  # an empty stream stays empty (session parity)
                for s in streams
            ]
        self.streams = streams
        self.rows = rows
        self.Tc = frames_per_step
        self.lengths = np.array([len(s) for s in streams], dtype=np.int64)
        self.rem = self.lengths % self.frame_len
        self.n_frames = np.zeros(rows, dtype=np.int64)
        self.n_frames[: len(streams)] = self.lengths // self.frame_len + (self.rem > 0)
        # int16 streams ride raw (the device normalizes by 1/32768); mixed
        # dtypes ride as float32
        self.pcm_dtype = (
            np.int16
            if len(streams) and all(np.asarray(s).dtype == np.int16 for s in streams)
            else np.float32
        )

    @property
    def frames(self) -> int:
        """The most frames of any stream."""
        return int(self.n_frames.max()) if self.rows else 0

    def _segment(self, b: int, lo: int, hi: int) -> np.ndarray:
        seg = np.asarray(self.streams[b][lo:hi])
        if seg.dtype == np.int16 and self.pcm_dtype == np.float32:
            seg = seg.astype(np.float32) / np.float32(32768.0)
        return seg

    def build(self, start: int, t_total: int):
        """(pcm, final, valid, lookahead or None) of the chunk of frames
        [start, start + Tc), t_total frames in all."""
        with annotate("batch.build"):
            return self._build(start, t_total)

    def _build(self, start: int, t_total: int):
        B, Tc, fl, la_len = self.rows, self.Tc, self.frame_len, self.la_len
        count = min(Tc, t_total - start)
        pcm = np.zeros((B, Tc, fl), dtype=self.pcm_dtype)
        t_idx = start + np.arange(Tc, dtype=np.int64)
        valid = t_idx[None, :] < self.n_frames[:, None]
        final = np.zeros((B, Tc), dtype=bool)
        for b in range(len(self.streams)):
            length, n_frames = int(self.lengths[b]), int(self.n_frames[b])
            lo = start * fl
            hi = min((start + count) * fl, length)
            if hi > lo:
                nrows = (hi - lo + fl - 1) // fl
                buf = np.zeros(nrows * fl, dtype=self.pcm_dtype)
                buf[: hi - lo] = self._segment(b, lo, hi)
                pcm[b, :nrows] = buf.reshape(nrows, fl)
            # session flush parity: a partial last frame is final, and under
            # window_sequencing (whose delay makes the flush emit at least
            # one frame) every nonempty stream's last frame is
            if (self.rem[b] or (la_len and length)) and start <= n_frames - 1 < start + Tc:
                final[b, n_frames - 1 - start] = True
        if not la_len:
            return pcm, final, valid, None
        la = np.zeros((B, Tc, la_len), dtype=self.pcm_dtype)
        for b in range(len(self.streams)):
            for t in range(count):
                lo = (start + t + 1) * fl
                hi = min(lo + la_len, int(self.lengths[b]))
                if hi > lo:
                    la[b, t, : hi - lo] = self._segment(b, lo, hi)
        return pcm, final, valid, la


def _encode_chunks(enc: BatchEncoder, chunks: _Chunks, t_total: int, n_streams: int) -> List[bytes]:
    """Run every chunk through `enc` as a 3-stage software pipeline (chunk k
    computes while chunk k+1 uploads and chunk k-1 renders), then flush;
    returns the bytes of the first n_streams rows."""
    out = [bytearray() for _ in range(n_streams)]

    def render(pending) -> None:
        for b, chunk in enumerate(enc.drain(*pending)[:n_streams]):
            out[b] += chunk

    starts = list(range(0, t_total, chunks.Tc))
    pending = prepared = None
    if starts:
        pcm, final, valid, la = chunks.build(starts[0], t_total)
        prepared, prepared_valid = enc.prepare(pcm, final, valid, la), valid
    for idx in range(len(starts)):
        outs = enc.step(*prepared)
        cur_valid = prepared_valid
        if idx + 1 < len(starts):
            pcm, final, valid, la = chunks.build(starts[idx + 1], t_total)
            prepared, prepared_valid = enc.prepare(pcm, final, valid, la), valid
        if pending is not None:
            render(pending)
        pending = (outs, cur_valid)
    if pending is not None:
        render(pending)
    for b, tail in enumerate(enc.flush()[:n_streams]):
        out[b] += tail
    return [bytes(o) for o in out]


def encode_batch(
    options: MP3EncoderOptions,
    streams: Sequence[np.ndarray],
    device="cuda",
    frames_per_step: int = 64,
    mesh=None,
    use_mesh: bool = False,
    _return_encoder: bool = False,
):
    """Encode N independent PCM streams on `device` (the card by default),
    or over `mesh` (use_mesh without one: make_mesh(), every card); returns
    MP3 bytes per stream. Equivalent to one session per stream (encode +
    flush); streams may differ in length. Over a mesh the batch is padded
    with empty rows to a multiple of its size. With _return_encoder, returns
    (bytes per stream, the BatchEncoder), whose renderers hold each stream's
    frame count, byte count and frame sizes."""
    if use_mesh and mesh is None:
        mesh = make_mesh()
    n_streams = len(streams)
    if options.gapless_info:
        # EncoderSession.flush parity: each nonempty stream's tail grows by
        # delay + 529 zeros, so every real sample lands in an emitted frame
        tail = (GAPLESS_ENCODER_DELAY + GAPLESS_DECODER_DELAY) * options.channels
        streams = [
            np.concatenate([np.asarray(s), np.zeros(tail, dtype=np.asarray(s).dtype)])
            if len(s)
            else np.asarray(s)
            for s in streams
        ]
    if not n_streams:
        return ([], None) if _return_encoder else []
    B = n_streams
    if mesh is not None:
        B = -(-n_streams // mesh.size) * mesh.size
    chunks = _Chunks(options, streams, B, frames_per_step)
    with annotate("batch.setup"):
        enc = BatchEncoder(options, B, frames_per_step, device, mesh=mesh)
    try:
        result = _encode_chunks(enc, chunks, chunks.frames, n_streams)
    finally:
        enc.close()
    return (result, enc) if _return_encoder else result


def encode_batch_multihost(
    options: MP3EncoderOptions,
    local_streams: Sequence[np.ndarray],
    frames_per_step: int = 64,
    mesh=None,
) -> List[bytes]:
    """Multi-process twin of encode_batch (default mesh: make_mesh(), every
    card of every process).

    Under a process group (`parallel.mesh.initialize_multihost`) every
    process calls this with ITS OWN list of streams, the same count in
    every process. The mesh cuts the combined batch over all processes'
    positions; each process feeds only its `process_batch_bounds` span,
    runs it on its own positions, and renders only its own streams. The one
    collective is the longest stream's frame count, gathered over the group
    so every process runs the same number of steps. Returns this process's
    MP3 byte streams, in local_streams order. In one process it is
    encode_batch over the mesh.

    As in the reference, gapless_info adds no tail here (encode_batch and
    sessions add delay + 529 zeros), so under it the streams differ from
    sessions.
    """
    if mesh is None:
        mesh = make_mesh()
    n_proc = process_count()
    local_dev = mesh.size // n_proc
    n_local = len(local_streams)
    B_local = max(-(-n_local // local_dev) * local_dev, local_dev)
    B_global = B_local * n_proc
    lo, hi = process_batch_bounds(mesh, B_global)
    if hi - lo != B_local:
        raise ValueError(
            f"this process holds {hi - lo} rows of the mesh's {B_global}, not {B_local}: "
            "every process needs the same number of mesh positions"
        )
    chunks = _Chunks(options, local_streams, B_local, frames_per_step)
    t_total = chunks.frames
    if n_proc > 1:
        mine = torch.tensor([t_total], dtype=torch.int64)
        every = [torch.zeros_like(mine) for _ in range(n_proc)]
        torch.distributed.all_gather(every, mine)
        t_total = int(max(int(t) for t in every))
    with annotate("batch.setup"):
        enc = BatchEncoder(options, B_global, frames_per_step, mesh=mesh)
    try:
        return _encode_chunks(enc, chunks, t_total, n_local)
    finally:
        enc.close()


def encode_corpus(
    options: MP3EncoderOptions,
    streams: Sequence[np.ndarray],
    tags=None,
    device="cuda",
    frames_per_step: int = 64,
    mesh=None,
) -> List[bytes]:
    """Encode N streams on `device` (the card by default) or over `mesh`
    into complete MP3 files: per stream [ID3v2.3 tag][Xing/Info
    header][frames], the batched file-encode mode (twin of
    batch.encode_corpus). `tags`: an optional ID3Tag per stream, else
    options.id3_tag for every one."""
    frames, enc = encode_batch(
        options, streams, device, frames_per_step=frames_per_step, mesh=mesh,
        _return_encoder=True,
    )
    files = []
    with annotate("corpus.files"):
        for b, audio in enumerate(frames):
            r = enc.renderers[b]
            tag = tags[b] if tags else options.id3_tag
            id3 = build_id3_tag(tag) if tag else b""
            xing = build_xing_header(options, r.frame_count, r.total_bytes, r.frame_sizes)
            files.append(id3 + xing + audio)
    return files

"""Batched multi-stream encoding on one device (twin of
`swiftmp3_tpu.parallel.batch`, without the mesh).

`BatchEncoder` encodes B independent streams in lockstep: PCM rides as
batch-major [B, T, frame] chunks, the chunk program runs on the device, and
each stream's packed outputs render to bytes through the port's native
renderer (`swiftmp3_tpu_torch.native.NativeStreamRenderer`), or with
`use_native=False` through the Python `FrameAssembler`, the behavioural
reference. `reset_lanes` recycles finished lanes for new streams (the
serving layer, `parallel.pool.StreamPool`). Pinned host buffers with
non-blocking copies stand in for the JAX version's `device_put` and
`copy_to_host_async`, so uploads and downloads overlap other work.

`encode_batch` encodes a list of streams, each as one session would;
`encode_corpus` makes complete files of them ([ID3][Xing][frames]).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from ..encoder import GAPLESS_DECODER_DELAY, GAPLESS_ENCODER_DELAY
from ..io.framing import FrameAssembler
from ..io.id3 import build_id3_tag
from ..io.xing import build_xing_header
from ..models.pipeline import (
    fetch_outputs,
    frame_results_from_outputs,
    init_carry,
    make_chunk_fn,
    resolve_device,
)
from ..native import NativeStreamRenderer
from ..options import SAMPLES_PER_GRANULE, MP3EncoderOptions


class BatchEncoder:
    """Encode a fixed-size batch of streams on `device` (the card by default)
    with one chunk program. The outputs of a step stay readable until
    `drain` is called on them; several steps may be in flight.

    Host rendering runs the native C++ renderer (a failed build raises), or
    with use_native=False the Python FrameAssembler; both give the same
    bytes. render_threads (default: the cores, at most 8) render streams in
    parallel."""

    def __init__(
        self,
        options: MP3EncoderOptions,
        batch: int,
        frames_per_step: int,
        device="cuda",
        use_native: bool = True,
        render_threads: int | None = None,
    ):
        self._run = make_chunk_fn(options)
        self.options = options
        self.batch = batch
        self.frames_per_step = frames_per_step
        self.device = resolve_device(device)
        self._pinned = self.device.type == "cuda"
        if render_threads is None:
            render_threads = min(os.cpu_count() or 1, 8)
        self._pool = (
            ThreadPoolExecutor(max_workers=render_threads)
            if render_threads > 1 and batch > 1
            else None
        )
        self.carry = init_carry(batch, options, self.device)
        self._init = None  # the fresh carry reset_lanes selects from, built once
        self.use_native = use_native
        # each stream's renderer: NativeStreamRenderer, or FrameAssembler
        self.renderers = [self._renderer() for _ in range(batch)]

    def _renderer(self):
        renderer = NativeStreamRenderer if self.use_native else FrameAssembler
        return renderer(self.options)

    def close(self) -> None:
        """Release the render thread pool (idempotent; drain then renders
        serially)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _put(self, arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._pinned:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def prepare(
        self, pcm: np.ndarray, final: np.ndarray, valid: np.ndarray, lookahead=None
    ):
        """Start the host->device upload of a chunk's inputs; pass the
        result to step() so the transfer overlaps other work."""
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
        device->host copy already in flight."""
        la = None
        if self.options.window_sequencing:
            if lookahead is None:
                raise ValueError(
                    "window_sequencing needs the per-frame lookahead chunk "
                    "[B, T, 576*ch] (each frame's next raw granule)"
                )
            la = self._put(lookahead)
        self.carry, outs = self._run(
            self.carry, self._put(pcm), self._put(final), self._put(valid), la
        )
        packed = outs["packed"]
        if not self._pinned:
            return {"packed": packed}
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return {"packed": host, "ready": ready}

    def reset_lanes(self, lanes) -> None:
        """Give the masked lanes a fresh stream's state: the device carry of
        init_carry and a new renderer (continuous batching: a finished
        stream's lane takes the next stream). lanes: [B] bool. Unmasked
        lanes keep their carry bit for bit; an all-False mask does nothing.
        The select is queued on the device after every step already queued
        and rebinds self.carry, so no queued step reads a tensor it
        writes."""
        mask = np.asarray(lanes, dtype=bool)
        if not mask.any():
            return
        if self._init is None:
            self._init = init_carry(self.batch, self.options, self.device)
        m = self._put(mask)
        self.carry = {
            k: torch.where(m.view((self.batch,) + (1,) * (v.dim() - 1)), self._init[k], v)
            for k, v in self.carry.items()
        }
        for b in np.flatnonzero(mask).tolist():
            self.renderers[b] = self._renderer()

    def drain(self, outs: dict, valid: np.ndarray) -> List[bytes]:
        """Render one chunk's outputs to bytes per stream (streams render in
        parallel; the native renderer runs without the interpreter lock)."""
        if "ready" in outs:
            outs["ready"].synchronize()
        outs = fetch_outputs(outs, self.options)
        valid = np.asarray(valid)
        if not self.use_native:
            emitted = [bytearray() for _ in range(self.batch)]
            for t in range(valid.shape[1]):
                for b in range(self.batch):
                    if valid[b, t]:
                        fr = frame_results_from_outputs(outs, self.options, t, b)
                        emitted[b] += self.renderers[b].push(fr)
            return [bytes(e) for e in emitted]
        counts = valid.sum(axis=1)  # valid is a prefix along T

        def render_one(b: int) -> bytes:
            F = int(counts[b])
            return self.renderers[b].render_packed(
                outs["bitrate_index"][b, :F],
                outs["padding"][b, :F],
                outs["mdb"][b, :F],
                outs["slot"][b, :F],
                outs["part23"][b, :F],
                outs["big_values"][b, :F],
                outs["gain"][b, :F],
                outs["block_type"][b, :F],
                outs["preflag"][b, :F],
                outs["region0"][b, :F],
                outs["region1"][b, :F],
                outs["subblock_gain"][b, :F],
                outs["main_data"][b, :F],
                outs["hb"][b, :F],
                table_select=outs["table_select"][b, :F],
                count1table=outs["count1table"][b, :F],
                scalefac_compress=outs["scalefac_compress"][b, :F],
                scfsi=outs["scfsi"][b, :F],
                mode_ext=outs["mode_ext"][b, :F],
            )

        if self._pool is None:
            return [render_one(b) for b in range(self.batch)]
        return list(self._pool.map(render_one, range(self.batch)))

    def flush(self) -> List[bytes]:
        return [r.flush_buffered() for r in self.renderers]


def encode_batch(
    options: MP3EncoderOptions,
    streams: Sequence[np.ndarray],
    device="cuda",
    frames_per_step: int = 64,
    _return_encoder: bool = False,
):
    """Encode N independent PCM streams on `device` (the card by default);
    returns MP3 bytes per stream. Equivalent to one session per stream
    (encode + flush); streams may differ in length (twin of
    batch.encode_batch without the mesh). With _return_encoder, returns
    (bytes per stream, the BatchEncoder), whose renderers hold each stream's
    frame count, byte count and frame sizes."""
    n_streams = len(streams)
    ch = options.channels
    frame_len = options.samples_per_frame * ch
    if options.gapless_info:
        tail = (GAPLESS_ENCODER_DELAY + GAPLESS_DECODER_DELAY) * ch
        streams = [
            np.concatenate([np.asarray(s), np.zeros(tail, dtype=np.asarray(s).dtype)])
            if len(s)
            else np.asarray(s)
            for s in streams
        ]
    la_len = SAMPLES_PER_GRANULE * ch if options.window_sequencing else 0
    if la_len:
        # window_sequencing: the session's one granule of encoder delay; each
        # frame's lookahead granule comes from the delayed stream
        streams = [
            np.concatenate([np.zeros(la_len, dtype=np.asarray(s).dtype), np.asarray(s)])
            if len(s)
            else np.asarray(s)
            for s in streams
        ]
    B = n_streams
    lengths = np.array([len(s) for s in streams], dtype=np.int64)
    rem = lengths % frame_len
    n_frames = lengths // frame_len + (rem > 0)
    T_total = int(n_frames.max()) if n_streams else 0
    Tc = frames_per_step
    pcm_dtype = (
        np.int16
        if n_streams and all(np.asarray(s).dtype == np.int16 for s in streams)
        else np.float32
    )

    def segment(b: int, lo: int, hi: int) -> np.ndarray:
        seg = np.asarray(streams[b][lo:hi])
        if seg.dtype == np.int16 and pcm_dtype == np.float32:
            seg = seg.astype(np.float32) / np.float32(32768.0)
        return seg

    def build_chunk(start: int):
        count = min(Tc, T_total - start)
        pcm = np.zeros((B, Tc, frame_len), dtype=pcm_dtype)
        t_idx = start + np.arange(Tc, dtype=np.int64)
        valid = t_idx[None, :] < n_frames[:, None]
        final = np.zeros((B, Tc), dtype=bool)
        for b in range(n_streams):
            lo = start * frame_len
            hi = min((start + count) * frame_len, int(lengths[b]))
            if hi > lo:
                nrows = (hi - lo + frame_len - 1) // frame_len
                buf = np.zeros(nrows * frame_len, dtype=pcm_dtype)
                buf[: hi - lo] = segment(b, lo, hi)
                pcm[b, :nrows] = buf.reshape(nrows, frame_len)
            # session flush parity: a partial last frame is final, and under
            # window_sequencing (whose delay makes the flush emit at least
            # one frame) every nonempty stream's last frame is
            if (rem[b] or (la_len and lengths[b])) and start <= n_frames[b] - 1 < start + Tc:
                final[b, int(n_frames[b] - 1 - start)] = True
        if not la_len:
            return pcm, final, valid, None
        la = np.zeros((B, Tc, la_len), dtype=pcm_dtype)
        for b in range(n_streams):
            for t in range(count):
                lo = (start + t + 1) * frame_len
                hi = min(lo + la_len, int(lengths[b]))
                if hi > lo:
                    la[b, t, : hi - lo] = segment(b, lo, hi)
        return pcm, final, valid, la

    out = [bytearray() for _ in range(n_streams)]
    if not n_streams:
        return ([], None) if _return_encoder else []
    enc = BatchEncoder(options, B, frames_per_step, device)
    try:
        # 3-stage software pipeline: chunk k computes while chunk k+1
        # uploads and chunk k-1 renders
        starts = list(range(0, T_total, Tc))
        pending = None
        prepared = None
        if starts:
            pcm, final, valid, la = build_chunk(starts[0])
            prepared, prepared_valid = enc.prepare(pcm, final, valid, la), valid
        for idx in range(len(starts)):
            outs = enc.step(*prepared)
            cur_valid = prepared_valid
            if idx + 1 < len(starts):
                pcm, final, valid, la = build_chunk(starts[idx + 1])
                prepared, prepared_valid = enc.prepare(pcm, final, valid, la), valid
            if pending is not None:
                for b, chunk in enumerate(enc.drain(*pending)):
                    out[b] += chunk
            pending = (outs, cur_valid)
        if pending is not None:
            for b, chunk in enumerate(enc.drain(*pending)):
                out[b] += chunk
        for b, tail in enumerate(enc.flush()):
            out[b] += tail
    finally:
        enc.close()
    result = [bytes(o) for o in out]
    return (result, enc) if _return_encoder else result


def encode_corpus(
    options: MP3EncoderOptions,
    streams: Sequence[np.ndarray],
    tags=None,
    device="cuda",
    frames_per_step: int = 64,
) -> List[bytes]:
    """Encode N streams on `device` (the card by default) into complete MP3
    files: per stream [ID3v2.3 tag][Xing/Info header][frames], the batched
    file-encode mode (twin of batch.encode_corpus without the mesh). `tags`:
    an optional ID3Tag per stream, else options.id3_tag for every one."""
    frames, enc = encode_batch(
        options, streams, device, frames_per_step=frames_per_step, _return_encoder=True
    )
    files = []
    for b, audio in enumerate(frames):
        r = enc.renderers[b]
        tag = tags[b] if tags else options.id3_tag
        id3 = build_id3_tag(tag) if tag else b""
        xing = build_xing_header(options, r.frame_count, r.total_bytes, r.frame_sizes)
        files.append(id3 + xing + audio)
    return files

"""Batched multi-stream encoding on one device (twin of
`swiftmp3_tpu.parallel.batch`, without the mesh).

`BatchEncoder` encodes B independent streams in lockstep: PCM rides as
batch-major [B, T, frame] chunks, the chunk program runs on the device, and
each stream's packed outputs render to bytes through the shared native
renderer (`swiftmp3_tpu.native.NativeStreamRenderer`). Pinned host buffers
with non-blocking copies stand in for the JAX version's `device_put` and
`copy_to_host_async`, so uploads and downloads overlap other work.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from swiftmp3_tpu.native import NativeStreamRenderer, native_available
from swiftmp3_tpu.options import MP3EncoderOptions

from ..models.pipeline import fetch_outputs, init_carry, make_chunk_fn


class BatchEncoder:
    """Encode a fixed-size batch of streams on `device` with one chunk
    program. The outputs of a step stay readable until `drain` is called on
    them; several steps may be in flight."""

    def __init__(
        self, options: MP3EncoderOptions, batch: int, frames_per_step: int, device
    ):
        self._run = make_chunk_fn(options)
        if not native_available():
            raise RuntimeError(
                "the native frame renderer (swiftmp3_tpu/native) failed to build"
            )
        self.options = options
        self.batch = batch
        self.frames_per_step = frames_per_step
        self.device = torch.device(device)
        self._pinned = self.device.type == "cuda"
        render_threads = min(os.cpu_count() or 1, 8)
        self._pool = (
            ThreadPoolExecutor(max_workers=render_threads)
            if render_threads > 1 and batch > 1
            else None
        )
        self.carry = init_carry(batch, options, self.device)
        self.renderers = [NativeStreamRenderer(options) for _ in range(batch)]

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

    def prepare(self, pcm: np.ndarray, final: np.ndarray, valid: np.ndarray):
        """Start the host->device upload of a chunk's inputs; pass the
        result to step() so the transfer overlaps other work."""
        return self._put(pcm), self._put(final), self._put(valid)

    def step(self, pcm, final, valid) -> dict:
        """Run one chunk. pcm: [B, T, 1152*ch] float32 or int16 (normalized
        by 1/32768 on the device); final/valid: [B, T] bool. Accepts numpy
        arrays or the tensors from prepare(). Returns the outputs, their
        device->host copy already in flight."""
        self.carry, outs = self._run(
            self.carry, self._put(pcm), self._put(final), self._put(valid)
        )
        packed = outs["packed"]
        if not self._pinned:
            return {"packed": packed}
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return {"packed": host, "ready": ready}

    def drain(self, outs: dict, valid: np.ndarray) -> List[bytes]:
        """Render one chunk's outputs to bytes per stream (streams render in
        parallel; the native renderer runs without the interpreter lock)."""
        if "ready" in outs:
            outs["ready"].synchronize()
        outs = fetch_outputs(outs, self.options)
        counts = np.asarray(valid).sum(axis=1)  # valid is a prefix along T

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
    device,
    frames_per_step: int = 64,
) -> List[bytes]:
    """Encode N independent PCM streams on `device`; returns MP3 bytes per
    stream. Equivalent to one session per stream (encode + flush); streams
    may differ in length (twin of batch.encode_batch without the mesh)."""
    n_streams = len(streams)
    ch = options.channels
    frame_len = options.samples_per_frame * ch
    if options.gapless_info:
        from swiftmp3_tpu.encoder import GAPLESS_DECODER_DELAY, GAPLESS_ENCODER_DELAY

        tail = (GAPLESS_ENCODER_DELAY + GAPLESS_DECODER_DELAY) * ch
        streams = [
            np.concatenate([np.asarray(s), np.zeros(tail, dtype=np.asarray(s).dtype)])
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
                seg = np.asarray(streams[b][lo:hi])
                if seg.dtype == np.int16 and pcm_dtype == np.float32:
                    seg = seg.astype(np.float32) / np.float32(32768.0)
                nrows = (hi - lo + frame_len - 1) // frame_len
                buf = np.zeros(nrows * frame_len, dtype=pcm_dtype)
                buf[: hi - lo] = seg
                pcm[b, :nrows] = buf.reshape(nrows, frame_len)
            # session flush parity: only a PARTIAL last frame is final
            if rem[b] and start <= n_frames[b] - 1 < start + Tc:
                final[b, int(n_frames[b] - 1 - start)] = True
        return pcm, final, valid

    out = [bytearray() for _ in range(n_streams)]
    if not n_streams:
        return []
    enc = BatchEncoder(options, B, frames_per_step, device)
    try:
        # 3-stage software pipeline: chunk k computes while chunk k+1
        # uploads and chunk k-1 renders
        starts = list(range(0, T_total, Tc))
        pending = None
        prepared = None
        if starts:
            pcm, final, valid = build_chunk(starts[0])
            prepared, prepared_valid = enc.prepare(pcm, final, valid), valid
        for idx in range(len(starts)):
            outs = enc.step(*prepared)
            cur_valid = prepared_valid
            if idx + 1 < len(starts):
                pcm, final, valid = build_chunk(starts[idx + 1])
                prepared, prepared_valid = enc.prepare(pcm, final, valid), valid
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
    return [bytes(o) for o in out]

"""Continuous-batching serving layer on one device or over a data mesh
(twin of `swiftmp3_tpu.parallel.pool`): streams join and leave a
fixed-lane device batch at any time.

`BatchEncoder` (batch.py) encodes a fixed cohort of streams in lockstep —
right for corpus jobs, wrong for serving, where streams arrive and end
independently. `StreamPool` multiplexes an open-ended set of streams onto
B device lanes:

    pool = StreamPool(options, lanes=8, frames_per_step=4)  # device="cuda"
    sid = pool.submit()              # open a stream
    pool.feed(sid, pcm_chunk)        # append PCM (any length, any count)
    pool.close(sid)                  # no more PCM
    pool.step()                      # run one device chunk (call in a loop)
    if pool.done(sid):
        data = pool.result(sid)      # the finished MP3 byte stream
        pool.release(sid)            # drop its buffers (long-running servers)

Each lane carries one stream's device state (filterbank history, MDCT
overlap, reservoir mirrors — the same carry pytree as a single session);
when a stream's final frame is emitted the lane is reset
(`BatchEncoder.reset_lanes`) and recycled for the next waiting stream.
Lanes with no work run with all-False `valid` masks, which freeze their
carry bit-for-bit (the pipeline's prefix-valid contract).

Byte-exactness: a stream's output is identical to encoding it alone with
the port's session (`encoder.new_session`) on the same device — pinned by
tests/test_torch_pool.py against staggered arrivals, mixed lengths, and lane
reuse. int16 feeds stay int16 up to the device (half the host->device
transfer; the chunk program normalizes by 1/32768, which is exact in
float32, so bytes are identical to the float path).

step() software-pipelines one chunk deep by default (pipelined=True): the
current chunk is DISPATCHED first (BatchEncoder.step queues the upload and
the chunk program on the CUDA stream, then the copy of its packed output
into pinned host memory behind an event), then the PREVIOUS chunk's
outputs — by then finished or nearly so — are waited for, rendered, and its
finished lanes recycled (BatchEncoder.reset_lanes, queued after the new
chunk). Device compute, the host<->device transfers, and host rendering
overlap across successive step() calls, like encode_batch's 3-stage
pipeline. The cost is one step of latency: a chunk's bytes (and
done()/finished() flips) appear on the NEXT step() call, and a lane freed by
a finishing stream is re-assigned one step later. pipelined=False restores
strictly synchronous semantics; bytes are identical either way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..encoder import GAPLESS_DECODER_DELAY, GAPLESS_ENCODER_DELAY
from ..io.xing import build_xing_header
from ..options import MP3EncoderOptions, SAMPLES_PER_GRANULE
from .batch import BatchEncoder


class _ChunkBuffer:
    """Append-only-at-back, consume-at-front sample buffer.

    Keeps fed chunks as a list (no O(n^2) re-concatenation on small feeds)
    and tracks dtype: all-int16 feeds stay int16; any float feed upgrades
    the whole stream to float32 (exactly int16/32768, so bytes match)."""

    def __init__(self):
        self._chunks: List[np.ndarray] = []
        self._len = 0
        self.is_int16 = True

    def __len__(self) -> int:
        return self._len

    def append(self, arr: np.ndarray) -> None:
        if arr.dtype != np.int16:
            if self.is_int16:
                self.is_int16 = False
                self._chunks = [
                    c.astype(np.float32) / np.float32(32768.0) for c in self._chunks
                ]
        elif not self.is_int16:
            arr = arr.astype(np.float32) / np.float32(32768.0)
        self._chunks.append(arr)
        self._len += len(arr)

    def peek(self, n: int) -> np.ndarray:
        """Return (a copy of) the first min(n, len) samples, non-destructively
        (window_sequencing lookahead: the next granule is read one step
        before it is consumed)."""
        out, got = [], 0
        for c in self._chunks:
            if got >= n:
                break
            take = min(len(c), n - got)
            out.append(c[:take])
            got += take
        dt = np.int16 if self.is_int16 else np.float32
        if not out:
            return np.zeros(0, dtype=dt)
        return np.concatenate(out) if len(out) > 1 else out[0].copy()

    def pop(self, n: int) -> np.ndarray:
        """Remove and return the first n samples (n <= len)."""
        out, got = [], 0
        while got < n:
            c = self._chunks[0]
            take = min(len(c), n - got)
            out.append(c[:take])
            if take == len(c):
                self._chunks.pop(0)
            else:
                self._chunks[0] = c[take:]
            got += take
        self._len -= n
        dt = np.int16 if self.is_int16 else np.float32
        if not out:
            return np.zeros(0, dtype=dt)
        return np.concatenate(out) if len(out) > 1 else out[0]


@dataclass
class _Stream:
    sid: int
    buffer: _ChunkBuffer = field(default_factory=_ChunkBuffer)
    closed: bool = False
    lane: Optional[int] = None
    out: bytearray = field(default_factory=bytearray)
    done: bool = False
    frames: int = 0
    frame_sizes: Optional[List[int]] = None  # snapshot at finish (Xing)
    fed: bool = False  # any real PCM received (window_sequencing preroll)
    fed_samples: int = 0  # interleaved samples received (gapless_info)


class StreamPool:
    """Continuous batching over a fixed number of lanes on `device` (the
    card by default; "cpu" runs the chunk program's plain versions), or with
    `mesh` over its positions (the lanes cut evenly over them; `device` is
    then unused)."""

    def __init__(
        self,
        options: MP3EncoderOptions = None,
        lanes: int = 8,
        frames_per_step: int = 4,
        device="cuda",
        pipelined: bool = True,
        mesh=None,
    ):
        self.options = options if options is not None else MP3EncoderOptions()
        self.lanes = lanes
        self.T = frames_per_step
        self.pipelined = pipelined
        self.enc = BatchEncoder(self.options, lanes, frames_per_step, device, mesh=mesh)
        self._streams: Dict[int, _Stream] = {}
        self._lane_owner: List[Optional[int]] = [None] * lanes
        self._waiting: List[int] = []  # sids with no lane yet (FIFO)
        self._next_sid = 0
        self._n = self.options.samples_per_frame * self.options.channels
        # window_sequencing: one granule of encoder delay per stream
        # (preroll zeros on first feed) + per-frame lookahead in the chunk
        self._la_n = (
            SAMPLES_PER_GRANULE * self.options.channels
            if self.options.window_sequencing
            else 0
        )
        # in-flight chunk awaiting drain: (outs, valid, active, finishing)
        self._pending = None

    # ---- stream lifecycle -------------------------------------------------

    def submit(self) -> int:
        """Open a new stream; returns its id. Feed PCM with feed()."""
        sid = self._next_sid
        self._next_sid += 1
        self._streams[sid] = _Stream(sid)
        self._waiting.append(sid)
        return sid

    def feed(self, sid: int, pcm) -> None:
        """Append interleaved PCM samples (float in [-1, 1] or int16; int16
        stays int16 through the device transport). Non-finite samples are
        zeroed (EncoderSession parity)."""
        s = self._streams[sid]
        if s.closed:
            raise ValueError(f"stream {sid} is closed")
        arr = np.asarray(pcm)
        if arr.dtype == np.int16:
            arr = arr.reshape(-1)
        else:
            arr = arr.astype(np.float32).reshape(-1)
            if not np.isfinite(arr).all():
                arr = np.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0)
        if self._la_n and not s.fed and len(arr):
            # window_sequencing encoder delay (EncoderSession parity: the
            # preroll is dropped when a stream is closed without PCM)
            s.buffer.append(np.zeros(self._la_n, dtype=arr.dtype))
            s.fed = True
        s.fed_samples += len(arr)
        s.buffer.append(arr)

    def close(self, sid: int) -> None:
        """Mark the stream complete; its tail is zero-padded to a full
        frame and flagged final (EncoderSession flush semantics). Under
        options.gapless_info the tail is first extended by delay+529 zeros
        (EncoderSession.flush parity) so every real sample lands inside an
        emitted frame with the end-trim margin gapless players need."""
        s = self._streams[sid]
        if self.options.gapless_info and s.fed_samples and not s.closed:
            tail = (
                GAPLESS_ENCODER_DELAY + GAPLESS_DECODER_DELAY
            ) * self.options.channels
            s.buffer.append(np.zeros(tail, dtype=np.int16))
        s.closed = True

    def done(self, sid: int) -> bool:
        return self._streams[sid].done

    def result(self, sid: int) -> bytes:
        """The finished MP3 bytes; raises if the stream is not done.
        Long-running servers should release(sid) afterwards."""
        s = self._streams[sid]
        if not s.done:
            raise ValueError(f"stream {sid} is not finished")
        return bytes(s.out)

    def release(self, sid: int) -> None:
        """Drop a finished stream's state (bytes, counters). Without this,
        finished streams accumulate for the pool's lifetime."""
        s = self._streams[sid]
        if not s.done:
            raise ValueError(f"stream {sid} is not finished")
        del self._streams[sid]

    def frame_count(self, sid: int) -> int:
        return self._streams[sid].frames

    def xing_header(self, sid: int) -> bytes:
        """Xing/Info frame (frame count, byte count, 100-byte seek TOC)
        for a finished stream — prepend it to result() like
        EncoderSession.generate_xing_header()."""
        s = self._streams[sid]
        if not s.done:
            raise ValueError(f"stream {sid} is not finished")
        sizes = s.frame_sizes or []
        gapless = None
        if self.options.gapless_info:
            delay = GAPLESS_ENCODER_DELAY + (
                SAMPLES_PER_GRANULE if self._la_n else 0
            )
            per_ch = s.fed_samples // self.options.channels
            gapless = (
                delay,
                max(len(sizes) * self.options.samples_per_frame - delay - per_ch, 0),
            )
        return build_xing_header(
            self.options, len(sizes), sum(sizes), sizes, gapless=gapless
        )

    def shutdown(self) -> None:
        """Drain any in-flight chunk and release the render thread pool
        (finished streams stay readable)."""
        if self._pending is not None:
            self._drain_pending()
        self.enc.close()

    def finished(self) -> List[int]:
        """ids of done streams not yet released (poll after step())."""
        return [sid for sid, s in self._streams.items() if s.done]

    def buffered_samples(self, sid: int) -> int:
        """Samples fed but not yet consumed (ingest back-pressure signal)."""
        return len(self._streams[sid].buffer)

    @property
    def busy_lanes(self) -> int:
        return sum(o is not None for o in self._lane_owner)

    @property
    def idle(self) -> bool:
        """True when no lane has work, nothing is waiting, and no chunk is
        in flight."""
        return (
            all(o is None for o in self._lane_owner)
            and not self._waiting
            and self._pending is None
        )

    # ---- scheduling -------------------------------------------------------

    def _assign_lanes(self) -> int:
        assigned = 0
        for lane in range(self.lanes):
            if self._lane_owner[lane] is not None or not self._waiting:
                continue
            sid = self._waiting.pop(0)
            self._lane_owner[lane] = sid
            self._streams[sid].lane = lane
            assigned += 1
        return assigned

    def _lane_chunk(self, s: _Stream, pcm_row: np.ndarray, la_row=None):
        """Fill pcm_row [T, n] (and la_row [T, la_n] under
        window_sequencing) and return (final [T], valid [T], consumed,
        finishing). EncoderSession parity: `final` is raised ONLY on a
        zero-padded partial tail frame (a stream ending exactly on a frame
        boundary encodes its last frame unflagged, like flush()); an open
        stream only emits the whole frames it has buffered — and, under
        window_sequencing, only frames whose lookahead granule has also
        arrived (the session's holdback rule)."""
        T, n = self.T, self._n
        la_n = self._la_n
        if la_n and not s.closed:
            avail_frames = max(len(s.buffer) - la_n, 0) // n
        else:
            avail_frames = len(s.buffer) // n
        tail = len(s.buffer) - avail_frames * n if s.closed else 0
        final = np.zeros(T, dtype=bool)
        valid = np.zeros(T, dtype=bool)
        emit = min(avail_frames, T)
        consumed = emit * n
        if emit:
            data = s.buffer.pop(consumed)
            pcm_row[:emit] = data.reshape(emit, n)
            valid[:emit] = True
            if la_n:
                for t in range(emit - 1):
                    la_row[t] = data[(t + 1) * n : (t + 1) * n + la_n]
                peek = s.buffer.peek(la_n)
                la_row[emit - 1, : len(peek)] = peek
        if s.closed and tail and emit == avail_frames and emit < T:
            # the padded isFinal frame (EncoderSession.flush); its
            # lookahead is silence, and the frame BEFORE it sees the
            # padded tail via the peek above
            pcm_row[emit, :tail] = s.buffer.pop(tail)
            valid[emit] = True
            final[emit] = True
            consumed += tail
        elif (
            la_n and s.closed and emit and emit == avail_frames
            and len(s.buffer) == 0
        ):
            # sequenced stream whose delayed length is an exact frame
            # multiple: the session's flush still flags its held-back last
            # frame is_final (the delay guarantees a flush emission)
            final[emit - 1] = True
        finishing = s.closed and len(s.buffer) == 0
        return final, valid, consumed, finishing

    def step(self) -> int:
        """Assign waiting streams to free lanes, dispatch one device chunk,
        and (pipelined) drain the PREVIOUS chunk — routing its rendered
        bytes and recycling its finished lanes — while the new chunk
        computes. Returns a progress count (frames encoded + streams
        finished + lanes assigned); 0 means this step did nothing and an
        identical next step would too."""
        progress = self._assign_lanes()
        B, T, n = self.lanes, self.T, self._n
        active = [
            (lane, self._streams[sid])
            for lane, sid in enumerate(self._lane_owner)
            if sid is not None
        ]
        # int16 end-to-end when every active stream's buffer is int16
        all_i16 = bool(active) and all(s.buffer.is_int16 for _, s in active)
        dt = np.int16 if all_i16 else np.float32
        pcm = np.zeros((B, T, n), dtype=dt)
        la = (
            np.zeros((B, T, self._la_n), dtype=dt) if self._la_n else None
        )
        final = np.zeros((B, T), dtype=bool)
        valid = np.zeros((B, T), dtype=bool)
        finishing: Dict[int, bool] = {}
        for lane, s in active:
            row = pcm[lane]
            la_row = la[lane] if la is not None else None
            if not all_i16 and s.buffer.is_int16 and len(s.buffer):
                # mixed-dtype step: normalize this lane's int16 on host
                fin, val, cons, fini = self._lane_chunk_f32(s, row, la_row)
            else:
                fin, val, cons, fini = self._lane_chunk(s, row, la_row)
            final[lane], valid[lane] = fin, val
            finishing[lane] = fini

        outs = (
            self.enc.step(pcm, final, valid, lookahead=la)
            if valid.any()
            else None
        )

        # Drain the previous chunk AFTER dispatching this one: its device
        # outputs are ready (or nearly), and the new chunk computes while
        # the host fetches/renders. Its bytes precede this chunk's, so the
        # per-stream byte order is unchanged.
        if self._pending is not None:
            progress += self._drain_pending()

        if outs is not None:
            # dispatched frames count as progress NOW (they drain next
            # step under pipelining; counting at drain would make the
            # first pipelined step look like a stall)
            progress += int(valid.sum())
            self._pending = (outs, valid, active, finishing)
            if not self.pipelined:
                progress += self._drain_pending()
        elif any(finishing.values()):
            # no device work this step, but closed streams whose buffers
            # drained earlier still finish (previous chunk drained above,
            # so the renderer state is complete)
            progress += self._finish_lanes(active, finishing)
        return progress

    def _drain_pending(self) -> int:
        outs, valid, active, finishing = self._pending
        self._pending = None
        rendered = self.enc.drain(outs, valid)
        for lane, s in active:
            s.out += rendered[lane]
            s.frames += int(valid[lane].sum())
        return self._finish_lanes(active, finishing)

    def _finish_lanes(self, active, finishing) -> int:
        progress = 0
        reset_mask = np.zeros(self.lanes, dtype=bool)
        for lane, s in active:
            if finishing.get(lane) and not s.done:
                # the one-frame delay: flush the lane's buffered last frame
                s.out += self.enc.renderers[lane].flush_buffered()
                s.frame_sizes = list(self.enc.renderers[lane].frame_sizes)
                s.done = True
                self._lane_owner[lane] = None
                s.lane = None
                reset_mask[lane] = True
                progress += 1
        self.enc.reset_lanes(reset_mask)
        return progress

    def _lane_chunk_f32(self, s: _Stream, pcm_row: np.ndarray, la_row=None):
        """_lane_chunk for an int16-buffered stream in a float32 step: the
        int16 samples assign into the float row (exact cast), then the
        valid frames normalize by 1/32768 (exact; session parity)."""
        fin, val, cons, fini = self._lane_chunk(s, pcm_row, la_row)
        nf = int(val.sum())
        if nf:
            pcm_row[:nf] /= np.float32(32768.0)
            if la_row is not None:
                la_row[:nf] /= np.float32(32768.0)
        return fin, val, cons, fini

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Convenience: step until every submitted stream is done. Raises
        immediately on a stalled pool (e.g. a stream that was never closed
        and lacks a full frame: no step can make progress)."""
        for _ in range(max_steps):
            if self.idle:
                return
            if self.step() == 0:
                stalled = [
                    sid
                    for sid in self._lane_owner
                    if sid is not None and not self._streams[sid].closed
                ]
                raise RuntimeError(
                    "StreamPool stalled: no lane can make progress "
                    f"(open streams holding lanes: {stalled} — feed more "
                    "PCM or close() them)"
                )
        raise RuntimeError("run_until_idle: step budget exhausted")

"""Public encoder API of the port: `new_session`, `EncoderSession` and
`MP3Encoder` (twin of `swiftmp3_tpu.encoder`, reference API parity).

The session (PCM buffering, flush, the host frame assembler, checkpoints,
ID3/Xing) is the reference package's `EncoderSession`, copied; it takes its
backend object directly: a `TorchBackend`, the PyTorch chunk program on one
device. There is no golden backend here: the golden numpy encoder stays the
reference's, and only the tests run it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .io.framing import FrameAssembler
from .io.id3 import build_id3_tag
from .io.xing import build_xing_header
from .models.pipeline import TorchBackend, carry_from_jax, carry_to_jax
from .options import SAMPLES_PER_GRANULE, MP3EncoderOptions

__all__ = [
    "EncoderSession",
    "MP3Encoder",
    "new_session",
    "TorchBackend",
    "carry_from_jax",
    "carry_to_jax",
    "GAPLESS_ENCODER_DELAY",
    "GAPLESS_DECODER_DELAY",
]

# Gapless bookkeeping (options.gapless_info). The family pipeline delays
# audio by a structural 528 samples (polyphase filterbank + MDCT phase:
# measured as a 1057-sample total source->decode latency through libmpg123,
# minus the standard 529-sample decoder synthesis delay); window_sequencing
# adds its explicit one-granule preroll on top. The LAME info tag's delay
# field carries the encoder part only — players skip delay + 529.
GAPLESS_ENCODER_DELAY = 528
GAPLESS_DECODER_DELAY = 529


def new_session(options: MP3EncoderOptions, device="cuda") -> "EncoderSession":
    """A fresh encoder session running the port on `device` (the card by
    default; pass "cpu" for the CPU). Raises RuntimeError for a CUDA device
    when no card is present."""
    return EncoderSession(options, TorchBackend(options, device))


class EncoderSession:
    """Mutable per-stream encoding state (MP3Encoder.swift:237-350)."""

    def __init__(self, options: MP3EncoderOptions, backend):
        self.options = options
        self.assembler = FrameAssembler(options)
        self.backend = backend
        # window_sequencing: one granule of encoder delay (the START
        # decision needs one granule of lookahead) — the stream starts
        # with 576 samples of silence, like every lookahead encoder.
        self._la_n = (
            SAMPLES_PER_GRANULE * options.channels
            if options.window_sequencing
            else 0
        )
        self._pcm = np.zeros(self._la_n, dtype=np.float32)
        self._fed = False  # any real PCM received (empty flush stays empty)
        self._fed_samples = 0  # interleaved samples received (gapless_info)

    @property
    def encoded_frame_count(self) -> int:
        return self.assembler.frame_count

    @property
    def encoded_byte_count(self) -> int:
        return self.assembler.total_bytes

    def encode(self, samples) -> bytes:
        """Buffer interleaved PCM and encode all complete frames (1152
        samples each for MPEG-1; 576 at LSF rates — one granule per frame).

        Accepts float PCM in [-1, 1] or int16 PCM (normalized by 1/32768).
        Non-finite samples are zeroed (the reference would trap on them;
        a deterministic stream is strictly more useful)."""
        arr = np.asarray(samples)
        if arr.dtype == np.int16:
            samples = arr.astype(np.float32).reshape(-1) / np.float32(32768.0)
        else:
            samples = arr.astype(np.float32).reshape(-1)
        if not np.isfinite(samples).all():
            samples = np.nan_to_num(samples, nan=0.0, posinf=0.0, neginf=0.0)
        if samples.size:
            self._fed = True
            self._fed_samples += int(samples.size)
        self._pcm = np.concatenate([self._pcm, samples]) if self._pcm.size else samples
        n = self.options.samples_per_frame * self.options.channels
        # with window_sequencing, a frame is emitted only once its
        # lookahead granule has arrived (encode_frames needs it)
        n_frames = max(len(self._pcm) - self._la_n, 0) // n
        if n_frames == 0:
            return b""
        frames = self._pcm[: n_frames * n].reshape(n_frames, n)
        lookahead = None
        if self._la_n:
            lookahead = np.stack(
                [
                    self._pcm[(i + 1) * n : (i + 1) * n + self._la_n]
                    for i in range(n_frames)
                ]
            )
        self._pcm = self._pcm[n_frames * n :]
        results = self.backend.encode_frames(
            frames, np.zeros(n_frames, dtype=bool), lookahead=lookahead
        )
        out = bytearray()
        for fr in results:
            out += self.assembler.push(fr)
        return bytes(out)

    def flush(self) -> bytes:
        """Encode any partial frame (zero-padded, reservoir borrowing off) and
        emit the delayed buffered frame."""
        out = bytearray()
        n = self.options.samples_per_frame * self.options.channels
        if self._la_n and not self._fed:
            # nothing was ever encoded; don't emit the delay preroll alone
            self._pcm = np.zeros(0, dtype=np.float32)
        if self._fed and self.options.gapless_info:
            # gapless_info: cover the tail. The pipeline's structural
            # 528-sample encoder delay means the last input samples live in
            # a frame flush would otherwise never emit; appending
            # delay + 529 zeros puts every real sample inside an emitted
            # frame AND leaves >= 529 samples of padding so gapless players
            # can trim the decoder's own synthesis delay at the end
            # (padding fields: generate_xing_header).
            tail = (GAPLESS_ENCODER_DELAY + GAPLESS_DECODER_DELAY) * self.options.channels
            self._pcm = np.concatenate(
                [self._pcm, np.zeros(tail, dtype=np.float32)]
            )
        if self._pcm.size:
            # with window_sequencing the held-back delay tail can span two
            # frames; the final frame's lookahead is silence
            k = (len(self._pcm) + n - 1) // n
            buf = np.zeros(k * n, dtype=np.float32)
            buf[: len(self._pcm)] = self._pcm
            self._pcm = np.zeros(0, dtype=np.float32)
            frames = buf.reshape(k, n)
            lookahead = None
            if self._la_n:
                lookahead = np.zeros((k, self._la_n), dtype=np.float32)
                for i in range(k - 1):
                    lookahead[i] = frames[i + 1][: self._la_n]
            is_final = np.zeros(k, dtype=bool)
            is_final[-1] = True
            results = self.backend.encode_frames(
                frames, is_final, lookahead=lookahead
            )
            for fr in results:
                out += self.assembler.push(fr)
        out += self.assembler.flush_buffered()
        self.backend.notify_flush()
        return bytes(out)

    # --- Checkpoint / resume -------------------------------------------------
    # The reference's closest analogue is that copying the session value type
    # snapshots all state (SURVEY.md §5). Here the state is explicit: the
    # backend's carry + the assembler's byte-level state. The layout is the
    # JAX session's, so checkpoints cross between the two packages.

    def state_dict(self) -> dict:
        """Snapshot all session state as plain numpy arrays / bytes."""
        a = self.assembler
        state = {
            "pcm": self._pcm.copy(),
            "fed": self._fed,
            "fed_samples": self._fed_samples,
            "reservoir_stream": bytes(a.reservoir.stream),
            "reservoir_avail": a.reservoir.available_bytes,
            "buffered_heads": [h for h, _ in a._buffered],
            "buffered_slots": [s for _, s in a._buffered],
            "frame_count": a.frame_count,
            "total_bytes": a.total_bytes,
            "frame_sizes": list(a.frame_sizes),
            "backend": self.backend.state_dict(),
        }
        return state

    def load_state_dict(self, state: dict) -> None:
        a = self.assembler
        self._pcm = np.asarray(state["pcm"], dtype=np.float32).copy()
        self._fed = bool(state.get("fed", True))
        self._fed_samples = int(state.get("fed_samples", 0))
        a.reservoir.stream = bytearray(state["reservoir_stream"])
        a.reservoir.available_bytes = int(state["reservoir_avail"])
        if "buffered_heads" in state:
            a._buffered = [
                (bytes(h), int(s))
                for h, s in zip(state["buffered_heads"], state["buffered_slots"])
            ]
        elif int(state.get("buffered_slot", -1)) >= 0:  # pre-depth checkpoint
            a._buffered = [
                (bytes(state["buffered_head"]), int(state["buffered_slot"]))
            ]
        else:
            a._buffered = []
        a.frame_count = int(state["frame_count"])
        a.total_bytes = int(state["total_bytes"])
        a.frame_sizes = list(state["frame_sizes"])
        self.backend.load_state_dict(state["backend"])

    def generate_id3_tag(self) -> bytes:
        if self.options.id3_tag is None:
            return b""
        return build_id3_tag(self.options.id3_tag)

    def generate_xing_header(self) -> bytes:
        gapless = None
        if self.options.gapless_info:
            delay = GAPLESS_ENCODER_DELAY + (
                SAMPLES_PER_GRANULE if self._la_n else 0
            )
            per_ch = self._fed_samples // self.options.channels
            padding = (
                self.assembler.frame_count * self.options.samples_per_frame
                - delay
                - per_ch
            )
            gapless = (delay, max(padding, 0))
        return build_xing_header(
            self.options,
            self.assembler.frame_count,
            self.assembler.total_bytes,
            self.assembler.frame_sizes,
            gapless=gapless,
        )


class MP3Encoder:
    """Stateless encoder facade (MP3Encoder.swift:132-145); its sessions run
    on `device` (the card by default)."""

    def __init__(self, options: Optional[MP3EncoderOptions] = None, device="cuda"):
        self.options = options if options is not None else MP3EncoderOptions()
        self.device = device

    def new_session(self) -> EncoderSession:
        return new_session(self.options, self.device)

    def encode(self, input):
        """Async streaming encode: yields MP3 data chunks; no Xing header
        (MP3Encoder.swift:151-179). `input` is an (a)sync iterable of
        interleaved PCM buffers."""
        from .streaming import encode_stream

        return encode_stream(self, input)

    async def encode_to_file(self, input, path) -> None:
        """Incremental file encode with ID3 + Xing header
        (MP3Encoder.swift:189-230)."""
        from .streaming import encode_to_file

        await encode_to_file(self, input, path)

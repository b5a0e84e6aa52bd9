"""Host frame assembly: header, CRC, reservoir splice, one-frame delay.

This is the variable-length half of the encoder. A backend (numpy golden or
the TPU pipeline) produces per-frame `FrameResult`s — fixed-shape integers and
quantized spectra; this module renders bytes with the exact reference state
machine (MP3Encoder.swift:465-568):

- Huffman bytes are appended to a contiguous reservoir stream;
- frame N's *header* is built now, but its main-data slot is filled (from the
  stream front) and emitted only on frame N+1 (one-frame delay);
- `main_data_begin` was snapshotted by the backend *before* encoding N;
- CRC-16, when enabled, covers only the 4 header bytes (reference quirk).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..options import MP3EncoderOptions
from ..tables import mode_bits, sample_rate_index
from .bitwriter import BitstreamWriter
from .crc import crc16_mpeg
from .huffman_pack import pack_chunks, pack_frame_main_data
from .sideinfo import build_side_info, build_side_info_lsf


@dataclass
class FrameResult:
    """Fixed-shape outputs of encoding one frame (device or golden backend).

    Either `main_data` (device-packed Huffman bytes) or `quantized` +
    `big_values` (host packs) must be provided.
    """

    bitrate_index: int
    padding: int
    main_data_begin: int  # reservoir snapshot before this frame's encode
    slot_size: int  # mainDataSize = frame - header - crc - side info
    granules: list  # [2][channels] of GranuleInfo
    quantized: Optional[np.ndarray] = None  # [2*ch, 576], granule-major
    big_values: Optional[np.ndarray] = None  # [2*ch]
    main_data: Optional[bytes] = None  # pre-packed Huffman bytes (device)
    chunks: Optional[np.ndarray] = None  # spec-strict layout chunk stream
    nbits: Optional[np.ndarray] = None  # (reference.strict_entropy_layout)
    scfsi: Optional[list] = None  # [channels][4] side-info bits (options.scfsi)
    mode_ext: Optional[int] = None  # per-frame header mode_extension override
    #   (options.iso_mode_ext; None -> the mode's constant)


class BitReservoir:
    """Contiguous Huffman byte stream + borrowing counter
    (MP3Encoder.swift:2087-2128). `cap` is the main_data_begin field reach:
    511 bytes (9 bits, MPEG-1) or 255 (8 bits, LSF)."""

    def __init__(self, cap: int = 511) -> None:
        self.stream = bytearray()
        self.available_bytes = 0
        self.cap = cap

    @property
    def main_data_begin(self) -> int:
        return min(len(self.stream), self.cap)

    def append(self, data: bytes) -> None:
        self.stream += data

    def fill_slot(self, slot_size: int, tail_bytes: int = 0) -> bytes:
        """Pop `slot_size` bytes. When the stream underruns, stuffing zeros
        are inserted; `tail_bytes` (aligned reservoir mode) is the length of
        the most recently appended frame's data, which is kept at the slot
        TAIL so the next frame's main_data_begin can point at it — stuffing
        lands between frames' data, where ISO permits ancillary bytes.
        tail_bytes=0 reproduces the reference's end-padding (compat mode).

        At most `cap` (511/255) of the newest frame's bytes may precede its
        header (main_data_begin field width); when tail_bytes > cap the
        remainder is KEPT in the stream and spills into the frame's own
        slot — stuffing still lands before the frame's data start, never
        inside it. (Without this, high-bitrate linbits frames with > 511
        data bytes tail-aligned deeper than mdb can express — silent
        corruption at >= 192 kbps; mirrored in encoder.py/pipeline.py
        stream_len floors and the C++ renderer.)"""
        keep = max(tail_bytes - self.cap, 0)
        avail = len(self.stream) - keep
        if avail >= slot_size:
            slot = bytes(self.stream[:slot_size])
            del self.stream[:slot_size]
            return slot
        pad = slot_size - avail
        tail_in = min(tail_bytes, self.cap, avail)
        cut = avail - tail_in
        slot = (
            bytes(self.stream[:cut]) + bytes(pad) + bytes(self.stream[cut:avail])
        )
        del self.stream[:avail]
        return slot

    def update(self, huffman_bytes: int, slot_size: int) -> None:
        self.available_bytes = min(
            max(self.available_bytes + slot_size - huffman_bytes, 0), self.cap
        )


class FrameAssembler:
    """Turns FrameResults into the emitted MP3 byte stream."""

    def __init__(self, options: MP3EncoderOptions, reservoir: Optional[BitReservoir] = None):
        self.options = options
        self.reservoir = (
            reservoir if reservoir is not None
            else BitReservoir(cap=options.reservoir_cap)
        )
        # FIFO of (header+sideinfo, slot) pairs awaiting emission; length
        # bounded by options.reservoir_depth (1 = the reference's one-frame
        # delay). Deeper delays extend a frame's main_data back-reach to
        # min(511, depth slots) — see options.reservoir_depth.
        self._buffered: List[tuple[bytes, int]] = []
        self.frame_count = 0
        self.total_bytes = 0
        self.frame_sizes: List[int] = []

    def _build_header(
        self, bitrate_index: int, padding: int, mode_ext: Optional[int] = None
    ) -> bytes:
        opts = self.options
        mode, const_ext = mode_bits(opts.mode.value)
        if mode_ext is None:
            mode_ext = const_ext
        h = BitstreamWriter()
        h.write(0x7FF, 11)
        # version bits: 0b11 MPEG-1, 0b10 MPEG-2 (LSF), 0b00 MPEG-2.5
        h.write((0b11, 0b10, 0b00)[opts.lsf], 2)
        h.write(0b01, 2)  # Layer III
        h.write(0 if opts.crc_protected else 1, 1)
        h.write(bitrate_index, 4)
        h.write(sample_rate_index(opts.sample_rate), 2)
        h.write(padding, 1)
        h.write(0, 1)  # private
        h.write(mode, 2)
        h.write(mode_ext, 2)
        h.write(1 if opts.copyright else 0, 1)
        h.write(1 if opts.original else 0, 1)
        h.write(0, 2)  # no emphasis
        return h.data

    def push(self, fr: FrameResult) -> bytes:
        """Process one encoded frame; returns the previously buffered frame's
        bytes (empty for the first frame)."""
        channels = self.options.channels
        if fr.main_data is not None:
            main_data = fr.main_data
        elif fr.chunks is not None:
            main_data, _bits = pack_chunks(fr.chunks, fr.nbits)
        else:
            main_data, _part_bits = pack_frame_main_data(fr.quantized, fr.big_values)
        aligned = self.options.reservoir_mode == "aligned"
        if aligned:
            # Append-time stuffing (depth-general placement): the frame's
            # data is tail-aligned against its own header — the encoder's
            # main_data_begin IS the placement (mdb bytes of it ride before
            # the header), so the stuffing filling the gap between the
            # previous frame's data and this one's start is gap - mdb.
            # Emission below is then a pure slot-sized pop (fill_slot's
            # emission-time tail logic reproduces exactly this layout at
            # depth 1; append time is what generalizes to deeper delays,
            # where one slot may carry several frames' data + stuffing).
            gap = sum(s for _, s in self._buffered) - len(self.reservoir.stream)
            stuff = gap - fr.main_data_begin
            assert stuff >= 0, (gap, fr.main_data_begin)
            if stuff:
                self.reservoir.append(bytes(stuff))
        self.reservoir.append(main_data)

        if self.options.lsf:
            # LSF: one granule, 8-bit mdb, no scfsi, no preflag bit
            side_info = build_side_info_lsf(
                channels, fr.granules, fr.main_data_begin
            )
        else:
            scfsi = fr.scfsi if fr.scfsi is not None else [[0, 0, 0, 0]] * channels
            side_info = build_side_info(
                channels, fr.granules, scfsi, fr.main_data_begin
            )

        header = self._build_header(fr.bitrate_index, fr.padding, fr.mode_ext)
        head = bytearray(header)
        if self.options.crc_protected:
            if self.options.iso_crc:
                # ISO 2.4.3.1: CRC over header bytes 3-4 + all side info bits
                crc = crc16_mpeg(bytes(head[2:4]) + side_info)
            else:
                crc = crc16_mpeg(bytes(head))  # header-only (reference quirk)
            head += bytes([(crc >> 8) & 0xFF, crc & 0xFF])
        head += side_info

        self._buffered.append((bytes(head), fr.slot_size))
        emitted = b""
        if len(self._buffered) > self.options.reservoir_depth:
            # the delay is full: emit the oldest buffered frame. aligned:
            # stuffing was prepended at append time, so this is a pure
            # slot-sized pop; compat: fill_slot reproduces the reference's
            # end-padding quirk.
            prev_head, prev_slot = self._buffered.pop(0)
            slot = self.reservoir.fill_slot(prev_slot, tail_bytes=0)
            emitted = prev_head + slot
            self.frame_count += 1
            self.total_bytes += len(emitted)
            self.frame_sizes.append(len(emitted))

        self.reservoir.update(len(main_data), fr.slot_size)
        return emitted

    def flush_buffered(self) -> bytes:
        """Emit every still-buffered frame, oldest first
        (MP3Encoder.swift:335-347; depth-general)."""
        out = b""
        while self._buffered:
            head, slot_size = self._buffered.pop(0)
            slot = self.reservoir.fill_slot(slot_size)
            frame = head + slot
            self.frame_count += 1
            self.total_bytes += len(frame)
            self.frame_sizes.append(len(frame))
            out += frame
        return out

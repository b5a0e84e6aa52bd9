"""Xing/Info header frame + 100-byte seek TOC.

Parity with the reference generateXingHeader/generateTOC
(MP3Encoder.swift:367-449): full MP3 frame with no-CRC/no-padding header,
zeroed side info, "Xing" (VBR) or "Info" (CBR) tag, flags 0x07
(frames+bytes+TOC), totalFrames = frame_count + 1, byte count including the
header frame itself, TOC from cumulative frame sizes, zero-padded to the
frame size. Header hardcodes copyright=0/original=1 regardless of options.
"""

from __future__ import annotations

from ..options import MP3EncoderOptions
from ..tables import (
    bitrate_index,
    bitrate_value,
    bitrate_value_lsf,
    mode_bits,
    sample_rate_index,
)
from .bitwriter import BitstreamWriter


def generate_toc(frame_sizes) -> bytes:
    """100-byte TOC from per-frame byte sizes (MP3Encoder.swift:423-449)."""
    if not frame_sizes:
        return bytes((i * 255) // 99 for i in range(100))

    cumulative = []
    total = 0
    for size in frame_sizes:
        total += size
        cumulative.append(total)
    if total <= 0:
        return bytes((i * 255) // 99 for i in range(100))

    toc = bytearray()
    n = len(frame_sizes)
    for percent in range(100):
        target_frame = (percent * n) // 100
        byte_position = cumulative[target_frame - 1] if target_frame > 0 else 0
        toc.append(min((byte_position * 255) // total, 255))
    return bytes(toc)


def build_xing_header(
    options: MP3EncoderOptions,
    frame_count: int,
    total_bytes: int,
    frame_sizes,
    gapless: "tuple[int, int] | None" = None,
) -> bytes:
    """gapless=(encoder_delay, padding) appends the de-facto-standard LAME
    info-tag extension (36 bytes after the TOC: version string, VBR method,
    the 12+12-bit delay/padding pair, music length, and the tag CRC-16 that
    players require before trusting the gapless fields). Layout per the
    LAME VbrTag format; only the fields gapless playback needs are
    populated. The reference writes no such extension (its header ends at
    the TOC, MP3Encoder.swift:415-417)."""
    channels = options.channels
    lsf = options.lsf
    if lsf:
        side_info_size = 9 if channels == 1 else 17
    else:
        side_info_size = 17 if channels == 1 else 32

    if options.free_format:
        # free format: the info frame must be the SAME constant size as
        # every audio frame (decoders infer the stream's frame size)
        br_index, br_value = 0, options.bitrate_kbps
    else:
        br_index = bitrate_index(options.bitrate_kbps, options.sample_rate)
        br_value = bitrate_value_lsf(br_index) if lsf else bitrate_value(br_index)
    sr_index = sample_rate_index(options.sample_rate)
    frame_size = ((72 if lsf else 144) * br_value * 1000) // options.sample_rate

    mode, mode_ext = mode_bits(options.mode.value)

    h = BitstreamWriter()
    h.write(0x7FF, 11)  # sync
    h.write((0b11, 0b10, 0b00)[lsf], 2)  # MPEG-1 / MPEG-2 / MPEG-2.5
    h.write(0b01, 2)  # Layer III
    h.write(1, 1)  # no CRC
    h.write(br_index, 4)
    h.write(sr_index, 2)
    h.write(0, 1)  # no padding
    h.write(0, 1)  # private
    h.write(mode, 2)
    h.write(mode_ext, 2)
    h.write(0, 1)  # not copyrighted
    h.write(1, 1)  # original
    h.write(0, 2)  # no emphasis

    frame = bytearray(h.data)
    frame += bytes(side_info_size)
    frame += (b"Xing" if options.vbr else b"Info")
    frame += (0x07).to_bytes(4, "big")  # flags: frames + bytes + TOC
    # The reference counts the header frame itself (+1, MP3Encoder.swift:
    # 405). Gapless players compute the end-trim point from this field
    # (track samples = frames * 1152 - delay - padding), so the gapless
    # variant writes the TRUE audio frame count — the +1 pushes the trim
    # point one frame past the stream and the padding is never removed.
    frame += (frame_count + (1 if gapless is None else 0)).to_bytes(4, "big")
    frame += ((total_bytes + frame_size) & 0xFFFFFFFF).to_bytes(4, "big")
    frame += generate_toc(frame_sizes)

    if gapless is not None:
        delay, padding = gapless
        delay = max(0, min(int(delay), 0xFFF))
        padding = max(0, min(int(padding), 0xFFF))
        lame = bytearray()
        # 9-byte encoder version string: gapless-aware players key the
        # extension's presence on a "LAME"-shaped field (mpg123 and ffmpeg
        # both sniff it), so the de-facto format requires the magic even
        # from other encoders.
        lame += b"LAME3.100"
        # tag revision 0 (high nibble) + VBR method (low nibble: 1=CBR,
        # 3=file-based VBR is the closest match for the vbr heuristic)
        lame += bytes([(0 << 4) | (3 if options.vbr else 1)])
        lame += bytes(1)  # lowpass (unknown)
        lame += bytes(4)  # peak amplitude (unset)
        lame += bytes(2)  # radio replay gain (unset)
        lame += bytes(2)  # audiophile replay gain (unset)
        lame += bytes(1)  # encoding flags + ATH type (unset)
        lame += bytes([min(options.bitrate_kbps, 255)])  # (min) bitrate
        lame += bytes(
            [
                (delay >> 4) & 0xFF,
                ((delay & 0xF) << 4) | ((padding >> 8) & 0xF),
                padding & 0xFF,
            ]
        )
        lame += bytes(1)  # misc (source/noise-shaping info, unset)
        lame += bytes(1)  # mp3 gain
        lame += bytes(2)  # preset + surround
        # music length: whole-file bytes from the start of this frame
        lame += ((total_bytes + frame_size) & 0xFFFFFFFF).to_bytes(4, "big")
        lame += bytes(2)  # music CRC (unset; players ignore it for gapless)
        frame += lame
        # info-tag CRC-16 (poly 0x8005, init 0) over the frame up to here;
        # players validate it before trusting delay/padding
        frame += _crc16_zero(bytes(frame)).to_bytes(2, "big")

    if len(frame) < frame_size:
        frame += bytes(frame_size - len(frame))
    return bytes(frame)


def _crc16_zero(data: bytes) -> int:
    """CRC-16 poly 0x8005 with INIT 0 — the LAME info-tag variant (the MP3
    frame CRC uses the same polynomial with init 0xFFFF, io/crc.py)."""
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc >> 1) ^ 0xA001) if (crc & 1) else (crc >> 1)
    return crc & 0xFFFF

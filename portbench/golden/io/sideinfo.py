"""ISO 11172-3 Section 2.4.1.7 side information serializer.

Bit layout parity with the reference buildSideInfo (MP3Encoder.swift:571-625):
9-bit main_data_begin (capped 511), 5/3 private bits (mono/stereo), 4 scfsi
bits per channel, then per granule x channel the 12+9+8+4+1 core fields and
the window-switching or normal-block tail, ending with
preflag/scalefac_scale/count1table_select. Padded to 136/256 bits.
"""

from __future__ import annotations

from dataclasses import dataclass

from .bitwriter import BitstreamWriter


@dataclass
class GranuleInfo:
    """Side-info field bag for one granule of one channel
    (MP3Encoder.swift:2070-2085)."""

    part23_length: int = 0
    big_values: int = 0
    global_gain: int = 0
    scalefac_compress: int = 0
    window_switching: int = 0
    block_type: int = 0
    mixed_block_flag: int = 0
    table_select: tuple = (0, 0, 0)
    subblock_gain: tuple = (0, 0, 0)
    region0_count: int = 0
    region1_count: int = 0
    preflag: int = 0
    scalefac_scale: int = 0
    count1table_select: int = 0


def build_side_info(
    channels: int,
    granules,  # [2][channels] of GranuleInfo
    scfsi,  # [channels][4] of int
    main_data_begin: int = 0,
) -> bytes:
    w = BitstreamWriter()
    side_info_bits = 136 if channels == 1 else 256

    w.write(min(main_data_begin, 511), 9)
    w.write(0, 5 if channels == 1 else 3)  # private bits

    for ch in range(channels):
        for band in range(4):
            w.write(scfsi[ch][band], 1)

    for gr in range(2):
        for ch in range(channels):
            info = granules[gr][ch]
            w.write(info.part23_length, 12)
            w.write(info.big_values, 9)
            w.write(info.global_gain, 8)
            w.write(info.scalefac_compress, 4)
            w.write(info.window_switching, 1)
            if info.window_switching == 1:
                w.write(info.block_type, 2)
                w.write(info.mixed_block_flag, 1)
                w.write(info.table_select[0], 5)
                w.write(info.table_select[1], 5)
                w.write(info.subblock_gain[0], 3)
                w.write(info.subblock_gain[1], 3)
                w.write(info.subblock_gain[2], 3)
            else:
                w.write(info.table_select[0], 5)
                w.write(info.table_select[1], 5)
                w.write(info.table_select[2], 5)
                w.write(info.region0_count, 4)
                w.write(info.region1_count, 3)
            w.write(info.preflag, 1)
            w.write(info.scalefac_scale, 1)
            w.write(info.count1table_select, 1)

    w.pad_to_byte()
    data = bytearray(w.data)
    target = side_info_bits // 8
    if len(data) < target:
        data += bytes(target - len(data))
    return bytes(data)


def build_side_info_lsf(
    channels: int,
    granules,  # [1][channels] of GranuleInfo
    main_data_begin: int = 0,
) -> bytes:
    """LSF (MPEG-2/2.5, ISO 13818-3 2.4.1.7) side info: ONE granule per
    frame, 8-bit main_data_begin (capped 255), 1/2 private bits
    (mono/stereo), no scfsi, 9-bit scalefac_compress, NO preflag bit
    (pre-emphasis is implicit in the scalefac_compress >= 500 case).
    9 bytes mono / 17 stereo. Field order mirrors the decoder's
    parse_frame (decoder/decoder.py) which is mpg123-validated on
    libmp3lame LSF streams."""
    w = BitstreamWriter()
    side_info_bits = 72 if channels == 1 else 136

    w.write(min(main_data_begin, 255), 8)
    w.write(0, 1 if channels == 1 else 2)  # private bits

    for ch in range(channels):
        info = granules[0][ch]
        w.write(info.part23_length, 12)
        w.write(info.big_values, 9)
        w.write(info.global_gain, 8)
        w.write(info.scalefac_compress, 9)
        w.write(info.window_switching, 1)
        if info.window_switching == 1:
            w.write(info.block_type, 2)
            w.write(info.mixed_block_flag, 1)
            w.write(info.table_select[0], 5)
            w.write(info.table_select[1], 5)
            w.write(info.subblock_gain[0], 3)
            w.write(info.subblock_gain[1], 3)
            w.write(info.subblock_gain[2], 3)
        else:
            w.write(info.table_select[0], 5)
            w.write(info.table_select[1], 5)
            w.write(info.table_select[2], 5)
            w.write(info.region0_count, 4)
            w.write(info.region1_count, 3)
        w.write(info.scalefac_scale, 1)
        w.write(info.count1table_select, 1)

    w.pad_to_byte()
    data = bytearray(w.data)
    target = side_info_bits // 8
    if len(data) < target:
        data += bytes(target - len(data))
    return bytes(data)

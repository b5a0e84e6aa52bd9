"""MPEG-1/2/2.5 Layer III decoder (numpy, test oracle).

Decodes general MPEG-1 Layer III per ISO 11172-3: the complete B.7 Huffman
set (including the linbits/ESC families 16-31 and the REAL tables 10-13 —
extracted from libavcodec, see `_b7_data.py`; the reference's own copies of
10/13 are corrupt and never emitted), count1 tables A and B, all four block
types (long, start, short, stop; mixed blocks), preflag/pretab, scfsi, and
full scalefactor parsing. This lets the oracle decode third-party streams
(e.g. libmp3lame's) — validated behaviorally against the system libmpg123
in tests/test_external.py — in addition to this framework's own output.

MPEG-2/2.5 LSF streams (ISO 13818-3: half/quarter sample rates, one
576-sample granule per frame, 9-bit scalefac_compress with the 6-case slen
decomposition, implicit preflag, no scfsi) decode too — decode-side
third-party coverage only (the encoder family is MPEG-1-only, matching the
reference, MP3Encoder.swift header parse). LSF band tables come from
libavcodec (`_lsf_data.py`, tools/extract_lsf_tables.py); validation is
libmp3lame-produced low-rate streams A/B'd against libmpg123
(tests/test_lsf.py). LSF intensity stereo is applied per the ISO 13818-3
2^(-pos/4) position law with per-band all-ones illegal markers (round 4;
no third-party producer emits it, so tests/test_intensity.py
hand-assembles conforming LSF IS streams from the repo's emission
primitives and libmpg123 arbitrates — the same producer methodology as
the MPEG-1 intensity surface).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# The oracle's constants are deliberately INDEPENDENT of the encoder's
# table modules (see decoder/tables.py): a transcription error in either
# copy fails the cross-check tests loudly instead of passing round-trips
# silently (the reference gets this independence for free from AVFoundation,
# SwiftMP3Tests.swift:653-660).
from ._b7_data import B7_SELECT, B7_TABLES
from .tables import (
    ALIASING_CA,
    ALIASING_CS,
    ISO_WINDOW,
    SUPPORTED_TABLE_IDS,
    band_table,
    huffman_arrays,
    mixed_head,
    mixed_region_bound,
    short_band_table,
    short_reorder_dest,
)

BITRATES = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0]
SAMPLE_RATES = [44100, 48000, 32000, 0]

# MPEG-2/2.5 (LSF, ISO 13818-3) Layer III: decode-side third-party stream
# coverage only — the encoder family is MPEG-1-only (reference parity).
BITRATES_LSF = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0]
SAMPLE_RATES_V2 = [22050, 24000, 16000, 0]
SAMPLE_RATES_V25 = [11025, 12000, 8000, 0]

# slen1/slen2 per scalefac_compress (ISO 2.4.2.7)
SLEN = [
    (0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
    (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3),
]

# Preemphasis table (ISO Table B.6), one entry per long scalefactor band
PRETAB = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2], dtype=np.int32
)


class BitReader:
    """MSB-first bit reader."""

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    @property
    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos


def _decode_lut(table_id: int) -> dict:
    """(length, code) -> (x, y) from the complete extracted B.7 set."""
    _, entries = B7_TABLES[table_id]
    return {lc: xy for xy, lc in entries.items()}


_DECODE_LUTS = {tid: _decode_lut(tid) for tid in B7_TABLES}
_MAX_CODE_LEN = 24

# Consistency guard at import: the hand transcription (tables.py, used by
# encoder-parity tests) and the extracted B.7 set must agree on every table
# id both carry — a corruption in either source fails loudly here.
for _tid in SUPPORTED_TABLE_IDS:
    _hl, _hc = huffman_arrays(_tid)
    _side, _entries = B7_TABLES[_tid]
    assert _side == _hl.shape[0] and all(
        (int(_hl[x, y]), int(_hc[x, y])) == lc for (x, y), lc in _entries.items()
    ), f"B.7 table {_tid} mismatch between _b7_data and hand transcription"
del _tid, _hl, _hc, _side, _entries


def _huffman_decode_pair(r: BitReader, table_select: int) -> tuple[int, int]:
    """Decode one signed big-values pair for a table_select (0-31),
    including the linbits escape of families 16-31 (ISO 2.4.3.4.6: value
    15 is followed by `linbits` extra magnitude bits, then the sign)."""
    pair_tid, linbits = B7_SELECT.get(table_select, (None, 0))
    if pair_tid is None:
        # 0 codes an all-zero region; 4/14 do not exist in B.7 (treated as
        # zero, matching conformance-grade decoders' robust behavior)
        return 0, 0
    lut = _DECODE_LUTS[pair_tid]
    code, length = 0, 0
    xy = None
    while length <= _MAX_CODE_LEN:
        code = (code << 1) | r.read(1)
        length += 1
        xy = lut.get((length, code))
        if xy is not None:
            break
    if xy is None:
        raise ValueError(f"invalid Huffman code in table {pair_tid}")
    x, y = xy
    if x == 15 and linbits:
        x += r.read(linbits)
    if x and r.read(1):
        x = -x
    if y == 15 and linbits:
        y += r.read(linbits)
    if y and r.read(1):
        y = -y
    return x, y


@dataclass
class GranuleSide:
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


@dataclass
class FrameInfo:
    offset: int
    size: int
    bitrate_kbps: int
    sample_rate: int
    padding: int
    crc: bool
    mode: int
    mode_extension: int
    channels: int
    main_data_begin: int
    granules: list  # [2][ch] GranuleSide
    main_data: bytes
    scfsi: list = None  # [ch][4] bits: granule 1 reuses gr0's sf per group
    lsf: int = 0  # 0 MPEG-1, 1 MPEG-2, 2 MPEG-2.5 (one granule per frame)


def _crc16(data: bytes) -> int:
    """CRC-16, polynomial 0x8005, init 0xFFFF (bitwise; independent of the
    encoder's table-driven implementation)."""
    crc = 0xFFFF
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def verify_frame_crcs(data: bytes) -> list:
    """Per protected frame: True if the stored CRC matches the ISO 2.4.3.1
    coverage (header bytes 3-4 + side info). Reference-quirk streams
    (header-only CRC) verify as False — that is the point: real decoders
    reject them. Unprotected frames are skipped (not in the list).

    Accepts the same inputs decode_mp3 does: an ID3v2 prefix is skipped,
    free-format streams get their size inferred (shared frame walk with
    decode_mp3), and the walk stops at a truncated or malformed tail."""
    if data[:3] == b"ID3" and len(data) >= 10:
        size = (data[6] << 21) | (data[7] << 14) | (data[8] << 7) | data[9]
        data = data[10 + size :]
    results = []
    for fi in _iter_frames(data, strict=False):
        if fi.crc:
            i = fi.offset
            if fi.lsf:
                side_len = 9 if fi.channels == 1 else 17
            else:
                side_len = 17 if fi.channels == 1 else 32
            if i + 6 + side_len > len(data):
                break
            stored = (data[i + 4] << 8) | data[i + 5]
            covered = data[i + 2 : i + 4] + data[i + 6 : i + 6 + side_len]
            results.append(stored == _crc16(bytes(covered)))
    return results


def _free_format_size(data: bytes, offset: int) -> int:
    """Infer a free-format stream's base frame size (without padding) from
    sync spacing. ISO 2.4.2.3: bitrate index 0 means free format — any
    constant rate, frame size NOT derivable from the header; decoders
    measure the distance to the next frame whose header matches in
    version/layer/protection/sample-rate and is also free-format.

    A coincidental sync-like pattern inside main_data would yield a
    too-small size and corrupt the whole walk (free format gives no
    per-frame size check to recover), so a candidate is committed only if
    the next two frames' headers also land at the padding-modulated
    spacing the candidate implies (or the stream ends first)."""
    b = data[offset : offset + 4]
    padding = (b[2] >> 1) & 1

    def _match(i):
        """True/False header match at i; None when past the data end."""
        if i + 4 > len(data):
            return None
        c = data[i : i + 4]
        return (
            c[0] == 0xFF
            and c[1] == b[1]
            and (c[2] & 0x0C) == (b[2] & 0x0C)
            and ((c[2] >> 4) & 0xF) == 0
        )

    for dist in range(24, 8193):
        if _match(offset + dist) is None:
            break
        if not _match(offset + dist):
            continue
        base = dist - padding
        pos, ok = offset + dist, True
        for _ in range(2):  # confirm two more padding-modulated spacings
            pad = (data[pos + 2] >> 1) & 1
            nxt = pos + base + pad
            m = _match(nxt)
            if m is None:
                break  # stream ends before a counterexample: accept
            if not m:
                ok = False
                break
            pos = nxt
        if ok:
            return base
    raise ValueError(f"cannot infer free-format frame size at {offset}")


def parse_frame(data: bytes, offset: int, free_size: int = 0) -> FrameInfo:
    b = data[offset : offset + 4]
    if not (b[0] == 0xFF and (b[1] & 0xE0) == 0xE0):
        raise ValueError(f"bad sync at {offset}")
    version = (b[1] >> 3) & 3  # 3 MPEG-1, 2 MPEG-2, 0 MPEG-2.5, 1 reserved
    layer = (b[1] >> 1) & 3  # 1 = Layer III
    if version == 1 or layer != 0b01:
        raise ValueError(f"not Layer III at {offset}")
    lsf = 0 if version == 3 else (1 if version == 2 else 2)
    crc = (b[1] & 1) == 0
    bidx = (b[2] >> 4) & 0xF
    if bidx == 15:
        raise ValueError(f"bad bitrate index at {offset}")
    if lsf:
        bitrate = BITRATES_LSF[bidx]
        sr = (SAMPLE_RATES_V2 if lsf == 1 else SAMPLE_RATES_V25)[(b[2] >> 2) & 0x3]
    else:
        bitrate = BITRATES[bidx]
        sr = SAMPLE_RATES[(b[2] >> 2) & 0x3]
    padding = (b[2] >> 1) & 1
    mode = (b[3] >> 6) & 3
    mode_ext = (b[3] >> 4) & 3
    channels = 1 if mode == 0b11 else 2
    if bidx == 0:
        # free format: size measured from sync spacing (see above), the
        # padding bit still modulates per frame
        if not free_size:
            raise ValueError(f"free-format frame at {offset} without a size")
        size = free_size + padding
    else:
        # LSF frames carry ONE granule (576 samples): 72 slots per kbps
        size = ((72 if lsf else 144) * bitrate * 1000) // sr + padding

    side_off = offset + 4 + (2 if crc else 0)
    if lsf:
        side_len = 9 if channels == 1 else 17
    else:
        side_len = 17 if channels == 1 else 32
    r = BitReader(data[side_off : side_off + side_len])
    mdb = r.read(8 if lsf else 9)
    if lsf:
        r.read(1 if channels == 1 else 2)
        scfsi = None  # LSF has no scfsi
    else:
        r.read(5 if channels == 1 else 3)
        scfsi = [[r.read(1) for _ in range(4)] for _ in range(channels)]
    n_gr = 1 if lsf else 2
    granules = [[None] * channels for _ in range(n_gr)]
    for gr in range(n_gr):
        for ch in range(channels):
            g = GranuleSide()
            g.part23_length = r.read(12)
            g.big_values = r.read(9)
            g.global_gain = r.read(8)
            # LSF: 9-bit scalefac_compress, decomposed into 4 slens by the
            # ISO 13818-3 law at scalefactor-read time (preflag implicit)
            g.scalefac_compress = r.read(9 if lsf else 4)
            g.window_switching = r.read(1)
            if g.window_switching:
                g.block_type = r.read(2)
                g.mixed_block_flag = r.read(1)
                g.table_select = (r.read(5), r.read(5), 0)
                g.subblock_gain = (r.read(3), r.read(3), r.read(3))
                # ISO defaults when window switching is active
                g.region0_count = 7 if g.block_type != 2 or g.mixed_block_flag else 8
                g.region1_count = 20 - g.region0_count
            else:
                g.table_select = (r.read(5), r.read(5), r.read(5))
                g.region0_count = r.read(4)
                g.region1_count = r.read(3)
            if not lsf:
                g.preflag = r.read(1)
            g.scalefac_scale = r.read(1)
            g.count1table_select = r.read(1)
            granules[gr][ch] = g

    main_off = side_off + side_len
    return FrameInfo(
        offset=offset,
        size=size,
        bitrate_kbps=bitrate,
        sample_rate=sr,
        padding=padding,
        crc=crc,
        mode=mode,
        mode_extension=mode_ext,
        channels=channels,
        main_data_begin=mdb,
        granules=granules,
        main_data=bytes(data[main_off : offset + size]),
        scfsi=scfsi,
        lsf=lsf,
    )


def _decode_granule_spectrum(
    r: BitReader, g: GranuleSide, sample_rate: int, part_start: int
) -> np.ndarray:
    """Huffman-decode 576 coefficients for one granule."""
    q = np.zeros(576, dtype=np.int32)
    bands = np.cumsum(band_table(sample_rate))

    if g.window_switching:
        # ISO implicit regions under window switching: region2 is empty;
        # the region0/1 boundary for pure short and start/stop is
        # BAND-DERIVED — region0_count=8 for pure short -> 3x the first
        # three short bands (36, 72 at 8 kHz); region0_count=7 for
        # start/stop -> long bands 0-7 (36 at MPEG-1 rates, 54 at
        # 16-24 kHz, 108 at 8 kHz) — ffmpeg's init_short_region encodes
        # the same law; validated against libmpg123 on libmp3lame streams
        # at MPEG-1 AND LSF rates. MIXED granules are the exception: the
        # de-facto decoder law is the MPEG-1 constant 36 at 16-24 kHz
        # (NOT the ISO 8-band derivation's 54) and 108 only at 8 kHz —
        # measured round 5 with bound-discriminating producers (see
        # tables.iso.mixed_switch_bound; at MPEG-1 rates 36 either way).
        if g.block_type == 2 and g.mixed_block_flag:
            region1_start = mixed_region_bound(sample_rate)
        elif g.block_type == 2:
            sw = short_band_table(sample_rate)
            region1_start = 3 * int(sw[0] + sw[1] + sw[2])
        else:
            region1_start = int(bands[7])
        region2_start = 576
    else:
        region1_start = int(bands[g.region0_count]) if g.region0_count < 21 else 576
        r1 = g.region0_count + 1 + g.region1_count
        region2_start = int(bands[r1]) if r1 < 21 else 576

    # big_values region (sign + linbits handled inside the pair decode)
    for i in range(0, g.big_values * 2, 2):
        if i < region1_start:
            tid = g.table_select[0]
        elif i < region2_start:
            tid = g.table_select[1]
        else:
            tid = g.table_select[2]
        x, y = _huffman_decode_pair(r, tid)
        if i < 576:
            q[i] = x
        if i + 1 < 576:
            q[i + 1] = y

    # count1 region: read quadruples while part2_3 bits remain
    i = g.big_values * 2
    part_end = part_start + g.part23_length
    while r.pos < part_end and i + 3 < 576:
        if g.count1table_select:  # table B: fixed 4-bit codes, code = 15-index
            idx = 15 - r.read(4)
            vals = [(idx >> 3) & 1, (idx >> 2) & 1, (idx >> 1) & 1, idx & 1]
        else:
            vals = _decode_count1_a(r)
        for v in vals:
            if v and r.pos < part_end:
                if r.read(1):
                    v = -v
            q[i] = v
            i += 1
    return q


# ISO count1 table A: codes for (v,w,x,y) quadruples
_COUNT1_A_LENGTHS = [1, 4, 4, 5, 4, 6, 5, 6, 4, 5, 5, 6, 5, 6, 6, 6]
_COUNT1_A_CODES = [1, 5, 4, 5, 6, 5, 4, 4, 7, 3, 6, 0, 7, 2, 3, 1]
_COUNT1_A_LUT = {
    (l, c): i for i, (l, c) in enumerate(zip(_COUNT1_A_LENGTHS, _COUNT1_A_CODES))
}


def _decode_count1_a(r: BitReader) -> list[int]:
    code, length = 0, 0
    while length <= 6:
        code = (code << 1) | r.read(1)
        length += 1
        hit = _COUNT1_A_LUT.get((length, code))
        if hit is not None:
            return [(hit >> 3) & 1, (hit >> 2) & 1, (hit >> 1) & 1, hit & 1]
    raise ValueError("invalid count1 code")


def _lsf_sf_expand(sf: int, n1: int, n2: int, n3: int) -> list[int]:
    """ISO 13818-3 scalefac_compress decomposition into 4 slen values."""
    slen = [0, 0, 0, 0]
    if n3:
        slen[3] = sf % n3
        sf //= n3
    if n2:
        slen[2] = sf % n2
        sf //= n2
    slen[1] = sf % n1
    slen[0] = sf // n1
    return slen


def _read_lsf_scalefactors(r: BitReader, g: GranuleSide, intensity_ch: bool):
    """LSF (MPEG-2/2.5) scalefactor read per ISO 13818-3: the 9-bit
    scalefac_compress selects one of six decompositions into 4 slens, and
    LSF_NSF_TABLE gives each slen group's band count for the granule's
    window class. Sets g.preflag (implicit in the >=500 case — LSF side
    info carries no preflag bit). intensity_ch = the right channel of an
    intensity-stereo frame (cases 3-5 — its values are intensity
    POSITIONS; the caller needs the per-band slen widths because the LSF
    illegal-position marker is the all-ones value of each band's OWN
    field, (1<<slen)-1, not MPEG-1's fixed 7).

    Returns (scalefacs[21] | None, sf_short[12][3] | None,
    sf_mixed_long[8] | None, widths) in the shapes _requantize consumes,
    where widths mirrors the populated scalefacs/sf_short shape with each
    band's slen; LSF mixed granules have 6 long head bands, padded with
    two zero bands. The head is 36 lines at 11.025-24 kHz but 72 lines at
    8 kHz (6 bands x 12) — validated round 4 against libmpg123 on a
    hand-assembled 8 kHz mixed producer (tests/test_lsf.py; synthesis
    keeps the universal 2-subband head, see tables.mixed_head)."""
    from ._lsf_data import LSF_NSF_TABLE

    sf = g.scalefac_compress
    g.preflag = 0
    if intensity_ch:
        sf >>= 1
        if sf < 180:
            slen, case = _lsf_sf_expand(sf, 6, 6, 0), 3
        elif sf < 244:
            slen, case = _lsf_sf_expand(sf - 180, 4, 4, 0), 4
        else:
            slen, case = _lsf_sf_expand(sf - 244, 3, 0, 0), 5
    else:
        if sf < 400:
            slen, case = _lsf_sf_expand(sf, 5, 4, 4), 0
        elif sf < 500:
            slen, case = _lsf_sf_expand(sf - 400, 5, 4, 0), 1
        else:
            slen, case = _lsf_sf_expand(sf - 500, 3, 0, 0), 2
            g.preflag = 1
    is_short = g.window_switching and g.block_type == 2
    wclass = (2 if g.mixed_block_flag else 1) if is_short else 0
    ns = LSF_NSF_TABLE[case][wclass]
    vals = []
    wids = []
    for k in range(4):
        width = slen[k]
        vals += [r.read(width) if width else 0 for _ in range(ns[k])]
        wids += [width] * ns[k]
    if not is_short:
        # all six long cases total 21 bands
        return vals[:21], None, None, wids[:21]
    sf_short = [[0, 0, 0] for _ in range(12)]
    w_short = [[0, 0, 0] for _ in range(12)]
    if g.mixed_block_flag:
        sf_mixed_long = vals[:6] + [0, 0]
        for sfb in range(3, 12):
            for w in range(3):
                sf_short[sfb][w] = vals[6 + (sfb - 3) * 3 + w]
                w_short[sfb][w] = wids[6 + (sfb - 3) * 3 + w]
        return None, sf_short, sf_mixed_long, w_short
    for sfb in range(12):
        for w in range(3):
            sf_short[sfb][w] = vals[sfb * 3 + w]
            w_short[sfb][w] = wids[sfb * 3 + w]
    return None, sf_short, None, w_short


def _is_factors(pos: int, lsf: int, intensity_scale: int, slen: int):
    """Intensity-stereo position -> (k_left, k_right), or None when the
    position is the illegal marker (the band keeps its M/S-or-L/R
    reading). MPEG-1 (ISO 11172-3 2.4.3.4.9.3): ratio = tan(pos*pi/12),
    k_l = ratio/(1+ratio), k_r = 1/(1+ratio); pos 7 illegal, pos 6
    all-left. LSF (ISO 13818-3 2.4.3.2): the right granule's
    scalefac_compress bit 0 is intensity_scale; with
    base = 2^(-0.25*(intensity_scale+1)), an ODD position attenuates the
    LEFT channel by base^((pos+1)/2) (right stays 1), an EVEN position
    attenuates the RIGHT by base^(pos/2) (left stays 1); pos 0 leaves
    both at 1; the illegal marker is the all-ones value of the band's
    OWN slen field, (1<<slen)-1 (a 0-width field cannot mark illegal —
    pos 0 there means 'both at 1'). Validated against libmpg123 on
    hand-assembled streams (tests/test_intensity.py)."""
    if lsf:
        if slen and pos == (1 << slen) - 1:
            return None
        if pos == 0:
            return 1.0, 1.0
        base = 2.0 ** (-0.25 * (intensity_scale + 1))
        if pos & 1:
            return base ** ((pos + 1) >> 1), 1.0
        return 1.0, base ** (pos >> 1)
    if pos == 7:
        return None
    if pos == 6:
        return 1.0, 0.0
    ratio = float(np.tan(pos * np.pi / 12.0))
    return ratio / (1.0 + ratio), 1.0 / (1.0 + ratio)


def _requantize(
    q: np.ndarray,
    g: GranuleSide,
    sample_rate: int,
    scalefacs=None,
    sf_short=None,
    sf_mixed_long=None,
) -> np.ndarray:
    """ISO 2.4.3.4.7.1 requantization: xr = |q|^(4/3) * 2^((gain-210)/4) *
    2^(-(scalefac_scale+1)/2 * (scalefac + preflag*pretab)) per long band
    (scalefac_multiplier = (scalefac_scale+1)/2, so the per-unit factor is
    sqrt(2) at scalefac_scale=0 and 2 at scalefac_scale=1).

    Short blocks: the per-(sfb, window) factor 2^(-scalefac_multiplier *
    sf_short[sfb][w]) (no pretab) applies to window w's lines of short band
    sfb; `q` must be in the NATURAL subband-major order (coefficient
    3*line + w), i.e. after the 2.4.3.4.8 reorder-undo. Mixed granules use
    sf_mixed_long[0..7] on the long head (first 36 coefficients) and
    sf_short[3..11] above it."""
    gain_exp = 0.25 * (g.global_gain - 210)
    mag = np.abs(q).astype(np.float64) ** (4.0 / 3.0)
    xr = mag * (2.0 ** gain_exp)
    scale_mult = 0.5 * (g.scalefac_scale + 1)
    is_short = g.window_switching and g.block_type == 2
    apply_pre = g.preflag and not is_short
    have_sf = scalefacs is not None and any(scalefacs)
    if apply_pre or have_sf:
        bands = band_table(sample_rate)
        cursor = 0
        for band_idx, width in enumerate(bands):
            end = min(cursor + int(width), 576)
            sf = scalefacs[band_idx] if scalefacs is not None else 0
            pre = PRETAB[band_idx] if apply_pre else 0
            total = sf + pre
            if total:
                xr[cursor:end] *= 2.0 ** (-scale_mult * total)
            cursor = end
    if is_short and sf_short is not None and any(any(row) for row in sf_short):
        sbounds = np.concatenate(
            [[0], np.cumsum(short_band_table(sample_rate)), [192]]
        ).astype(int)
        first_sfb = mixed_head(sample_rate)[1] if g.mixed_block_flag else 0
        for sfb in range(first_sfb, 12):
            lo, hi = int(sbounds[sfb]), int(sbounds[sfb + 1])
            for w in range(3):
                sf = sf_short[sfb][w]
                if sf:
                    nat = 3 * np.arange(lo, hi) + w
                    xr[nat] *= 2.0 ** (-scale_mult * sf)
    if (
        is_short
        and g.mixed_block_flag
        and sf_mixed_long is not None
        and any(sf_mixed_long)
    ):
        lbounds = np.concatenate([[0], np.cumsum(band_table(sample_rate))]).astype(int)
        for band_idx in range(8):
            sf = sf_mixed_long[band_idx]
            if sf:
                xr[lbounds[band_idx] : lbounds[band_idx + 1]] *= 2.0 ** (
                    -scale_mult * sf
                )
    # ISO 2.4.3.4.7.1 per-window gain for short blocks: window w of a short
    # subband is attenuated by 2^(-2*subblock_gain[w]). In this encoder
    # family's short layout, coefficient i belongs to window (i%18)%3;
    # mixed granules keep the long head (36 lines; 72 at 8 kHz) untouched.
    if g.window_switching and g.block_type == 2 and any(g.subblock_gain):
        w_of = (np.arange(576) % 18) % 3
        factor = (2.0 ** (-2.0 * np.asarray(g.subblock_gain, dtype=np.float64)))[w_of]
        if g.mixed_block_flag:
            factor[: mixed_head(sample_rate)[0]] = 1.0
        xr *= factor
    return (np.sign(q) * xr).astype(np.float32)


def _alias_reduce_decode(xr: np.ndarray, n_boundaries: int = 31) -> np.ndarray:
    """Decoder-side butterflies (inverse of the encoder's, ISO 2.4.3.4.7).
    n_boundaries=1 is the conforming treatment of mixed blocks (only the
    long head's subband 0/1 boundary is aliased)."""
    s = xr.copy()
    cs, ca = ALIASING_CS.astype(np.float64), ALIASING_CA.astype(np.float64)
    for sb in range(n_boundaries):
        for j in range(8):
            u = s[sb * 18 + 17 - j]
            l = s[(sb + 1) * 18 + j]
            s[sb * 18 + 17 - j] = u * cs[j] - l * ca[j]
            s[(sb + 1) * 18 + j] = l * cs[j] + u * ca[j]
    return s


def _imdct_matrices():
    n = 36
    k = np.arange(n, dtype=np.float64)[None, :]
    m = np.arange(18, dtype=np.float64)[:, None]
    long_m = np.cos(np.pi / (2 * n) * (2 * k + 1 + n / 2) * (2 * m + 1))
    n2 = 12
    k2 = np.arange(n2, dtype=np.float64)[None, :]
    m2 = np.arange(6, dtype=np.float64)[:, None]
    short_m = np.cos(np.pi / (2 * n2) * (2 * k2 + 1 + n2 / 2) * (2 * m2 + 1))
    long_w = np.sin(np.pi / 36 * (np.arange(36) + 0.5))
    short_w = np.sin(np.pi / 12 * (np.arange(12) + 0.5))
    return long_m, short_m, long_w, short_w


_LONG_M, _SHORT_M, _LONG_W, _SHORT_W = _imdct_matrices()

# Transition windows (ISO 2.4.3.4.10.3). block_type 1 (start): long attack
# half, flat top, short decay half, zero tail; block_type 3 (stop) is the
# time mirror. Emitted by third-party encoders (lame) around transients;
# this framework's encoder family jumps long<->short directly (reference
# behavior) and never writes them.
_START_W = _LONG_W.copy()
_START_W[18:24] = 1.0
_START_W[24:30] = _SHORT_W[6:12]
_START_W[30:36] = 0.0
_STOP_W = _START_W[::-1].copy()


def _imdct_granule(xr: np.ndarray, g: GranuleSide, overlap: np.ndarray) -> np.ndarray:
    """Per-subband IMDCT + windowing + overlap-add; updates overlap in place.

    Scaling: the encoder's forward MDCT divides by 9 (long) / 3 (short)
    (MP3Encoder.swift:1621, 1641) — exactly N/4 of each transform — so the
    inverse M^T with sine-window overlap-add has unit gain (validated
    numerically: single-subband TDAC error ~1e-7 at scale 1.0).

    A MIXED granule's long synthesis head is 2 subbands at EVERY rate —
    including MPEG-2.5 8 kHz, whose 72-line STREAM-LAYOUT head covers 4
    subbands: there, natural lines 36..72 are dequantized as long bands
    3-5 but synthesized as short windows (the mpg123-arbitrated hybrid,
    see tables.mixed_head).
    """
    out = np.zeros((32, 18), dtype=np.float64)
    for sb in range(32):
        X = xr[sb * 18 : sb * 18 + 18].astype(np.float64)
        is_long = not (g.window_switching and g.block_type == 2) or (
            g.mixed_block_flag and sb < 2
        )
        if is_long:
            if g.window_switching and g.block_type == 1 and not (
                g.mixed_block_flag and sb < 2
            ):
                w = _START_W
            elif g.window_switching and g.block_type == 3:
                w = _STOP_W
            else:
                w = _LONG_W
            x36 = (_LONG_M.T @ X) * w
        else:
            x36 = np.zeros(36)
            for w in range(3):
                Xw = X[w::3][:6]  # encoder wrote index 3m + w
                xw = (_SHORT_M.T @ Xw) * _SHORT_W
                x36[6 + 6 * w : 18 + 6 * w] += xw
        out[sb] = x36[:18] + overlap[sb]
        overlap[sb] = x36[18:]
        # undo the encoder's frequency inversion for odd subbands
        if sb & 1:
            out[sb][1::2] *= -1
    return out


def _synthesis_matrix():
    i = np.arange(64, dtype=np.float64)[:, None]
    k = np.arange(32, dtype=np.float64)[None, :]
    return np.cos((16 + i) * (2 * k + 1) * np.pi / 64)


_SYNTH_N = _synthesis_matrix()
# Synthesis window: ISO Table D.1 == 32x the analysis window including signs
# (validated numerically: analysis->synthesis round trip has unit gain and
# residual ~1e-6 with the signed table; ~0.24 rms with magnitudes only).
_SYNTH_D = ISO_WINDOW.astype(np.float64) * 32.0


class SynthesisFilterbank:
    """ISO 11172-3 polyphase synthesis, one instance per channel."""

    def __init__(self):
        self.v = np.zeros(1024, dtype=np.float64)

    def run(self, subband_samples: np.ndarray) -> np.ndarray:
        """subband_samples: [32] -> 32 PCM samples."""
        self.v[64:] = self.v[:-64]
        self.v[:64] = _SYNTH_N @ subband_samples
        u = np.zeros(512, dtype=np.float64)
        for i in range(8):
            u[i * 64 : i * 64 + 32] = self.v[i * 128 : i * 128 + 32]
            u[i * 64 + 32 : i * 64 + 64] = self.v[i * 128 + 96 : i * 128 + 128]
        w = u * _SYNTH_D
        return w.reshape(16, 32).sum(axis=0)


@dataclass
class DecodedStream:
    pcm: np.ndarray  # [n_samples, channels] float32
    sample_rate: int
    channels: int
    frame_count: int


def _iter_frames(data: bytes, strict: bool = True):
    """Walk frames; with strict=False, stop at the first malformed or
    truncated frame instead of raising (real-world decoder behavior).
    Free-format streams (bitrate index 0) get their constant frame size
    inferred once from the first frame's sync spacing."""
    i = 0
    free_size = 0
    while i + 4 <= len(data):
        try:
            if (
                data[i] == 0xFF
                and (data[i + 1] & 0xE0) == 0xE0
                and ((data[i + 2] >> 4) & 0xF) == 0
                and not free_size
            ):
                free_size = _free_format_size(data, i)
            fi = parse_frame(data, i, free_size)
        except (ValueError, IndexError, ZeroDivisionError):
            if strict:
                raise
            return
        if not strict and i + fi.size > len(data):
            return  # truncated final frame
        yield fi
        i += fi.size


def _parse_lame_gapless(xing_frame: bytes, channels: int):
    """(delay, padding) from a LAME info-tag, or None if absent/invalid.
    Independent re-derivation of the de-facto tag format (the encoder's
    writer lives in io/xing.py; this parser validates against it AND
    against what mpg123 accepts — tests/test_gapless.py)."""
    side = 17 if channels == 1 else 32
    for base in (4 + side, 4 + side + 2):  # without / with a CRC field
        if xing_frame[base : base + 4] in (b"Xing", b"Info"):
            break
    else:
        return None
    if len(xing_frame) < base + 8:
        return None
    flags = int.from_bytes(xing_frame[base + 4 : base + 8], "big")
    off = base + 8
    off += 4 * bool(flags & 0x1)  # frames
    off += 4 * bool(flags & 0x2)  # bytes
    off += 100 * bool(flags & 0x4)  # TOC
    off += 4 * bool(flags & 0x8)  # quality
    end = off + 36
    if len(xing_frame) < end or not xing_frame[off : off + 4] == b"LAME":
        return None
    # tag CRC-16 (reflected poly 0xA001, init 0) over everything before it
    crc = 0
    for byte in xing_frame[: end - 2]:
        crc ^= byte
        for _ in range(8):
            crc = ((crc >> 1) ^ 0xA001) if (crc & 1) else (crc >> 1)
    if crc != int.from_bytes(xing_frame[end - 2 : end], "big"):
        return None
    b0, b1, b2 = xing_frame[off + 21 : off + 24]
    return (b0 << 4) | (b1 >> 4), ((b1 & 0xF) << 8) | b2


def decode_mp3(
    data: bytes,
    skip_metadata_frames: bool = True,
    iso_conventions: bool = False,
    gapless: bool = False,
) -> DecodedStream:
    """Decode an MP3 byte stream to PCM.

    gapless=True honors a LAME info-tag's delay/padding fields the way
    gapless-aware players do (skip delay+529 at the start, trim
    padding-529 at the end — see options.gapless_info); without a valid
    tag it is a no-op.

    Skips an ID3v2 prefix and (optionally) a leading Xing/Info metadata
    frame, and stops at a truncated/malformed tail — like real-world
    decoders do.

    iso_conventions selects between decode laws NO header bit signals
    (every other law is read from the stream itself):
    - False (default): this encoder family's historical conventions —
      M/S reconstruction L = M+S, R = M-S (matching the encoder's
      mid=(L+R)/2 halves, MP3Encoder.swift:2146-2154); switching
      granules' entropy stream read in the subband-major natural order
      (no ISO 2.4.3.4.8 reordering); mixed blocks fully alias-reduced.
    - True: what a conforming ISO 11172-3 decoder implements —
      L = (M+S)/sqrt(2), R = (M-S)/sqrt(2) (ISO 2.4.3.4.9.2); the
      2.4.3.4.8 reorder-undo for switching granules; mixed blocks
      alias-reduced on the long-head boundary only. Use for streams
      encoded with options.iso_ms_matrix / iso_short_blocks (the
      spec_strict preset); reading a compat stream this way reproduces
      exactly the conformance errors real decoders would (the point).

    Short/mixed scalefactors are always parsed per ISO 2.4.2.7 and applied
    in requantization — convention-independent (zero-width for streams
    that emit scalefac_compress=0 on switching granules).
    """
    if data[:3] == b"ID3" and len(data) >= 10:
        size = (data[6] << 21) | (data[7] << 14) | (data[8] << 7) | data[9]
        data = data[10 + size :]

    frames = list(_iter_frames(data, strict=False))
    gapless_trim = None  # (delay, padding) from a LAME info tag
    if skip_metadata_frames and frames:
        f0 = frames[0]
        body = data[f0.offset + 4 : f0.offset + f0.size]
        if b"Xing" in body[:40] or b"Info" in body[:40]:
            if gapless:
                gapless_trim = _parse_lame_gapless(
                    data[f0.offset : f0.offset + f0.size], f0.channels
                )
            frames = frames[1:]
    if not frames:
        return DecodedStream(np.zeros((0, 1), np.float32), 44100, 1, 0)

    sr = frames[0].sample_rate
    channels = frames[0].channels
    # M/S is signalled PER FRAME by the header's mode_extension (ISO
    # 2.4.2.3); computed inside the loop below. Reference-compat streams
    # hardcode 0b10 on every joint frame, so this changes nothing for them.

    store = bytearray()
    overlaps = [np.zeros((32, 18), dtype=np.float64) for _ in range(channels)]
    synths = [SynthesisFilterbank() for _ in range(channels)]
    pcm_out = []

    for fi in frames:
        start_bit = (len(store) - fi.main_data_begin) * 8
        store += fi.main_data
        if start_bit < 0:
            # reservoir underrun (stream cut): skip frame, keep bytes
            continue
        r = BitReader(bytes(store), start_bit)
        n_gr = len(fi.granules)  # 1 for LSF frames, 2 for MPEG-1
        granule_pcm = np.zeros((n_gr, channels, 576), dtype=np.float64)
        gr_xr = [[None] * channels for _ in range(n_gr)]  # requantized spectra
        gr0_sf = [None] * channels  # granule 0 scalefactors for scfsi reuse
        gr_sf = [[None] * channels for _ in range(n_gr)]  # long sf (intensity pos)
        gr_sfs = [[None] * channels for _ in range(n_gr)]  # short sf [12][3]
        gr_sfml = [[None] * channels for _ in range(n_gr)]  # mixed long head [8]
        gr_rzero = [[0] * channels for _ in range(n_gr)]  # decoded nonzero extent
        gr_slen = [None] * n_gr  # right-ch per-band slen (LSF intensity)
        ok = True
        frame_is_mode = (
            channels == 2
            and fi.mode == 0b01
            and (fi.mode_extension & 0b01)
        )
        for gr in range(n_gr):
            # Intensity frames defer alias reduction until AFTER stereo
            # processing (the ISO 2.4.3.4 order). M/S commutes with the
            # alias butterflies (one scalar mix for every line), so the
            # pre-stereo placement is equivalent for everything this
            # encoder family emits — but intensity's per-band gains do NOT
            # commute with butterflies that straddle band boundaries
            # (measured: ~31 dB vs libmpg123 in the wrong order, ~130 dB in
            # ISO order). Deferral needs BOTH channels long-layout (the
            # stereo mix must see the same alias state on both).
            # Pure short granules carry no butterflies, so deferral only
            # matters for long-layout and MIXED granules (mixed joined
            # round 5: the head-interior intensity reading puts IS bands
            # under the head butterfly, which does not commute with
            # per-band gains — same lesson as the round-3 long-IS trap).
            defer_alias = frame_is_mode and all(
                not (
                    fi.granules[gr][c].window_switching
                    and fi.granules[gr][c].block_type == 2
                    and not fi.granules[gr][c].mixed_block_flag
                )
                for c in range(channels)
            )
            for ch in range(channels):
                g = fi.granules[gr][ch]
                part_start = r.pos
                scalefacs = None
                sf_short = None  # [12][3] per (short sfb, window)
                sf_mixed_long = None  # [8] long head bands of a mixed block
                if fi.lsf:
                    # ISO 13818-3 LSF law (9-bit compress, implicit preflag)
                    intensity_ch = (
                        ch == 1 and fi.mode == 0b01 and (fi.mode_extension & 0b01)
                    )
                    scalefacs, sf_short, sf_mixed_long, sf_widths = (
                        _read_lsf_scalefactors(r, g, bool(intensity_ch))
                    )
                    if intensity_ch:
                        # per-band slen widths: the LSF illegal-position
                        # marker is each band's own all-ones value
                        gr_slen[gr] = sf_widths
                elif g.window_switching and g.block_type == 2 and not g.mixed_block_flag:
                    # pure short: sfb-major, windows consecutive
                    # (ISO 2.4.2.7: sfbs 0-5 at slen1, 6-11 at slen2)
                    slen1, slen2 = SLEN[g.scalefac_compress]
                    sf_short = [[0, 0, 0] for _ in range(12)]
                    for sfb in range(12):
                        slen = slen1 if sfb < 6 else slen2
                        for w in range(3):
                            sf_short[sfb][w] = r.read(slen) if slen else 0
                elif g.window_switching and g.block_type == 2 and g.mixed_block_flag:
                    # mixed: 8 long bands at slen1, short sfbs 3-5 at slen1,
                    # 6-11 at slen2 (per window)
                    slen1, slen2 = SLEN[g.scalefac_compress]
                    sf_mixed_long = [r.read(slen1) if slen1 else 0 for _ in range(8)]
                    sf_short = [[0, 0, 0] for _ in range(12)]
                    for sfb in range(3, 12):
                        slen = slen1 if sfb < 6 else slen2
                        for w in range(3):
                            sf_short[sfb][w] = r.read(slen) if slen else 0
                else:
                    slen1, slen2 = SLEN[g.scalefac_compress]
                    # scfsi (ISO 2.4.2.7): granule 1 reuses gr0's values for
                    # flagged groups (0-5, 6-10, 11-15, 16-20) — no bits read
                    share = (
                        fi.scfsi[ch]
                        if gr == 1 and fi.scfsi is not None and gr0_sf[ch]
                        else [0, 0, 0, 0]
                    )
                    groups = ((0, 6), (6, 11), (11, 16), (16, 21))
                    scalefacs = [0] * 21
                    for gi, (lo, hi) in enumerate(groups):
                        for band in range(lo, hi):
                            slen = slen1 if band < 11 else slen2
                            if share[gi]:
                                scalefacs[band] = gr0_sf[ch][band]
                            else:
                                scalefacs[band] = r.read(slen)
                    if gr == 0:
                        gr0_sf[ch] = scalefacs
                gr_sf[gr][ch] = scalefacs
                gr_sfs[gr][ch] = sf_short
                gr_sfml[gr][ch] = sf_mixed_long
                try:
                    q = _decode_granule_spectrum(r, g, sr, part_start)
                except (ValueError, IndexError):
                    ok = False
                    break
                nzq = np.nonzero(q)[0]
                gr_rzero[gr][ch] = int(nzq[-1]) + 1 if nzq.size else 0
                # jump to the granule's declared end (robustness)
                r.pos = part_start + g.part23_length
                is_short_g = g.window_switching and g.block_type == 2
                if iso_conventions and is_short_g:
                    # ISO 2.4.3.4.8 reorder-undo: the conforming stream is
                    # short-sfb-major; scatter back to subband-major for
                    # the IMDCT. (The encoder-family convention emits
                    # subband-major directly — no reorder.)
                    dest = short_reorder_dest(sr, bool(g.mixed_block_flag))
                    nat = np.zeros(576, dtype=q.dtype)
                    nat[dest] = q
                    q = nat
                xr = _requantize(q, g, sr, scalefacs, sf_short, sf_mixed_long)
                if not is_short_g:
                    if not defer_alias:  # intensity: alias AFTER stereo
                        xr = _alias_reduce_decode(xr)
                elif g.mixed_block_flag and not defer_alias:
                    # conforming decoders alias-reduce ONE boundary (the
                    # subband 0/1 junction) for mixed blocks at EVERY rate
                    # — the synthesis head stays 2 subbands even at 8 kHz
                    # where the stream-layout head is 72 lines (see
                    # tables.mixed_head, mpg123-arbitrated); the legacy
                    # reading kept the full 31 (historical oracle behavior
                    # for reference-law streams, which alias nothing).
                    # Intensity frames defer (block-aware) past stereo.
                    xr = _alias_reduce_decode(xr, 1 if iso_conventions else 31)
                gr_xr[gr][ch] = xr
            if not ok:
                break
            # Mid/side reconstruction happens in the SPECTRAL domain before
            # the IMDCT (ISO 2.4.3.4.9: the synthesis state then always
            # stays in the L/R domain, so per-frame mode_extension flips —
            # iso_mode_ext streams — carry no cross-domain overlap tails).
            # Matrix law: this encoder family's mid=(L+R)/2, side=(L-R)/2,
            # so L=m+s, R=m-s; ISO's own convention is /sqrt(2) — a
            # documented conformance boundary (see ARCHITECTURE.md). Each
            # channel keeps its own window side-info for the IMDCT, as
            # conforming decoders do even when block types differ. Running
            # this per granule (not per frame) means a later granule's
            # decode failure still lets earlier granules advance the
            # overlap state, like a streaming decoder.
            ms_mode = fi.mode == 0b01 and (fi.mode_extension & 0b10)
            is_mode = fi.mode == 0b01 and (fi.mode_extension & 0b01)
            if channels == 2 and (ms_mode or is_mode):
                m, s_ = gr_xr[gr][0], gr_xr[gr][1]
                if ms_mode:
                    # iso_conventions: ISO 2.4.3.4.9.2 divides by sqrt(2)
                    # (inverts an (L+-R)/sqrt(2) encode at unit gain); the
                    # encoder-family law inverts mid=(L+R)/2 with L=M+S.
                    k = 1.0 / np.sqrt(2.0) if iso_conventions else 1.0
                    out_l, out_r = (m + s_) * k, (m - s_) * k
                else:
                    out_l, out_r = m.copy(), s_.copy()
                if is_mode and defer_alias and gr_sf[gr][1] is not None:
                    # ISO 2.4.3.4.9.3 intensity stereo (long-layout
                    # granules): scalefactor bands at or above the right
                    # channel's decoded zero part carry an intensity
                    # position in the RIGHT channel's scalefactor slot;
                    # both channels are reconstructed from the LEFT
                    # channel's requantized values, split per _is_factors
                    # (MPEG-1 tan law / LSF 2^(-pos/4) law — the LSF
                    # illegal marker is per-band all-ones, gr_slen). The
                    # sfb21 tail (above the last band bound) rides band
                    # 20's position, the reference-decoder (dist10)
                    # convention.
                    bounds = np.concatenate(
                        [[0], np.cumsum(band_table(sr))]
                    ).astype(int)
                    rz = gr_rzero[gr][1]
                    spos = gr_sf[gr][1]
                    iscale = fi.granules[gr][1].scalefac_compress & 1
                    slens = gr_slen[gr]
                    for b in range(22):
                        lo = int(bounds[b])
                        hi = int(bounds[b + 1]) if b < 21 else 576
                        if lo < rz or lo >= hi:
                            continue
                        bb = min(b, 20)
                        fac = _is_factors(
                            spos[bb], fi.lsf, iscale,
                            slens[bb] if slens is not None else 0,
                        )
                        if fac is None:
                            continue
                        kl, kr = fac
                        seg = m[lo:hi]  # pre-matrix left channel
                        out_l[lo:hi] = seg * kl
                        out_r[lo:hi] = seg * kr
                elif is_mode and gr_sfs[gr][1] is not None:
                    # Short-window intensity: per (short sfb, window), with
                    # the zero-part bound computed PER WINDOW (natural index
                    # of (line, w) is 3*line + w, so window w's lines are
                    # the w::3 stride). The tail above the last short band
                    # bound rides band 11's position. Pure short blocks
                    # carry no alias butterflies, so no deferral is needed.
                    # Requires BOTH channels the same switching layout (the
                    # intensity source is the left spectrum; mixing window
                    # layouts has no defined reading — see shared_ms_blocks).
                    # MIXED granules use the same per-(band, window) law on
                    # the short region (lines >= 12 per window; short sfbs
                    # 3-11). When the right channel's zero part reaches
                    # INSIDE the long head (its entire short region zero),
                    # the head bands from the zero extent up are intensity
                    # too — the LONG-band law with positions in the right
                    # channel's mixed long-head slots (round-5 reading,
                    # mpg123-arbitrated: hand-assembled head-interior
                    # producers read ~9 dB under the old head-keeps-L/R
                    # reading and ~130 dB with this one); head bands BELOW
                    # the extent keep their M/S or L/R reading. The head's
                    # only alias butterfly (subband 0/1 boundary, lines
                    # 10..26) sits entirely below line 36, so the
                    # pre-stereo head alias reduction still commutes only
                    # when the head is not intensity-processed; mixed IS
                    # granules are on the defer_alias path regardless
                    # (is_mode streams defer aliasing past stereo).
                    g2l, g2r = fi.granules[gr][0], fi.granules[gr][1]
                    both_short = all(
                        g2.window_switching and g2.block_type == 2
                        for g2 in (g2l, g2r)
                    )
                    if both_short and g2l.mixed_block_flag == g2r.mixed_block_flag:
                        mixed = bool(g2r.mixed_block_flag)
                        sb = np.concatenate(
                            [[0], np.cumsum(short_band_table(sr))]
                        ).astype(int)
                        # head geometry (lines/window, first short sfb):
                        # 12/3 at MPEG-1 rates — see tables.mixed_head
                        hl, hs = mixed_head(sr)
                        base = hl // 3 if mixed else 0
                        first_sfb = hs if mixed else 0
                        spos = gr_sfs[gr][1]
                        lines = 192
                        for w in range(3):
                            nzw = np.nonzero(s_[3 * base + w :: 3])[0]
                            rzw = base + (int(nzw[-1]) + 1 if nzw.size else 0)
                            for s in range(first_sfb, 13):
                                lo = int(sb[s]) if s < 12 else int(sb[12])
                                hi = int(sb[s + 1]) if s < 12 else lines
                                if lo < rzw or lo >= hi:
                                    continue
                                ss = min(s, 11)
                                slen_sw = (
                                    gr_slen[gr][ss][w]
                                    if fi.lsf and gr_slen[gr] is not None
                                    else 0
                                )
                                fac = _is_factors(
                                    spos[ss][w], fi.lsf,
                                    fi.granules[gr][1].scalefac_compress & 1,
                                    slen_sw,
                                )
                                if fac is None:
                                    continue
                                kl, kr = fac
                                idx = 3 * np.arange(lo, hi) + w
                                seg = m[idx]
                                out_l[idx] = seg * kl
                                out_r[idx] = seg * kr
                        if (
                            mixed
                            and gr_sfml[gr][1] is not None
                            and not fi.lsf
                        ):
                            # Head-interior bound (round 5): when the right
                            # channel's zero part reaches inside the long
                            # head (every short window zero), head bands
                            # from the zero extent up are intensity with
                            # the LONG-band law — positions in the right
                            # channel's mixed long-head slots. The sfb21-
                            # tail convention has no head analogue: the
                            # head's last band ends exactly at the head
                            # boundary. (LSF mixed head slens are not
                            # retained — LSF head-interior stays on the
                            # short-region-only reading.)
                            all_zero_short = all(
                                not np.any(s_[3 * base + w2 :: 3])
                                for w2 in range(3)
                            )
                            nzh = np.nonzero(s_[: 3 * base])[0]
                            rzh = int(nzh[-1]) + 1 if nzh.size else 0
                            if all_zero_short:
                                lbn = np.concatenate(
                                    [[0], np.cumsum(band_table(sr))]
                                ).astype(int)
                                hpos = gr_sfml[gr][1]
                                nlong = int(
                                    np.searchsorted(lbn, 3 * base, "left")
                                )
                                for b in range(nlong):
                                    lo = int(lbn[b])
                                    hi = min(int(lbn[b + 1]), 3 * base)
                                    if lo < rzh or lo >= hi:
                                        continue
                                    fac = _is_factors(
                                        hpos[b], fi.lsf,
                                        fi.granules[gr][1].scalefac_compress
                                        & 1,
                                        0,
                                    )
                                    if fac is None:
                                        continue
                                    kl, kr = fac
                                    seg = m[lo:hi]
                                    out_l[lo:hi] = seg * kl
                                    out_r[lo:hi] = seg * kr
                gr_xr[gr][0], gr_xr[gr][1] = out_l, out_r
            if defer_alias:
                for c2 in range(2):
                    g2 = fi.granules[gr][c2]
                    if g2.window_switching and g2.block_type == 2:
                        # mixed: the single head boundary (pure short never
                        # reaches here — excluded from deferral)
                        nb = 1 if iso_conventions else 31
                    else:
                        nb = 31
                    gr_xr[gr][c2] = _alias_reduce_decode(gr_xr[gr][c2], nb)
            for ch in range(channels):
                g = fi.granules[gr][ch]
                sub = _imdct_granule(gr_xr[gr][ch], g, overlaps[ch])
                granule_pcm[gr, ch] = sub.T.reshape(-1)  # time-major [18*32]
        if not ok:
            continue
        frame_pcm = np.zeros((576 * n_gr, channels), dtype=np.float64)
        for gr in range(n_gr):
            sub_t = granule_pcm[gr].reshape(channels, 18, 32)  # [ch, t, sb]
            for ch in range(channels):
                synth = synths[ch]
                for t in range(18):
                    frame_pcm[gr * 576 + t * 32 : gr * 576 + (t + 1) * 32, ch] = (
                        synth.run(sub_t[ch, t])
                    )
        pcm_out.append(frame_pcm)
        if len(store) > 2048:
            del store[:-1024]

    pcm = (
        np.concatenate(pcm_out, axis=0).astype(np.float32)
        if pcm_out
        else np.zeros((0, channels), np.float32)
    )
    if gapless_trim is not None and len(pcm):
        delay, padding = gapless_trim
        start = min(delay + 529, len(pcm))
        end = len(pcm) - max(padding - 529, 0)
        pcm = pcm[start : max(end, start)]
    return DecodedStream(pcm, sr, channels, len(frames))

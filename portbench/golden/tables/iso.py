"""ISO/IEC 11172-3 lookup tables: scalefactor bands, bitrates, modes, aliasing.

Parity references: MP3Encoder.swift:1809-1897 (scalefactor bands),
:2509-2556 (bitrate/samplerate/mode), :1568-1575 (Table B.9 aliasing coefficients).
"""

from __future__ import annotations

import numpy as np

# --- Scale factor bands (ISO Table B.8, long-block widths, 21 bands) ---------
LONG_BANDS = {
    44100: np.array(
        [4, 4, 4, 4, 4, 4, 6, 6, 8, 8, 10, 12, 16, 20, 24, 28, 34, 42, 50, 54, 76],
        dtype=np.int32,
    ),
    48000: np.array(
        [4, 4, 4, 4, 4, 4, 6, 6, 6, 8, 10, 12, 16, 18, 22, 28, 34, 40, 46, 54, 54],
        dtype=np.int32,
    ),
    32000: np.array(
        [4, 4, 4, 4, 4, 4, 6, 6, 8, 10, 12, 16, 20, 24, 30, 38, 46, 56, 68, 84, 102],
        dtype=np.int32,
    ),
}

# Short block band widths (ISO Table B.8, 12 coded bands per window; the
# remainder up to the 192 lines/window is an uncoded 13th band, like long
# band 21). The reference carries 44100 only (MP3Encoder.swift:1823); 48000
# and 32000 are from ISO Table B.8 directly (needed for short-block
# conformance at those rates — options.iso_short_blocks).
SHORT_BANDS = {
    44100: np.array([4, 4, 4, 4, 6, 8, 10, 12, 14, 18, 22, 30], dtype=np.int32),
    48000: np.array([4, 4, 4, 4, 6, 6, 10, 12, 14, 16, 20, 26], dtype=np.int32),
    32000: np.array([4, 4, 4, 4, 6, 8, 12, 16, 20, 26, 34, 42], dtype=np.int32),
}

# Reference-parity alias (12 bands, applied 3 times). MP3Encoder.swift:1823.
SHORT_BANDS_44100 = SHORT_BANDS[44100]

# --- MPEG-2/2.5 (LSF, ISO/IEC 13818-3) scalefactor bands ----------------------
# Encode-side capability beyond the reference (its header writer is
# MPEG-1-only, MP3Encoder.swift:2533-2544). Transcribed from ISO 13818-3
# Table B.2 as read by lame/mpg123; the 24 kHz long row carries the
# corrigendum band 17/18 boundary at line 332 (ffmpeg reads 330 — lame and
# mpg123 disagree with it, see decoder/_lsf_data.py). A test pins these
# rows equal to the decoder's machine-extracted libavcodec copy
# (tests/test_lsf_encode.py), keeping the two independent spec copies in
# lockstep.
LSF_LONG_BANDS = {
    22050: np.array(
        [6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58],
        dtype=np.int32,
    ),
    24000: np.array(
        [6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 18, 22, 26, 32, 38, 46, 54, 62, 70, 76],
        dtype=np.int32,
    ),
    16000: np.array(
        [6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58],
        dtype=np.int32,
    ),
    11025: np.array(
        [6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58],
        dtype=np.int32,
    ),
    12000: np.array(
        [6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58],
        dtype=np.int32,
    ),
    8000: np.array(
        [12, 12, 12, 12, 12, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 76, 90, 2, 2, 2, 2],
        dtype=np.int32,
    ),
}

LSF_SHORT_BANDS = {
    22050: np.array([4, 4, 4, 6, 6, 8, 10, 14, 18, 26, 32, 42], dtype=np.int32),
    24000: np.array([4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 32, 44], dtype=np.int32),
    16000: np.array([4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40], dtype=np.int32),
    11025: np.array([4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40], dtype=np.int32),
    12000: np.array([4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40], dtype=np.int32),
    8000: np.array([8, 8, 8, 12, 16, 20, 24, 28, 36, 2, 2, 2], dtype=np.int32),
}


def lsf_version(sample_rate: int) -> int:
    """0 = MPEG-1, 1 = MPEG-2 (ISO 13818-3 LSF), 2 = MPEG-2.5 — derived
    from the sample rate (each rate belongs to exactly one version)."""
    return {22050: 1, 24000: 1, 16000: 1, 11025: 2, 12000: 2, 8000: 2}.get(
        sample_rate, 0
    )


def short_band_table(sample_rate: int) -> np.ndarray:
    """Short-block band width table. LSF rates (8-24 kHz) get their real
    ISO 13818-3 rows (beyond-reference capability — the reference would
    mislabel such streams as 44.1 kHz MPEG-1); truly unknown rates fall
    back to 44100 (mirroring band_table's dispatch quirk)."""
    if sample_rate in LSF_SHORT_BANDS:
        return LSF_SHORT_BANDS[sample_rate]
    return SHORT_BANDS.get(sample_rate, SHORT_BANDS[44100])


def short_band_bounds(sample_rate: int) -> np.ndarray:
    """Per-window line boundaries incl. 0 and the uncoded tail to 192:
    [0, b1, ..., b12, 192] (14 entries, 13 bands)."""
    w = short_band_table(sample_rate)
    return np.concatenate([[0], np.cumsum(w), [192]]).astype(np.int64)


def short_reorder_src(sample_rate: int) -> np.ndarray:
    """ISO 2.4.3.4.8 spectral reordering for pure short blocks, as a source
    permutation: stream[j] = natural[src[j]].

    Natural (IMDCT-side) layout of this encoder family — and of the ISO
    decoder AFTER its reordering step — is subband-major: coefficient
    sb*18 + 3m + w == 3*line + w with line = 6*sb + m (window w's m-th
    frequency in subband sb; MP3Encoder.swift:1639-1662 writes index
    w + 3m per subband). The Huffman STREAM a conforming decoder reads is
    short-sfb-major with the three windows of a band consecutive:
    position 3*start(sfb) + w*width(sfb) + i for line start(sfb)+i.
    """
    bounds = short_band_bounds(sample_rate)
    src = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        for w in range(3):
            for line in range(int(s), int(e)):
                src.append(3 * line + w)
    return np.asarray(src, dtype=np.int64)


def mixed_reorder_src(sample_rate: int) -> np.ndarray:
    """Reordering source permutation for mixed blocks: the stream-layout
    long head (the first 3 short bands' worth of natural coefficients, in
    natural order) is not reordered; lines above follow the short-sfb law
    from short band 3 up. The head is 3*cumsum(short_bands)[2] natural
    coefficients — 36 at every rate except MPEG-2.5 8 kHz, whose wider
    bands make it 72 (== the 6-long-band ISO 13818-3 head; the decoder's
    validated hybrid reading, see decoder.tables.mixed_head). ISO B.8 is
    built so the split lands on a band boundary at every rate."""
    head_l = int(np.cumsum(short_band_table(sample_rate))[2])  # lines/window
    bounds = [int(b) for b in short_band_bounds(sample_rate) if b >= head_l]
    src = list(range(3 * head_l))
    for s, e in zip(bounds[:-1], bounds[1:]):
        for w in range(3):
            for line in range(s, e):
                src.append(3 * line + w)
    return np.asarray(src, dtype=np.int64)


def band_table(sample_rate: int) -> np.ndarray:
    """Long-block band width table. LSF rates get their real ISO 13818-3
    rows (see LSF_LONG_BANDS); any truly unknown rate falls back to 44100.

    Matches MP3Encoder.swift:1879-1888 (default branch -> 44100 table) for
    the MPEG-1 family; the reference has no LSF behavior to be parity with
    (its band dispatch would silently use 44.1 kHz bands at these rates).
    """
    if sample_rate in LSF_LONG_BANDS:
        return LSF_LONG_BANDS[sample_rate]
    return LONG_BANDS.get(sample_rate, LONG_BANDS[44100])


def switch_bound(sample_rate: int, pure_short: bool) -> int:
    """Line boundary of entropy region 0 for window-switching START/STOP
    and pure-SHORT granules (MIXED granules have their own de-facto law,
    see mixed_switch_bound): BAND-DERIVED, not a fixed 36 — the first 8
    long bands for start/stop granules, 3x the first 3 short bands for
    pure short granules (ISO 2.4.2.7 region_address semantics as read by
    lame/mpg123/ffmpeg; validated externally in tests/test_lsf.py). At
    every MPEG-1 rate both expressions evaluate to exactly 36 — the
    constant the reference (and rounds 1-2 here) hardcoded is a
    MPEG-1-rate coincidence. LSF: 54 at 11.025-24 kHz (108 at 8 kHz) for
    start/stop; 72 at 8 kHz for pure short."""
    if pure_short:
        return 3 * int(np.sum(short_band_table(sample_rate)[:3]))
    return int(np.sum(band_table(sample_rate)[:8]))


def mixed_switch_bound(sample_rate: int) -> int:
    """Entropy region-0 boundary for MIXED granules, as conforming
    decoders actually read it — measured, not derived from ISO text.

    ISO 13818-3's region_address semantics (first 8 long bands) would
    give 54 at every MPEG-2 rate; libmpg123 instead reads by MPEG
    VERSION: MPEG-1 and MPEG-2 granules get the MPEG-1 constant 36
    (band-derived == 36 at MPEG-1 rates, so only MPEG-2 differs), while
    MPEG-2.5 granules get the band-derived 8-band law (54 at
    11.025/12 kHz, 108 at 8 kHz — the 2.5 decode path evidently carries
    the band-derived law the MPEG-2 path never got). Measured round 5
    with self-consistent hand-assembled mixed streams whose region-0/1
    tables differ (a bound mismatch then desyncs the Huffman read):
    emitting at {36,44,54,72,108} and decoding with a bound-matched
    oracle, libmpg123 agrees at ~128 dB ONLY at 36 for 16/22.05/24 kHz,
    ONLY at 54 for 11.025/12 kHz, and ONLY at 108 for 8 kHz; every
    other candidate reads ~21 dB or -inf (tests/test_lsf.py pins the
    matrix). The 8 kHz agreement is why the round-3/4 producers (8 kHz
    only, or equal tables in both regions) never tripped it. This is
    the de-facto law and the encoder must emit what decoders read."""
    if lsf_version(sample_rate) == 2:  # MPEG-2.5: band-derived
        return int(np.sum(band_table(sample_rate)[:8]))
    return 36  # MPEG-1 (band-derived coincidence) + MPEG-2 (constant)


def band_count(sample_rate: int, is_short: bool) -> int:
    """Number of scale factor bands (MP3Encoder.swift:1891-1896)."""
    if is_short:
        return 12
    return len(band_table(sample_rate))


# --- Bitrate / samplerate / mode tables --------------------------------------
# MPEG-1 Layer III bitrate index table (kbps), index 0 = free, 15 = bad.
BITRATE_TABLE_V1 = np.array(
    [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0],
    dtype=np.int32,
)
# MPEG-2 Layer III table — used by the reference only for sampleRate < 32000
# in bitrateIndex lookup (MP3Encoder.swift:2511-2515).
BITRATE_TABLE_V2 = np.array(
    [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0],
    dtype=np.int32,
)


def bitrate_index(bitrate_kbps: int, sample_rate: int) -> int:
    """Bitrate index with closest-match fallback (MP3Encoder.swift:2509-2523).

    Exact match wins; otherwise the first entry with minimal absolute distance
    (ties keep the earlier index, matching Swift's `min(by:)` semantics).
    """
    table = BITRATE_TABLE_V1 if sample_rate >= 32000 else BITRATE_TABLE_V2
    exact = np.nonzero(table == bitrate_kbps)[0]
    if exact.size:
        return int(exact[0])
    dist = np.abs(table - bitrate_kbps)
    return int(np.argmin(dist))  # argmin keeps the first minimal entry


def bitrate_value(index: int) -> int:
    """Bitrate in kbps for an MPEG-1 index (MP3Encoder.swift:2526-2530)."""
    if 0 <= index < len(BITRATE_TABLE_V1):
        return int(BITRATE_TABLE_V1[index])
    return 128


def bitrate_value_lsf(index: int) -> int:
    """Bitrate in kbps for an LSF (MPEG-2/2.5) index. Same fallback shape
    as bitrate_value; the LSF table tops out at 160 kbps."""
    if 0 <= index < len(BITRATE_TABLE_V2):
        return int(BITRATE_TABLE_V2[index])
    return 64


def sample_rate_index(sample_rate: int) -> int:
    """Header sample-rate index bits. MPEG-1 rates per the reference
    (MP3Encoder.swift:2533-2544, unknown rates map to 44100's index 0);
    LSF rates per ISO 13818-3 (index within their own version's table:
    22050/11025 -> 0, 24000/12000 -> 1, 16000/8000 -> 2)."""
    return {
        44100: 0, 48000: 1, 32000: 2,
        22050: 0, 24000: 1, 16000: 2,
        11025: 0, 12000: 1, 8000: 2,
    }.get(sample_rate, 0)


def mode_bits(mode: str) -> tuple[int, int]:
    """(mode, mode_extension) header bits (MP3Encoder.swift:2547-2556).

    Note the reference always sets mode_extension=0b10 (M/S on) for joint
    stereo regardless of the per-frame M/S decision; reproduced here.
    """
    return {
        "mono": (0b11, 0),
        "joint_stereo": (0b01, 0b10),
        "stereo": (0b00, 0),
    }[mode]


# --- Aliasing reduction coefficients (ISO Table B.9) -------------------------
# cs[i]^2 + ca[i]^2 == 1; applied across the 31 subband boundaries for long
# blocks (MP3Encoder.swift:1568-1575).
ALIASING_CS = np.array(
    [0.857492926, 0.881741997, 0.949628649, 0.983314592,
     0.995517816, 0.999160558, 0.999899195, 0.999993155],
    dtype=np.float32,
)
ALIASING_CA = np.array(
    [-0.514495755, -0.471731969, -0.313377454, -0.181913200,
     -0.094574193, -0.040965583, -0.014198569, -0.003699975],
    dtype=np.float32,
)

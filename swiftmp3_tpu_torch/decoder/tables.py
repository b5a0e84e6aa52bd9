"""Independent ISO/IEC 11172-3 constants for the decode oracle.

The decoder imports NOTHING from the encoder's table modules (the round-1
oracle did, making round-trip tests circular — a transcription slip in a
shared table would have passed silently). Everything here is either:

- an independent transcription (Huffman tables 1-9 below, written from the
  public ISO B.7 tables in the layout LAME's tables.c uses; scalefactor
  band widths, Table B.8),
- a derivation from first-principles literals (aliasing cs/ca from the
  eight Table B.9 ci values; IMDCT/synthesis matrices from their closed
  forms in decoder.py), or
- a physically separate generated copy where the table is too large to
  re-type safely (_spec_data.py: the 512-coefficient Table C.1 window and
  table 15), anchored by spec-property tests (perfect reconstruction;
  Kraft-completeness + prefix-freeness + independent spot literals).

tests/test_table_independence.py cross-checks this module against the
encoder's tables and validates the spec properties of both.

DISCOVERED REFERENCE BUG: the reference's Huffman tables 10 and 13
(MP3Encoder.swift:2288-2504) are corrupt — table 10 has a codeword that is
a prefix of two others, table 13 has 3 duplicate codewords and ~25 prefix
violations. Both are dead code in the reference (its encoder only ever
emits table 15, :717/:791). The encoder package keeps byte-parity copies of
the corrupt tables (component #34), but this decoder does not support
table_select 10/13 — no conforming stream can use a non-prefix-free code,
and our encoder never emits them.
"""

from __future__ import annotations

import numpy as np

from ._lsf_data import LSF_BAND_LONG as _LSF_LONG
from ._lsf_data import LSF_BAND_SHORT as _LSF_SHORT
from ._spec_data import ISO_ANALYSIS_WINDOW, TABLE15_CODES, TABLE15_LENGTHS

# --- Scalefactor bands (ISO Table B.8, long blocks, 21 bands) ----------------
# Independent transcription; widths per band, summing to 576.

_LONG_BANDS = {
    44100: (4, 4, 4, 4, 4, 4, 6, 6, 8, 8, 10, 12, 16, 20, 24, 28, 34, 42, 50, 54, 76),
    48000: (4, 4, 4, 4, 4, 4, 6, 6, 6, 8, 10, 12, 16, 18, 22, 28, 34, 40, 46, 54, 54),
    32000: (4, 4, 4, 4, 4, 4, 6, 6, 8, 10, 12, 16, 20, 24, 30, 38, 46, 56, 68, 84, 102),
}


def band_table(sample_rate: int) -> np.ndarray:
    """Long-block band widths; unknown rates fall back to 44100 (matching
    the encoder's dispatch quirk so both sides parse the same stream).
    MPEG-2/2.5 LSF rates (ISO 13818-3, <= 24000 Hz) dispatch by the same
    key — the rate sets are disjoint — from the libavcodec-extracted rows
    (_lsf_data.py, decode-side third-party stream coverage only)."""
    if sample_rate in _LSF_LONG:
        return np.asarray(_LSF_LONG[sample_rate], dtype=np.int32)
    return np.asarray(_LONG_BANDS.get(sample_rate, _LONG_BANDS[44100]), dtype=np.int32)


# Short-block band widths (ISO Table B.8; 12 coded bands per window, the
# remainder to 192 lines/window is uncoded). Independent transcription —
# the encoder's copies live in swiftmp3_tpu/tables/iso.py and
# tests/test_table_independence.py cross-checks the two.

_SHORT_BANDS = {
    44100: (4, 4, 4, 4, 6, 8, 10, 12, 14, 18, 22, 30),
    48000: (4, 4, 4, 4, 6, 6, 10, 12, 14, 16, 20, 26),
    32000: (4, 4, 4, 4, 6, 8, 12, 16, 20, 26, 34, 42),
}


def short_band_table(sample_rate: int) -> np.ndarray:
    """Short-block band widths (44100 fallback; LSF rates like band_table)."""
    if sample_rate in _LSF_SHORT:
        return np.asarray(_LSF_SHORT[sample_rate], dtype=np.int32)
    return np.asarray(
        _SHORT_BANDS.get(sample_rate, _SHORT_BANDS[44100]), dtype=np.int32
    )


def mixed_head(sample_rate: int) -> tuple:
    """(head_lines, first_short_sfb) of a MIXED granule's STREAM-LAYOUT
    long head: the first 3 short bands' worth of lines stay in natural
    order and the short-reorder/scalefactor map starts at short sfb 3 —
    36 lines at every rate except MPEG-2.5 8 kHz, whose wider bands make
    it 72 (ISO 13818-3's 6-long-band head).

    IMPORTANT (mpg123-arbitrated, 8 kHz producer probe, round 4): this
    head governs ONLY the stream layout — reorder extent and scalefactor
    band map. The IMDCT long/short switch point and the alias-reduction
    boundary count do NOT follow it: conforming decoders keep the
    universal 2-subband (36-line) synthesis head and ONE aliased
    boundary at every rate, so at 8 kHz natural lines 36..72 are
    DEQUANTIZED as long bands 3-5 but SYNTHESIZED as short windows.
    Candidate unified readings measured on the hand-assembled 8 kHz
    mixed producer (tests/test_lsf.py): ISO-6-band-everywhere = 0.2 dB
    vs mpg123, dist10-8-band-everywhere = 4.0 dB; the hybrid (72-line
    layout + 2-subband/1-boundary synthesis) = ~130 dB on every content
    region, isolated per-knob (reorder x imdct x alias grid)."""
    sb = np.cumsum(short_band_table(sample_rate))
    return 3 * int(sb[2]), 3


def mixed_region_bound(sample_rate: int) -> int:
    """Entropy region-0 line boundary for MIXED granules — the de-facto
    decoder law, measured against libmpg123 round 5 (NOT the ISO 13818-3
    region_address derivation, which would give 54 at every MPEG-2 rate):
    MPEG-1 and MPEG-2 granules read the MPEG-1 constant 36; MPEG-2.5
    granules read the band-derived first-8-long-bands law (54 at
    11.025/12 kHz, 108 at 8 kHz). Bound-discriminating producers (region
    tables forced distinct) agree with libmpg123 at ~128 dB at exactly
    one candidate per rate — tests/test_lsf.py pins the matrix.

    Independent transcription of the same law as the encoder's
    tables.iso.mixed_switch_bound (decoder/encoder table independence);
    a lockstep test asserts the two agree at every rate."""
    if sample_rate in (11025, 12000, 8000):  # MPEG-2.5
        return int(np.cumsum(band_table(sample_rate))[7])
    return 36


def short_reorder_dest(sample_rate: int, mixed: bool) -> np.ndarray:
    """ISO 2.4.3.4.8 reordering as a destination map: the Huffman stream's
    j-th requantized value lands at natural[dest[j]].

    Derived from the decoder direction of the ISO text (dist10's
    III_reorder structure): the stream walks short scalefactor bands in
    order, the three windows of a band consecutively; window w's value for
    line l lands at natural position 3*l + w (the subband-major layout the
    IMDCT consumes). Mixed blocks keep their long-head values in place
    (see mixed_head: 36 lines at MPEG-1 rates, 54 at 11.025-24 kHz, 108
    at 8 kHz) and reorder the lines above.
    """
    widths = short_band_table(sample_rate)
    starts = list(np.concatenate([[0], np.cumsum(widths), [192]]).astype(int))
    head_l = mixed_head(sample_rate)[0] // 3  # lines/window under the head
    dest = list(range(3 * head_l)) if mixed else []
    for sfb in range(13):  # 12 coded bands + the uncoded remainder band
        s, e = starts[sfb], starts[sfb + 1]
        if mixed and e <= head_l:
            continue  # covered by the long head (ISO B.8 puts a band
            # boundary exactly at the head line for every rate)
        for w in range(3):
            for line in range(s, e):
                dest.append(3 * line + w)
    return np.asarray(dest, dtype=np.int64)


# --- Aliasing reduction (ISO Table B.9) ---------------------------------------
# Derived from the eight ci literals: cs = 1/sqrt(1+ci^2), ca = ci*cs.

_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037])
ALIASING_CS = (1.0 / np.sqrt(1.0 + _CI * _CI)).astype(np.float32)
ALIASING_CA = (_CI / np.sqrt(1.0 + _CI * _CI)).astype(np.float32)

# --- Analysis/synthesis window (ISO Table C.1 / D.1) --------------------------
ISO_WINDOW = np.asarray(ISO_ANALYSIS_WINDOW, dtype=np.float32)

# --- Huffman tables (ISO Table B.7) -------------------------------------------
# Independent transcriptions in LAME tables.c layout: per table, flat
# row-major (x * n + y) codeword bits (HB) and lengths (l).

_T1_HB = (1, 1, 1, 0)
_T1_L = (1, 3, 2, 3)

_T2_HB = (1, 2, 1, 3, 1, 1, 3, 2, 0)
_T2_L = (1, 3, 6, 3, 3, 5, 5, 5, 6)

_T3_HB = (3, 2, 1, 1, 1, 1, 3, 2, 0)
_T3_L = (2, 2, 6, 3, 2, 5, 5, 5, 6)

_T5_HB = (1, 2, 6, 5, 3, 1, 4, 4, 7, 5, 7, 1, 6, 1, 1, 0)
_T5_L = (1, 3, 6, 7, 3, 3, 6, 7, 6, 6, 7, 8, 7, 6, 7, 8)

_T6_HB = (7, 3, 5, 1, 6, 2, 3, 2, 5, 4, 4, 1, 3, 3, 2, 0)
_T6_L = (3, 3, 5, 7, 3, 2, 4, 5, 4, 4, 5, 6, 6, 5, 6, 7)

_T7_HB = (
    1, 2, 10, 19, 16, 10,
    3, 3, 7, 10, 5, 3,
    11, 4, 13, 17, 8, 4,
    12, 11, 18, 15, 11, 2,
    7, 6, 9, 14, 3, 1,
    6, 4, 5, 3, 2, 0,
)
_T7_L = (
    1, 3, 6, 8, 8, 9,
    3, 4, 6, 7, 7, 8,
    6, 5, 7, 8, 8, 9,
    7, 7, 8, 9, 9, 9,
    7, 7, 8, 9, 9, 10,
    8, 8, 9, 10, 10, 10,
)

_T8_HB = (
    3, 4, 6, 18, 12, 5,
    5, 1, 2, 16, 9, 3,
    7, 3, 5, 14, 7, 3,
    19, 17, 15, 13, 10, 4,
    13, 5, 8, 11, 5, 1,
    12, 4, 4, 1, 1, 0,
)
_T8_L = (
    2, 3, 6, 8, 8, 9,
    3, 2, 4, 8, 8, 8,
    6, 4, 6, 8, 8, 9,
    8, 8, 8, 9, 9, 10,
    8, 7, 8, 9, 10, 10,
    9, 8, 9, 9, 11, 11,
)

_T9_HB = (
    7, 5, 9, 14, 15, 7,
    6, 4, 5, 5, 6, 7,
    7, 6, 8, 8, 8, 5,
    15, 6, 9, 10, 5, 1,
    11, 7, 9, 6, 4, 1,
    14, 4, 6, 2, 6, 0,
)
_T9_L = (
    3, 3, 5, 6, 8, 9,
    3, 3, 4, 5, 6, 8,
    4, 4, 5, 6, 7, 8,
    6, 5, 6, 7, 7, 8,
    7, 6, 7, 7, 8, 9,
    8, 7, 8, 8, 9, 9,
)

_FLAT_TABLES = {
    1: (2, _T1_L, _T1_HB),
    2: (3, _T2_L, _T2_HB),
    3: (3, _T3_L, _T3_HB),
    5: (4, _T5_L, _T5_HB),
    6: (4, _T6_L, _T6_HB),
    7: (6, _T7_L, _T7_HB),
    8: (6, _T8_L, _T8_HB),
    9: (6, _T9_L, _T9_HB),
    15: (16, TABLE15_LENGTHS, TABLE15_CODES),
}


def huffman_arrays(table_id: int) -> tuple[np.ndarray, np.ndarray]:
    """(lengths [n, n], codes [n, n]) int32 for a supported table id."""
    n, lens, codes = _FLAT_TABLES[table_id]
    return (
        np.asarray(lens, dtype=np.int32).reshape(n, n),
        np.asarray(codes, dtype=np.int32).reshape(n, n),
    )


SUPPORTED_TABLE_IDS = tuple(sorted(_FLAT_TABLES))

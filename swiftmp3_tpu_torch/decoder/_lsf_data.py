"""MPEG-2/2.5 (LSF) Layer III decode tables (GENERATED FILE).

Generated by tools/extract_lsf_tables.py from the system libavcodec
(ffmpeg) mpegaudio decoder tables — an external, conformance-grade
copy of the ISO 13818-3 data. The MPEG-1 rows were verified equal
to this repo's independent ISO 11172-3 B.8 transcription at
extraction time; the LSF rows are validated behaviorally against
libmpg123 (tests/test_lsf.py). Do not edit by hand.
"""

# sample_rate -> 21 long scalefactor band widths (remainder excluded)
LSF_BAND_LONG = {
    22050: (6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58),
    24000: (6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 18, 22, 26, 32, 38, 46, 54, 62, 70, 76),
    16000: (6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58),
    11025: (6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58),
    12000: (6, 6, 6, 6, 6, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 38, 46, 52, 60, 68, 58),
    8000: (12, 12, 12, 12, 12, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 76, 90, 2, 2, 2, 2),
}

# sample_rate -> 12 short scalefactor band widths
LSF_BAND_SHORT = {
    22050: (4, 4, 4, 6, 6, 8, 10, 14, 18, 26, 32, 42),
    24000: (4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 32, 44),
    16000: (4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40),
    11025: (4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40),
    12000: (4, 4, 4, 6, 8, 10, 12, 14, 18, 24, 30, 40),
    8000: (8, 8, 8, 12, 16, 20, 24, 28, 36, 2, 2, 2),
}

# [decomposition case 0-5][window class: 0 long, 1 short, 2 mixed] -> 4 group sizes
LSF_NSF_TABLE = (((6, 5, 5, 5), (9, 9, 9, 9), (6, 9, 9, 9)), ((6, 5, 7, 3), (9, 9, 12, 6), (6, 9, 12, 6)), ((11, 10, 0, 0), (18, 18, 0, 0), (15, 18, 0, 0)), ((7, 7, 7, 0), (12, 12, 12, 0), (6, 15, 12, 0)), ((6, 6, 6, 3), (12, 9, 9, 6), (6, 12, 9, 6)), ((8, 8, 5, 0), (15, 12, 9, 0), (6, 18, 9, 0)))

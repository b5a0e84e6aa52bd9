"""MDCT matrices and windows for MPEG-1 Layer III.

Long: 18x36 cosine matrix, 36-sample sine window, /9 normalization.
Short: 6x12 cosine matrix, 12-sample sine window, /3 normalization.
Start/stop transition windows are defined (as in the reference,
MP3Encoder.swift:1470-1503) but unused by the pipeline; kept for the future
spec-strict mode.
Parity reference: MP3Encoder.swift:1422-1467, 1619-1662.
"""

from __future__ import annotations

import numpy as np


def _mdct_matrix(n: int) -> np.ndarray:
    half = n // 2
    m = np.arange(half, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    angle = np.pi / (2.0 * n) * (2.0 * k + 1.0 + n / 2.0) * (2.0 * m + 1.0)
    return np.cos(angle).astype(np.float32)


def _sine_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return np.sin(np.pi / n * (i + 0.5)).astype(np.float32)


# [18, 36] long-block MDCT cosine matrix.
LONG_MDCT_MATRIX = _mdct_matrix(36)
# [6, 12] short-block MDCT cosine matrix.
SHORT_MDCT_MATRIX = _mdct_matrix(12)
# 36-sample sine window for long blocks.
LONG_WINDOW = _sine_window(36)
# 12-sample sine window for short blocks.
SHORT_WINDOW = _sine_window(12)


def _start_window() -> np.ndarray:
    w = np.zeros(36, dtype=np.float64)
    i = np.arange(36, dtype=np.float64)
    w[:18] = np.sin(np.pi / 36.0 * (i[:18] + 0.5))
    w[18:24] = 1.0
    w[24:30] = np.sin(np.pi / 12.0 * (i[24:30] - 18.0 + 0.5))
    w[30:] = 0.0
    return w.astype(np.float32)


def _stop_window() -> np.ndarray:
    w = np.zeros(36, dtype=np.float64)
    i = np.arange(36, dtype=np.float64)
    w[:6] = 0.0
    w[6:12] = np.sin(np.pi / 12.0 * (i[6:12] - 6.0 + 0.5))
    w[12:18] = 1.0
    w[18:] = np.sin(np.pi / 36.0 * (i[18:] + 0.5))
    return w.astype(np.float32)


# 36-sample long->short / short->long transition windows (currently unused by
# the frame pipeline, mirroring the reference behavior).
START_WINDOW = _start_window()
STOP_WINDOW = _stop_window()

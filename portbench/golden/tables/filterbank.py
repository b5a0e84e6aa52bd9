"""Polyphase analysis filterbank constants.

The 32x64 cosine analysis matrix M[k][n] = cos((2k+1)(n-16) * pi/64) and the
512-coefficient ISO Table C.1 analysis window.
Parity reference: MP3Encoder.swift:1196-1206 (matrix), :1209-1354 (window).
"""

from __future__ import annotations

import numpy as np

from ._iso_window_data import ISO_ANALYSIS_WINDOW

# 512-tap ISO Table C.1 analysis window (float32, as in the reference).
ISO_WINDOW = np.asarray(ISO_ANALYSIS_WINDOW, dtype=np.float32)
assert ISO_WINDOW.shape == (512,)


def _analysis_matrix() -> np.ndarray:
    k = np.arange(32, dtype=np.float64)[:, None]
    n = np.arange(64, dtype=np.float64)[None, :]
    angle = np.pi / 64.0 * (2.0 * k + 1.0) * (n - 16.0)
    return np.cos(angle).astype(np.float32)


# [32, 64] analysis cosine matrix, float32 (computed in float64 then cast,
# matching the reference's Double->Float construction).
ANALYSIS_MATRIX = _analysis_matrix()

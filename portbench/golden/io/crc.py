"""CRC-16 with the MPEG polynomial 0x8005, init 0xFFFF.

Parity note: the reference applies the CRC to the 4-byte frame header only
(before side info is appended), not header+side-info as ISO 11172-3 specifies
(MP3Encoder.swift:540-543). The framing layer reproduces that behavior.
"""

from __future__ import annotations

import numpy as np


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            if crc & 0x8000:
                crc = ((crc << 1) ^ 0x8005) & 0xFFFF
            else:
                crc = (crc << 1) & 0xFFFF
        table[i] = crc
    return table


_TABLE = _build_table()


def crc16_mpeg(data: bytes) -> int:
    """CRC-16/MPEG over `data` (MP3Encoder.swift:2208-2215)."""
    crc = 0xFFFF
    for byte in data:
        crc = ((crc << 8) & 0xFFFF) ^ int(_TABLE[((crc >> 8) ^ byte) & 0xFF])
    return crc

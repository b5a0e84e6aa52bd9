"""Minimal RIFF/WAVE reader + writer (PCM16 and float32), numpy-based.

Test and benchmark convenience — the encoder itself consumes raw float PCM.
"""

from __future__ import annotations

import struct

import numpy as np


def write_wav(path, pcm: np.ndarray, sample_rate: int, channels: int = 1) -> None:
    """pcm: interleaved float32 in [-1, 1] (written as PCM16)."""
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    data = (np.clip(pcm, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        byte_rate = sample_rate * channels * 2
        block_align = channels * 2
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path) -> tuple[np.ndarray, int, int]:
    """Returns (interleaved float32 pcm, sample_rate, channels).

    Supports PCM16 (format 1) and float32 (format 3) WAV files.
    """
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError("missing fmt/data chunk")
        audio_format, channels, sample_rate, _, _, bits = fmt
        if audio_format == 1 and bits == 16:
            pcm = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif audio_format == 3 and bits == 32:
            pcm = np.frombuffer(data, dtype="<f4").astype(np.float32)
        else:
            raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit")
        return pcm, sample_rate, channels

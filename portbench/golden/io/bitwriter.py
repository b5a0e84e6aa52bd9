"""MSB-first bit packer for headers, side info and Huffman data.

Behavior parity with the reference BitstreamWriter (MP3Encoder.swift:2218-2275):
MSB-first writes, bit_count property, pad_to_byte with zero bits. Values wider
than the requested count are masked to the low `count` bits.
"""

from __future__ import annotations


class BitstreamWriter:
    __slots__ = ("_bytes", "_acc", "_nbits")

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0  # bit accumulator, holds _nbits valid low bits
        self._nbits = 0

    @property
    def bit_count(self) -> int:
        """Total number of bits written so far."""
        return len(self._bytes) * 8 + self._nbits

    def write(self, bits: int, count: int) -> None:
        """Write `count` bits of `bits`, MSB first. count may be 0..64."""
        if count <= 0:
            return
        self._acc = (self._acc << count) | (bits & ((1 << count) - 1))
        self._nbits += count
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def pad_to_byte(self) -> None:
        """Pad to the next byte boundary with zero bits."""
        if self._nbits:
            self._bytes.append((self._acc << (8 - self._nbits)) & 0xFF)
            self._acc = 0
            self._nbits = 0

    @property
    def data(self) -> bytes:
        """Bytes written so far (whole bytes only; pending bits excluded)."""
        return bytes(self._bytes)

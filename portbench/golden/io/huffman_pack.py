"""Vectorized Huffman bit-packing of quantized spectra into main_data bytes.

This is the host half of the entropy coder: the device computes quantized
values, big_values and exact bit counts (swiftmp3_tpu.ops.huffman_bits); this
module renders the identical bits as bytes. Pure numpy, no Python-per-bit
loops: per-pair variable-length chunks (table-15 codeword + sign bits, max 15
bits) are expanded to a bit matrix, compacted row-major, and packed with
np.packbits — matching the reference's MSB-first writer + final pad-to-byte
(MP3Encoder.swift:1705-1737, :729).
"""

from __future__ import annotations

import numpy as np

from ..tables import TABLE15_CODE, TABLE15_LEN

# Table-15 pairs need 15 bits (13-bit codeword + 2 signs); linbits pairs
# (options.linbits_tables, 24-family ESC) need up to 12 + 2*13 + 2 = 40.
_MAX_CHUNK_BITS = 40
_BIT_COLS = np.arange(_MAX_CHUNK_BITS, dtype=np.int32)[None, :]


def pair_chunks_table15(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-pair (chunk, nbits) for table-15 encoding of `values`.

    `values` is a 1-D int array of even length (an odd tail is paired with 0,
    mirroring MP3Encoder.swift:1716-1718). Chunk layout: codeword bits, then
    sign bit of x if |x|>0, then sign bit of y if |y|>0 (0=positive).
    """
    values = np.asarray(values, dtype=np.int64)
    if values.size % 2:
        values = np.concatenate([values, np.zeros(1, dtype=np.int64)])
    x = values[0::2]
    y = values[1::2]
    ax = np.minimum(np.abs(x), 15)
    ay = np.minimum(np.abs(y), 15)
    idx = ax * 16 + ay
    code = TABLE15_CODE[idx].astype(np.int64)
    nbits = TABLE15_LEN[idx].astype(np.int64)

    sx = (x < 0).astype(np.int64)
    has_x = (ax != 0).astype(np.int64)
    chunk = np.where(has_x == 1, (code << 1) | sx, code)
    nbits = nbits + has_x

    sy = (y < 0).astype(np.int64)
    has_y = (ay != 0).astype(np.int64)
    chunk = np.where(has_y == 1, (chunk << 1) | sy, chunk)
    nbits = nbits + has_y
    return chunk, nbits


def pack_chunks(chunks: np.ndarray, nbits: np.ndarray) -> tuple[bytes, int]:
    """Pack MSB-first variable-length chunks into bytes (zero pad-to-byte).

    Returns (bytes, total_bits_before_padding).
    """
    if chunks.size == 0:
        return b"", 0
    n = nbits.astype(np.int32)
    total_bits = int(n.sum())
    # bit j of a chunk (MSB first) = (chunk >> (len-1-j)) & 1, valid for j < len
    shifts = n[:, None] - 1 - _BIT_COLS
    bitmat = (chunks[:, None] >> np.maximum(shifts, 0)) & 1
    valid = _BIT_COLS < n[:, None]
    bits = bitmat[valid].astype(np.uint8)  # row-major compaction keeps order
    return np.packbits(bits, bitorder="big").tobytes(), total_bits


def pair_chunks_generic(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-pair chunks with automatic smallest-table selection.

    Mirrors the reference's generic HuffmanEncoder.encode/selectTable
    (MP3Encoder.swift:1740-1806): per pair, the smallest table covering
    max(|x|, |y|) is chosen from 1 -> 2 -> 5 -> 7 -> 10 -> 15. Present for
    component parity — the pipeline's hot path is table 15 only (the
    reference writes table_select=[15,15,15], so a decoder would misread
    streams packed this way; kept for the future spec-strict mode, where
    table_select must be emitted accordingly).
    """
    from ..tables import HUFFMAN_TABLES

    values = np.asarray(values, dtype=np.int64)
    if values.size % 2:
        values = np.concatenate([values, np.zeros(1, dtype=np.int64)])
    x = values[0::2]
    y = values[1::2]
    ax = np.minimum(np.abs(x), 15)
    ay = np.minimum(np.abs(y), 15)
    m = np.maximum(ax, ay)
    chunks = np.zeros(len(x), dtype=np.int64)
    nbits = np.zeros(len(x), dtype=np.int64)
    for i in range(len(x)):
        for tid in (1, 2, 5, 7, 10, 15):
            t = HUFFMAN_TABLES[tid]
            if m[i] <= t.max_value:
                break
        code = int(t.codes[ax[i], ay[i]])
        ln = int(t.lengths[ax[i], ay[i]])
        chunk = code
        if ax[i]:
            chunk = (chunk << 1) | (1 if x[i] < 0 else 0)
            ln += 1
        if ay[i]:
            chunk = (chunk << 1) | (1 if y[i] < 0 else 0)
            ln += 1
        chunks[i] = chunk
        nbits[i] = ln
    return chunks, nbits


def pack_pairs_table1(values: np.ndarray) -> tuple[bytes, int]:
    """Table-1 pairwise encoding (values 0-1), mirroring
    MP3Encoder.swift:1670-1702. Unused by the pipeline; component parity."""
    from ..tables import HUFFMAN_TABLES

    t1 = HUFFMAN_TABLES[1]
    values = np.asarray(values, dtype=np.int64)
    if values.size % 2:
        values = np.concatenate([values, np.zeros(1, dtype=np.int64)])
    x = values[0::2]
    y = values[1::2]
    ax = np.minimum(np.abs(x), 1)
    ay = np.minimum(np.abs(y), 1)
    code = t1.codes[ax, ay].astype(np.int64)
    nbits = t1.lengths[ax, ay].astype(np.int64)
    chunk = np.where(ax != 0, (code << 1) | (x < 0), code)
    nbits = nbits + (ax != 0)
    chunk = np.where(ay != 0, (chunk << 1) | (y < 0), chunk)
    nbits = nbits + (ay != 0)
    return pack_chunks(chunk, nbits)


def pack_frame_main_data(
    quantized: np.ndarray, big_values: np.ndarray
) -> tuple[bytes, np.ndarray]:
    """Pack one frame's main data: all granule/channel spectra in order.

    quantized: [n_granule_ch, 576] int array (granule-major: gr0ch0, gr0ch1,
    gr1ch0, gr1ch1 — the reference's write order, MP3Encoder.swift:652-727).
    big_values: [n_granule_ch] pair counts.
    Returns (main_data bytes incl. final pad-to-byte, per-part bit counts
    [n_granule_ch] == part2_3_length values).
    """
    all_chunks = []
    all_nbits = []
    part_bits = np.zeros(len(big_values), dtype=np.int64)
    for g in range(len(big_values)):
        bv = int(big_values[g])
        chunk, nbits = pair_chunks_table15(quantized[g, : bv * 2])
        part_bits[g] = int(nbits.sum())
        all_chunks.append(chunk)
        all_nbits.append(nbits)
    chunks = np.concatenate(all_chunks) if all_chunks else np.zeros(0, dtype=np.int64)
    nbits = np.concatenate(all_nbits) if all_nbits else np.zeros(0, dtype=np.int64)
    data, _ = pack_chunks(chunks, nbits)
    return data, part_bits

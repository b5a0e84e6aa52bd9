"""ISO Table B.7 Huffman code tables as numpy arrays.

The encoder's hot path uses table 15 only (16x16, values 0-15, no linbits),
matching the reference (table_select=[15,15,15], MP3Encoder.swift:717, :791).
All other tables present in the reference (1,2,3,5,6,7,8,9,10,13) are exposed
for the generic encoder path and the decoder oracle.
Parity reference: MP3Encoder.swift:2277-2504.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ._huffman_data import (
    SMALL_TABLES,
    TABLE13_CODES,
    TABLE13_LENGTHS,
    TABLE15_CODES,
    TABLE15_LENGTHS,
)


@dataclass(frozen=True)
class HuffmanTable:
    """A Huffman pair-code table: codeword lengths and bits indexed [x, y]."""

    table_id: int
    max_value: int
    lengths: np.ndarray  # [max_value+1, max_value+1] int32
    codes: np.ndarray    # [max_value+1, max_value+1] int32


def _small(table_id: int) -> HuffmanTable:
    max_value, rows = SMALL_TABLES[table_id]
    n = max_value + 1
    lengths = np.zeros((n, n), dtype=np.int32)
    codes = np.zeros((n, n), dtype=np.int32)
    for x in range(n):
        for y in range(n):
            lengths[x, y], codes[x, y] = rows[x][y]
    return HuffmanTable(table_id, max_value, lengths, codes)


def _big(table_id: int, lengths_flat, codes_flat) -> HuffmanTable:
    lengths = np.asarray(lengths_flat, dtype=np.int32).reshape(16, 16)
    codes = np.asarray(codes_flat, dtype=np.int32).reshape(16, 16)
    return HuffmanTable(table_id, 15, lengths, codes)


HUFFMAN_TABLES: dict[int, HuffmanTable] = {
    **{tid: _small(tid) for tid in SMALL_TABLES},
    13: _big(13, TABLE13_LENGTHS, TABLE13_CODES),
    15: _big(15, TABLE15_LENGTHS, TABLE15_CODES),
}

# Hot-path constants: table 15 lengths/codes, flat [256] for device gathers
# (index = x * 16 + y).
TABLE15_LEN = HUFFMAN_TABLES[15].lengths.reshape(-1).copy()
TABLE15_CODE = HUFFMAN_TABLES[15].codes.reshape(-1).copy()

# --- count1 (quadruple) tables, ISO Table B.7 ---------------------------------
# Indexed by the quadruple's nonzero pattern v*8 + w*4 + x*2 + y (v first in
# the stream). Table A is a variable-length code; table B is the fixed 4-bit
# code 15 - pattern. Used by the spec-strict count1_coding flag; the decode
# oracle carries an independent copy (cross-checked in tests).
COUNT1A_LEN = np.array(
    [1, 4, 4, 5, 4, 6, 5, 6, 4, 5, 5, 6, 5, 6, 6, 6], dtype=np.int32
)
COUNT1A_CODE = np.array(
    [1, 5, 4, 5, 6, 5, 4, 4, 7, 3, 6, 0, 7, 2, 3, 1], dtype=np.int32
)

# Spec-strict per-region table choice: smallest VALID table covering the
# region's max |value| (the reference's generic selectTable walks
# 1->2->5->7->10->15, MP3Encoder.swift:1763-1778, but its tables 10/13 are
# corrupt — see decoder/tables.py — so the strict path skips 10).
SELECT_TABLE_IDS = (1, 2, 5, 7, 15)
SELECT_TABLE_MAXVALS = (1, 2, 3, 5, 15)


def table_for_max(max_value: int) -> int:
    """Smallest valid Huffman table id covering `max_value` (0 = no table:
    the region is all zeros and costs no bits)."""
    if max_value == 0:
        return 0
    for tid, mv in zip(SELECT_TABLE_IDS, SELECT_TABLE_MAXVALS):
        if max_value <= mv:
            return tid
    return 15


# --- linbits (ESC) family, ISO Table B.7 tables 16-31 -------------------------
# Pair tables 16 and 24 with per-id linbits extensions: a symbol of 15 is
# followed by `linbits` raw magnitude bits coding (|value| - 15), then the
# sign. The reference carries none of these (its law caps |q| at 15 —
# MP3Encoder.swift:808 clamps to the table-15 domain — which caps decoded
# SNR at a bitrate-INDEPENDENT ceiling). options.linbits_tables breaks that
# ceiling; data machine-extracted from libavcodec (tools/extract_b7_tables.py),
# validated against the decoder's independent copy + libmpg123 behaviorally.
from ._linbits_data import (  # noqa: E402
    TABLE16_CODES,
    TABLE16_LENGTHS,
    TABLE24_CODES,
    TABLE24_LENGTHS,
)

HUFFMAN_TABLES[16] = _big(16, TABLE16_LENGTHS, TABLE16_CODES)
HUFFMAN_TABLES[24] = _big(24, TABLE24_LENGTHS, TABLE24_CODES)

TABLE24_LEN = HUFFMAN_TABLES[24].lengths.reshape(-1).copy()
TABLE24_CODE = HUFFMAN_TABLES[24].codes.reshape(-1).copy()

# table_select -> linbits for the 24-family (ISO B.7 headers); the encoder
# uses only this family for ESC regions (flat code lengths suit large
# values; max codeword 12 bits keeps device pack slots narrow).
LINBITS_24 = (4, 5, 6, 7, 8, 9, 11, 13)
QCAP_LINBITS = 15 + (1 << 13) - 1  # 8206: table 31's max codable |value|


def linbits_table_for_max(max_value: int) -> tuple[int, int]:
    """(table_id, linbits) for a big-values region under the linbits law:
    classic smallest-table choice for max <= 15, else the smallest
    24-family id whose linbits extension covers (max - 15)."""
    if max_value <= 15:
        return table_for_max(max_value), 0
    need = int(max_value - 15).bit_length()
    for i, lb in enumerate(LINBITS_24):
        if lb >= need:
            return 24 + i, lb
    return 31, 13

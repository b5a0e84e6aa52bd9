"""L1 host-side bitstream & metadata serialization.

Variable-length byte streams don't fit fixed-shape tensors, so frame assembly
(header, CRC, side info, reservoir slot splicing, Xing/ID3) runs on the host.
The numbers feeding it (main_data_begin, slot sizes, Huffman bit counts) are
computed frame at a time by the golden encoder (`..encoder`).
"""

from .bitwriter import BitstreamWriter
from .crc import crc16_mpeg
from .id3 import build_id3_tag
from .sideinfo import GranuleInfo, build_side_info
from .huffman_pack import pack_frame_main_data
from .xing import build_xing_header, generate_toc

__all__ = [
    "BitstreamWriter",
    "GranuleInfo",
    "build_id3_tag",
    "build_side_info",
    "build_xing_header",
    "crc16_mpeg",
    "generate_toc",
    "pack_frame_main_data",
]

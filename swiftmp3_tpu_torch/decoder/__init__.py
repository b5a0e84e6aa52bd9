"""Independent MP3 decoder oracle (pure numpy, ISO 11172-3 semantics).

Fills the role AVFoundation plays in the reference test suite
(SwiftMP3Tests.swift:653-660): an independent decoder used to verify that
encoded streams are structurally valid and that audio survives a round trip.
Implements MPEG-1 Layer III decoding: header/side-info parsing, bit-reservoir
main-data assembly, Huffman decoding, ISO requantization, aliasing reduction,
IMDCT with overlap-add, and the polyphase synthesis filterbank.

Not a performance path — this runs host-side in tests only.
"""

from .decoder import DecodedStream, decode_mp3

__all__ = ["DecodedStream", "decode_mp3"]

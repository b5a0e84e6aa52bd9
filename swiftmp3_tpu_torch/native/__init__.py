"""Native (C++) host runtime: frame rendering at memory speed.

The variable-length byte path (Huffman pack, side info, reservoir splice,
frame assembly) is pure integer/byte work, so it runs as native code on the
host. Built with g++ at first use into `swiftmp3_tpu_torch/_build/` and
loaded via ctypes; a failed build raises. The Python path in
`swiftmp3_tpu_torch.io.framing` remains the behavioral reference (tests
assert byte equality).
"""

from .lib import NativeStreamRenderer

__all__ = ["NativeStreamRenderer"]

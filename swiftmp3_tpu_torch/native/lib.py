"""ctypes bindings + on-demand build of the native frame renderer.

The library builds with g++ at first use into the git-ignored
`swiftmp3_tpu_torch/_build/` (not beside the source); a failed build
raises with the compiler's output. Its translation unit is
`render_batch.cpp`, which includes the renderer (`frame_render.cpp`) and
adds the batched entry point `mp3_render_batch` (`render_batch`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..options import MP3EncoderOptions
from ..tables import mode_bits, sample_rate_index

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD_DIR, "libmp3render.so")
_SRC = os.path.join(_DIR, "render_batch.cpp")
# every file the library is built from: a newer one rebuilds it
_SOURCES = tuple(os.path.join(_DIR, n) for n in ("render_batch.cpp", "frame_render.cpp", "tables_gen.h"))

# The meta fields of a packed frame in the order of mp3_render_batch's
# `layout` argument (its enum MetaField).
BATCH_FIELDS = (
    "bitrate_index", "padding", "mdb", "slot", "part23", "big_values", "gain", "block_type",
    "preflag", "region0", "region1", "subblock_gain", "table_select", "count1table",
    "scalefac_compress", "scfsi", "mode_ext",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    """Compile _SRC into _SO; raises RuntimeError with the
    compiler's output if g++ is missing or fails. Builds to a per-process
    temporary name and renames, so concurrent builders never load a
    half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = os.path.join(_BUILD_DIR, f"libmp3render.{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, cwd=_DIR)
    except FileNotFoundError as e:
        raise RuntimeError(f"native renderer build failed: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(
            f"native renderer build failed (g++ exit {r.returncode}):\n"
            f"{r.stdout}{r.stderr}"
        )
    os.replace(tmp, _SO)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(map(os.path.getmtime, _SOURCES)):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.mp3_stream_new.restype = ctypes.c_void_p
        lib.mp3_stream_new.argtypes = [ctypes.c_int] * 13
        lib.mp3_stream_free.argtypes = [ctypes.c_void_p]
        lib.mp3_frame_count.restype = ctypes.c_uint32
        lib.mp3_frame_count.argtypes = [ctypes.c_void_p]
        lib.mp3_total_bytes.restype = ctypes.c_uint32
        lib.mp3_total_bytes.argtypes = [ctypes.c_void_p]
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mp3_render_batch.restype = None
        lib.mp3_render_batch.argtypes = [
            vp, vp, vp, i32,  # states, rows, counts, n_rows
            i32, i64, vp, i32,  # cap, frame_stride, layout, meta_words
            vp, i64,  # arena, slot_capacity
            vp, i64,  # frame_sizes_out, sizes_stride
            vp, vp,  # written_out, n_emitted_out
        ]
        lib.mp3_flush_buffered.restype = ctypes.c_int64
        lib.mp3_flush_buffered.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, i32p, i32p
        ]
        _lib = lib
        return _lib


def check_written(n: int) -> None:
    """Raise for a render's negative byte count: -2, a frame's main_data
    past the device pack's cap; any other, an output buffer too small."""
    if n == -2:
        raise RuntimeError(
            "device pack cap exceeded (rate-loop overflow); raise "
            "main_data_cap for this configuration"
        )
    if n < 0:
        raise RuntimeError("native render buffer overflow")


def render_batch(states, rows, counts, cap: int, frame_stride: int, layout, arena, sizes, written, emitted) -> None:
    """Render a range of a batch's streams with one mp3_render_batch call,
    which runs without the interpreter lock. Each argument but `cap` and
    `frame_stride` is a C-contiguous numpy array, a row a stream: `states`
    and `rows` uintp (each stream's `handle`, the address of its first
    packed frame), `counts` int32 (its frames), `arena` uint8 [n, slot]
    (its bytes out), `sizes` int32 [n, >= its frames] (the sizes of the
    frames it emits), `written` int64 (its byte count, or what
    check_written raises for) and `emitted` int32 (its emitted frames).
    `layout` int32: each of BATCH_FIELDS' first word in a frame's meta,
    then the meta's words; the meta follows `cap` bytes of main_data, and
    frames lie `frame_stride` bytes apart."""
    _load().mp3_render_batch(
        states.ctypes.data, rows.ctypes.data, counts.ctypes.data, len(states),
        cap, frame_stride, layout.ctypes.data, int(layout[-1]),
        arena.ctypes.data, arena.shape[1], sizes.ctypes.data, sizes.shape[1],
        written.ctypes.data, emitted.ctypes.data,
    )


class NativeStreamRenderer:
    """A stream's native render state: `handle` is what `render_batch` takes
    for the stream, `flush_buffered` emits its held frames at the end, and
    `frame_sizes`, `frame_count` and `total_bytes` are what it has emitted
    (the Xing header's input). The bytes equal `io.framing.FrameAssembler`'s
    on the same chunk outputs."""

    def __init__(self, options: MP3EncoderOptions):
        lib = _load()
        self._lib = lib
        self.options = options
        mb, me = mode_bits(options.mode.value)
        self._h = lib.mp3_stream_new(
            options.channels,
            sample_rate_index(options.sample_rate),
            1 if options.crc_protected else 0,
            1 if options.copyright else 0,
            1 if options.original else 0,
            mb,
            me,
            1 if options.reservoir_mode == "aligned" else 0,
            1 if options.iso_crc else 0,
            1 if options.real_scalefactors else 0,
            1 if options.iso_short_blocks else 0,
            int(options.reservoir_depth),
            int(options.lsf),  # 0/1/2 = MPEG-1/2/2.5 (one-granule LSF
            # side info, 8-bit mdb, 255-byte reservoir reach)
        )
        self.frame_sizes: list[int] = []

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mp3_stream_free(h)
            self._h = None

    @property
    def handle(self) -> int:
        """The address of the stream's native state (mp3_render_batch's
        `states`)."""
        return self._h

    @property
    def frame_count(self) -> int:
        return int(self._lib.mp3_frame_count(self._h))

    @property
    def total_bytes(self) -> int:
        return int(self._lib.mp3_total_bytes(self._h))

    def flush_buffered(self) -> bytes:
        """Emit every still-buffered frame (depth-general drain)."""
        depth = int(self.options.reservoir_depth)
        cap = 8192 * depth
        out = np.empty(cap, dtype=np.uint8)
        sizes = np.zeros(depth, dtype=np.int32)
        n_emitted = np.zeros(1, dtype=np.int32)
        n = self._lib.mp3_flush_buffered(self._h, out, cap, sizes, n_emitted)
        if n < 0:
            raise RuntimeError("native flush buffer overflow")
        self.frame_sizes.extend(int(x) for x in sizes[: int(n_emitted[0])])
        return out[:n].tobytes()

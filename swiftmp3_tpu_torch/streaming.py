"""L6 async streaming & file APIs (MP3Encoder.swift:151-230 equivalents).

- `encode_stream(encoder, input)` — async generator yielding MP3 frame bytes
  for an async iterable of PCM chunks (no Xing header), mirroring
  `MP3Encoder.encode(_:) -> AsyncThrowingStream`.
- `encode_to_file(encoder, input, path)` — incremental file writer that
  reserves a Xing placeholder, streams frames to disk, then seeks back to
  write the real Xing header after the ID3 tag, mirroring
  `MP3Encoder.encode(_:to:)`.

Cancellation semantics: asyncio task cancellation propagates out of the
iteration points, matching Task.checkCancellation in the reference.
Synchronous iterables are also accepted for convenience.
"""

from __future__ import annotations

import os
from typing import AsyncIterable, AsyncIterator, Iterable, Union

import numpy as np

from .options import MP3EncoderOptions
from .tables import bitrate_index, bitrate_value, bitrate_value_lsf

PCMInput = Union[AsyncIterable, Iterable]


async def _aiter(input: PCMInput):
    if hasattr(input, "__aiter__"):
        async for chunk in input:
            yield chunk
    else:
        for chunk in input:
            yield chunk


async def encode_stream(encoder, input: PCMInput) -> AsyncIterator[bytes]:
    """Yield encoded MP3 data chunks for a stream of interleaved PCM buffers.

    No Xing header is included (streaming mode, MP3Encoder.swift:147).
    """
    session = encoder.new_session()
    async for samples in _aiter(input):
        data = session.encode(np.asarray(samples, dtype=np.float32))
        if data:
            yield data
    final = session.flush()
    if final:
        yield final


def xing_placeholder_size(options: MP3EncoderOptions) -> int:
    if options.free_format:
        bv = options.bitrate_kbps  # exact off-table rate (CBR-only)
    else:
        br_idx = bitrate_index(options.bitrate_kbps, options.sample_rate)
        bv = bitrate_value_lsf(br_idx) if options.lsf else bitrate_value(br_idx)
    return ((72 if options.lsf else 144) * bv * 1000) // options.sample_rate


async def encode_to_file(encoder, input: PCMInput, path: Union[str, os.PathLike]) -> None:
    """Incrementally encode to an MP3 file with ID3 tag and Xing header.

    Layout: [ID3 tag][Xing placeholder][frames...]; after flushing, seeks
    back to overwrite the placeholder with the real Xing/Info frame
    (MP3Encoder.swift:189-230).
    """
    session = encoder.new_session()
    id3 = session.generate_id3_tag()
    placeholder = xing_placeholder_size(encoder.options)

    with open(path, "wb") as fh:
        fh.write(id3)
        fh.write(bytes(placeholder))
        async for samples in _aiter(input):
            data = session.encode(np.asarray(samples, dtype=np.float32))
            if data:
                fh.write(data)
        final = session.flush()
        if final:
            fh.write(final)
        fh.seek(len(id3))
        fh.write(session.generate_xing_header())


def encode_file_sync(encoder, pcm, path: Union[str, os.PathLike]) -> None:
    """Synchronous one-shot file encode (convenience; same layout as
    encode_to_file)."""
    session = encoder.new_session()
    id3 = session.generate_id3_tag()
    placeholder = xing_placeholder_size(encoder.options)
    with open(path, "wb") as fh:
        fh.write(id3)
        fh.write(bytes(placeholder))
        data = session.encode(np.asarray(pcm, dtype=np.float32))
        if data:
            fh.write(data)
        final = session.flush()
        if final:
            fh.write(final)
        fh.seek(len(id3))
        fh.write(session.generate_xing_header())

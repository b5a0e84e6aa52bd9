"""Session entry point of the port: an `EncoderSession` whose backend is the
PyTorch chunk program on a given device.

The session itself (PCM buffering, flush, the host frame assembler,
checkpoints, ID3/Xing) is the reference package's `EncoderSession`; only its
backend is swapped, so the byte-level behaviour around the device program is
shared, not copied.
"""

from __future__ import annotations

from swiftmp3_tpu.encoder import EncoderSession
from swiftmp3_tpu.options import MP3EncoderOptions

from .models.pipeline import TorchBackend, carry_from_jax, carry_to_jax

__all__ = ["new_session", "TorchBackend", "carry_from_jax", "carry_to_jax"]


def new_session(options: MP3EncoderOptions, device) -> EncoderSession:
    """A fresh encoder session running the port on `device` (e.g. "cuda" or
    "cpu"). Raises NotImplementedError for options outside this slice."""
    backend = TorchBackend(options, device)
    session = EncoderSession(options, backend="numpy")
    session.backend = backend
    return session

"""swiftmp3_tpu_torch — the PyTorch/CUDA port of the swiftmp3_tpu encoder.

A second package beside `swiftmp3_tpu` (the JAX reference, which it is held
against). It imports `torch` and never `jax`, and nothing of `swiftmp3_tpu`:
it keeps its own copies of the reference's host modules (`options`,
`tables`, `io`, `native`, `streaming`, the session and the golden backend
in `encoder`, the golden DSP `ops.reference`, the `decoder`, and
`utils.quality` and `utils.external`), laid out under the same names, so a
reader finds each counterpart by path.

It covers the compat, spec_strict and hq chunk programs (the hq flags
included: the static and adaptive lowpass, demand VBR, reservoir depth 1-8,
distortion control and intensity stereo) at MPEG-1 rates, at the LSF rates
of MPEG-2 and 2.5 (8-24 kHz, one granule a frame) and in free format, on
one device or over a data mesh of devices and processes, through every
entry point of the reference:

    swiftmp3_tpu_torch.MP3Encoder(options).new_session()         # one stream
    swiftmp3_tpu_torch.parallel.BatchEncoder(options, B, T)      # B streams
    swiftmp3_tpu_torch.parallel.encode_batch / encode_corpus     # files
    swiftmp3_tpu_torch.parallel.StreamPool(options, lanes, T)    # serving
    swiftmp3_tpu_torch.parallel.make_mesh() / encode_batch_multihost
    python -m swiftmp3_tpu_torch in.wav out.mp3 [--device cpu]   # command line
    swiftmp3_tpu_torch.decoder.decode_mp3(data)                  # the oracle

Every entry point runs on the card ("cuda", or every card with
`mesh=make_mesh()`) unless the caller passes `device="cpu"` or a mesh of
CPU positions; nothing falls back to the CPU on its own. The golden
encoder (`MP3Encoder(options, backend="numpy")`, `--backend numpy`) runs
on the host when the caller names it. Every Pallas kernel of the reference
has a hand-written CUDA counterpart (`ops/csrc/`), launched for CUDA
tensors; CPU tensors take their plain PyTorch versions (`ops/kernels.py`).

Numerics: float32 matrix products are pinned to full fp32 at import (no
TF32) — the counterpart of the reference's `Precision.HIGHEST` dots; integer
outputs are the parity surface and TF32 would flip quantization decisions.
"""

import importlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

# The reference's public names, loaded lazily as the reference loads them.
_EXPORTS = {
    "ID3Tag": ".options",
    "MP3EncoderOptions": ".options",
    "Mode": ".options",
    "EncoderSession": ".encoder",
    "MP3Encoder": ".encoder",
}

__all__ = [*sorted(_EXPORTS), "__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

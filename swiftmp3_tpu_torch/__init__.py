"""swiftmp3_tpu_torch — the PyTorch/CUDA port of the swiftmp3_tpu encoder.

A second package beside `swiftmp3_tpu` (the JAX reference, which it is held
against). It imports `torch` and never `jax`; the jax-free host modules of
the reference package (`options`, `tables`, `io`, `native`, `encoder`,
`ops.reference`) are shared, not copied.

This slice covers the compat chunk program (the reference-parity preset:
table-15 coding, the compat or aligned depth-1 reservoir, CBR or the
reference's energy VBR) on one device:

    swiftmp3_tpu_torch.encoder.new_session(options, device)   # one stream
    swiftmp3_tpu_torch.parallel.batch.BatchEncoder(...)        # B streams

Every function takes an explicit `device`; nothing falls back to the CPU on
its own. The two Pallas kernels on this path are hand-written CUDA kernels
(`ops/csrc/`), launched for CUDA tensors; CPU tensors take their plain
PyTorch versions (`ops/kernels.py`).

Numerics: float32 matrix products are pinned to full fp32 at import (no
TF32) — the counterpart of the reference's `Precision.HIGHEST` dots; integer
outputs are the parity surface and TF32 would flip quantization decisions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

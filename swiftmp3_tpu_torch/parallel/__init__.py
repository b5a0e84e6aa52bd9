"""Batched and served multi-stream encoding, on one device or over a data
mesh (twin of `swiftmp3_tpu.parallel`): `BatchEncoder`, `encode_batch`,
`encode_corpus` and `encode_batch_multihost` (batch.py) for a fixed cohort
of streams, `StreamPool` (pool.py), continuous batching for serving, and
the mesh (mesh.py): one flat data axis over streams, no collective in the
numeric path, more processes for more batch spans.

The names load lazily, so a multi-process job can import
`initialize_multihost` from here before anything touches a device.
"""

import importlib

_EXPORTS = {
    "batch_sharding": ".mesh",
    "carry_sharding": ".mesh",
    "initialize_multihost": ".mesh",
    "make_mesh": ".mesh",
    "process_batch_bounds": ".mesh",
    "put_global": ".mesh",
    "BatchEncoder": ".batch",
    "encode_batch": ".batch",
    "encode_batch_multihost": ".batch",
    "encode_corpus": ".batch",
    "StreamPool": ".pool",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))

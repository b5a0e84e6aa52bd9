"""Batched and served multi-stream encoding on one device (twin of
`swiftmp3_tpu.parallel`, without the mesh): `BatchEncoder`, `encode_batch`
and `encode_corpus` (batch.py) for a fixed cohort of streams, and
`StreamPool` (pool.py), continuous batching for serving."""

from .batch import BatchEncoder, encode_batch, encode_corpus
from .pool import StreamPool

__all__ = ["BatchEncoder", "StreamPool", "encode_batch", "encode_corpus"]

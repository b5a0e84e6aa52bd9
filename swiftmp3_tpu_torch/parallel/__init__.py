"""Batched multi-stream encoding on one device: `batch.BatchEncoder` and
`batch.encode_batch`."""

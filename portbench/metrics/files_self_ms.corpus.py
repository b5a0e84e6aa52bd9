"""Files layer (`parallel.batch.encode_corpus`): the job spans minus their
prepare, step and drain spans, a step (chunk building, encoder set-up,
ID3/Xing)."""

from portbench.readers import files_self_ms as read  # noqa: F401

"""Entry layer (`parallel.batch.BatchEncoder`): host milliseconds inside
`step()` a step, the enqueue of the chunk program."""

from portbench.readers import per_step_ms


def read(rec):
    return per_step_ms(rec, "step")

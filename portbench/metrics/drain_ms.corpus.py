"""Host render (`native`, through `BatchEncoder.drain`): host milliseconds in
`drain()` a step, its wait on the copy's event included."""

from portbench.readers import per_step_ms


def read(rec):
    return per_step_ms(rec, "drain")

"""Set-up seconds: from the run's start to the window's (importing torch
and the port, the card's context, loading or building the kernels and the
renderer, the audio made from the seed, the warm job or pool steps)."""

from portbench.readers import Record


def read(rec: Record) -> float:
    return rec.setup_s

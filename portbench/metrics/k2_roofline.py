"""Kernels (`ops.kernels.pack`, `ops/csrc/pack.cu`): K2's least time on the
stretch's launches (`bounds.pack_bound`, live slots only) over its time in
the profiler's trace, in percent."""

from portbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "pack")

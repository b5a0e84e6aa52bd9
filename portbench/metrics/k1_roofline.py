"""Kernels (`ops.kernels.rate_sweep`, `ops/csrc/rate_sweep.cu`): K1's least
time on the stretch's launches (`bounds.sweep_bound`) over its time in the
profiler's trace, in percent."""

from portbench.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "rate_sweep")

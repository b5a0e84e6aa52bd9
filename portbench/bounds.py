"""The card's published peaks and the least time each hand-written kernel's
work needs on it: the yardstick of the `*_roofline` metrics.

Frozen copies of `chip_smoke.py`'s `_bound`, `_sweep_bound` and
`_pack_bound` (held against them by a test). A bound counts the work the
launch's inputs need, whatever kernel does it, so a later kernel that does
the same work is read against the same bound.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet, 700 W)
LANE_OPS_PER_S = 67e12 / 2  # fp32 outside the tensor cores, FMA = 1 lane op
N_GAIN_CANDIDATES = 20  # the rate sweep's gains a granule


def bound(nbytes: float, lane_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the memory and operation times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lane_ops / LANE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bound(n: int) -> tuple[float, str]:
    """K1's (the rate sweep's) bound over n granules: read mag and gstart,
    write bits and bv; per granule and gain 576 x (multiply, add, floor,
    min, convert) + 288 x (index, lookup, add, max)."""
    g = N_GAIN_CANDIDATES
    return bound(4 * (576 * n + n + 2 * g * n), n * g * (576 * 5 + 288 * 4))


def pack_bound(F: int, P: int, live: int, cap: int) -> tuple[float, str, float]:
    """K2's (the main_data pack's) bound on F frames of P slots into cap
    bytes, `live` of the slots carrying bits: read nbits and the live slots'
    chunks (a dead slot's chunk is not needed), write the images and totals;
    per slot: scan add, offset, shift, up to three ORs. Also the time to move
    every input byte: (bound_ms, bound_by, all_inputs_ms)."""
    bound_ms, bound_by = bound(4 * F * P + 4 * live + F * cap + 4 * F, 6 * F * P)
    return bound_ms, bound_by, bound(4 * 2 * F * P + F * cap + 4 * F, 6 * F * P)[0]

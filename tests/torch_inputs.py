"""Inputs shared by the port's kernel tests (numpy only, made from seeds)."""

from __future__ import annotations

import numpy as np


def sweep_input(n: int = 37, seed: int = 7):
    """The tests/test_pallas.py rate-sweep input: granule levels over 5.5
    decades, one silent granule. Returns (mag [n, 576] f32, gstart [n] i32)."""
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((n, 576)) * 10 ** rng.uniform(-5, 0.5, (n, 1))).astype(
        np.float32
    )
    spec[3] = 0.0
    mag = (np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32)
    return mag, rng.integers(0, 256, n).astype(np.int32)


def pack_input(F: int, P: int, cap: int, seed: int = 7, overflow: bool = False):
    """The tests/test_pallas.py pack input: (chunks, nbits) [F, P] int32 with
    every frame under the cap, or (overflow=True) every frame past it."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(5 if overflow else 0, 16, size=(F, P)).astype(np.int32)
    scale = (cap * 8 - 64) / max(nb.sum(axis=1).max(), 1)
    if scale < 1 and not overflow:
        nb = np.where(rng.random((F, P)) < scale, nb, 0)
    ch = (rng.integers(0, 1 << 15, size=(F, P)) & ((1 << nb) - 1)).astype(np.int32)
    return ch, nb


def fma_knife_edges(inv_table: np.ndarray) -> dict[int, np.ndarray]:
    """Per gain g, the float32 magnitudes m whose quantization
    floor(m*inv + 0.5) differs between separate rounding (round the
    product, then the sum — the reference's order) and one fused
    multiply-add. Searched 40 ulps either side of each .5 boundary."""
    inv = inv_table.astype(np.float32)[:, None, None]  # [256, 1, 1]
    q = np.arange(1, 17, dtype=np.float64)[None, :, None]
    x0 = ((q - 0.5) / inv.astype(np.float64)).astype(np.float32)  # [256, 16, 1]
    steps = [x0]
    lo = hi = x0
    for _ in range(40):
        lo = np.nextafter(lo, np.float32(0))
        hi = np.nextafter(hi, np.float32(np.inf))
        steps += [lo, hi]
    m = np.concatenate(steps, axis=-1)  # [256, 16, 81]
    sep = np.floor((m * inv).astype(np.float32) + np.float32(0.5))
    fused = np.floor((m.astype(np.float64) * inv.astype(np.float64) + 0.5).astype(np.float32))
    out = {}
    for g in range(256):
        vals = np.unique(m[g][sep[g] != fused[g]])
        if vals.size:
            out[g] = vals
    return out


def knife_edge_sweep_input(inv_table: np.ndarray, seed: int = 3):
    """Rate-sweep granules whose candidate gains meet FMA knife edges: each
    granule holds, for several of its 20 gains, magnitudes that quantize
    differently under a fused multiply-add. Returns (mag [n, 576], gstart)."""
    edges = fma_knife_edges(inv_table)
    rng = np.random.default_rng(seed)
    starts = [g for g in range(120, 256, 3)]
    mag = np.full((len(starts), 576), np.float32(1e-10) ** np.float32(0.75), np.float32)
    for i, g0 in enumerate(starts):
        vals = []
        for k in range(20):
            g = min(g0 + 4 * k, 255)
            if g in edges:
                vals.extend(rng.choice(edges[g], size=min(4, edges[g].size), replace=False))
        pos = rng.choice(576, size=min(len(vals), 576), replace=False)
        mag[i, pos] = np.asarray(vals[: len(pos)], dtype=np.float32)
    return mag, np.asarray(starts, dtype=np.int32)

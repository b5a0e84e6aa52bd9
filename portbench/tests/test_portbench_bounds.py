"""The frozen bounds against chip_smoke.py's, on the same inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import bounds


@pytest.mark.parametrize("n", [1, 8192, 32768, 131072])
def test_sweep_bound_is_chip_smokes(n):
    assert bounds.sweep_bound(n) == chip_smoke._sweep_bound(n)


@pytest.mark.parametrize("F,P,cap", [(2048, 1152, 894), (64, 4176, 894), (100, 576, 444)])
def test_pack_bound_is_chip_smokes(F, P, cap):
    rng = np.random.default_rng(F + P)
    nbits = torch.from_numpy(np.where(rng.random((F, P)) < 0.7, rng.integers(1, 16, (F, P)), 0).astype(np.int32))
    live = int((nbits > 0).sum())
    assert bounds.pack_bound(F, P, live, cap) == chip_smoke._pack_bound(nbits, cap)


def test_peaks_are_chip_smokes():
    assert bounds.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert bounds.LANE_OPS_PER_S == chip_smoke.LANE_OPS_PER_S

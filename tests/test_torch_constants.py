"""The port's constants equal the JAX module's, bit for bit.

swiftmp3_tpu_torch.ops.dsp rebuilds every table of the compat path from
swiftmp3_tpu.tables in numpy float64, as swiftmp3_tpu.ops.dsp builds its jnp
constants; the GPU forms (256-entry tables indexed directly) must hold the
same values as the JAX forms (where-tree lookups, exact ldexp steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu.tables import band_table
from swiftmp3_tpu_torch.ops import dsp as tdsp

torch.set_num_threads(1)

_G = np.arange(256, dtype=np.int32)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("d", range(5))
def test_polyphase_fold(d):
    assert _bits_equal(tdsp.POLY_FOLD[d], jdsp._POLY_FOLD[d])


@pytest.mark.parametrize("law", ["p", "c"])
def test_mdct_fold(law):
    port = {"p": tdsp.MDCT_FOLD_P, "c": tdsp.MDCT_FOLD_C}[law]
    assert _bits_equal(port, jdsp._MDCT_FOLD[law])


def test_sign_flat():
    assert _bits_equal(tdsp.SIGN_FLAT, jdsp._SIGN_FLAT)


def test_inverse_step_tables():
    # the JAX module's tables and its gather-free lookups agree with the port
    assert _bits_equal(tdsp.INV_STEP, jdsp._INV_STEP_TABLE_NP)
    assert _bits_equal(tdsp.INV_STEP, jdsp.inv_step_lookup(jnp.asarray(_G)))
    assert _bits_equal(tdsp.INV_STEP34, jdsp._INV_STEP34_NP)
    assert _bits_equal(tdsp.INV_STEP34, jdsp.inv_step34_lookup(jnp.asarray(_G)))


def test_table15_lengths_and_codes():
    assert _bits_equal(tdsp.T15_LEN, jdsp.t15_length_lookup(jnp.asarray(_G)))
    assert _bits_equal(tdsp.T15_CODE, jdsp.t15_code_lookup(jnp.asarray(_G)))


def test_bitrate_tables():
    assert _bits_equal(tdsp.BITRATE_VALUES, jdsp._BITRATE_VALUES)
    assert _bits_equal(tdsp.BITRATE_VALUES_V2, jdsp._BITRATE_VALUES_V2)


@pytest.mark.parametrize("sr", [32000, 44100, 48000])
def test_region_bounds(sr):
    ref = np.cumsum(band_table(sr)).astype(np.int32)  # dsp.region_counts' bounds
    assert _bits_equal(tdsp.build_region_bounds(sr), ref)
    got = tdsp.region_bounds(sr, torch.device("cpu")).numpy()
    assert _bits_equal(got, ref)


@pytest.mark.parametrize(
    "name", ["poly_fold", "mdct_p", "mdct_c", "sign_flat", "inv_step", "t15_code"]
)
def test_device_constants_keep_their_bits(name):
    t = tdsp.constant(name, torch.device("cpu"))
    assert _bits_equal(t.numpy(), tdsp._CONSTANTS[name])

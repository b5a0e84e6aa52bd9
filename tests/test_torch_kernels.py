"""The port's kernels: plain versions against the Pallas kernels, dispatch.

On the CPU the plain PyTorch versions of K1 (rate sweep) and K2 (pack) are
held bit-exact against the JAX package's Pallas kernels run in interpret
mode, as the JAX package's own tests run them. The CUDA kernels themselves
run only on a card (tests/test_torch_cuda.py). A mocked launch shows that a
CUDA tensor never reaches a plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmp3_tpu.io.huffman_pack import pack_frame_main_data
from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu.ops import pallas_kernels as pk
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.ops import kernels

from .torch_inputs import knife_edge_sweep_input, pack_input, sweep_input

torch.set_num_threads(1)

PACK_SHAPES = [(16, 1152, 894), (5, 576, 894), (8, 1812, 1536), (3, 1152, 2160)]


# --- plain versions against the Pallas kernels (interpret mode) ---------------


@pytest.mark.parametrize("iso", [False, True])
def test_rate_sweep_plain_matches_pallas(iso):
    mag, g0 = sweep_input()
    bits_p, bv_p = pk.rate_sweep_pallas(
        jnp.asarray(mag), jnp.asarray(g0), iso=iso, interpret=True
    )
    bits, bv = kernels.rate_sweep(torch.from_numpy(mag), torch.from_numpy(g0), iso=iso)
    assert np.array_equal(bits.numpy(), np.asarray(bits_p))
    assert np.array_equal(bv.numpy(), np.asarray(bv_p))


@pytest.mark.parametrize("iso", [False, True])
def test_rate_sweep_plain_matches_the_xla_sweep_on_fma_knife_edges(iso):
    """Granules whose quantization differs between rounding the product
    then the sum (the golden numpy law, dsp.quantize_at_gains) and one fused
    multiply-add: the plain sweep follows the golden law and equals the JAX
    package's XLA sweep. (The Pallas kernel in interpret mode fuses on these
    inputs: ROADMAP Queue 3.)"""
    table = tdsp.INV_STEP34 if iso else tdsp.INV_STEP
    mag, g0 = knife_edge_sweep_input(table)
    gains = np.minimum(g0[:, None] + 4 * np.arange(20), 255)
    inv = table[gains][..., None]
    separate = np.floor((mag[:, None, :] * inv).astype(np.float32) + np.float32(0.5))
    fused = np.floor((mag[:, None, :].astype(np.float64) * inv + 0.5).astype(np.float32))
    assert (separate != fused).sum() > 100  # the input does separate the two laws
    bits_x, bv_x = jdsp._t15_sweep(
        jnp.asarray(mag), jnp.asarray(np.zeros(mag.shape, bool)), jnp.asarray(g0),
        iso, use_pallas=False,
    )
    bits, bv = kernels.rate_sweep(torch.from_numpy(mag), torch.from_numpy(g0), iso=iso)
    assert np.array_equal(bits.numpy(), np.asarray(bits_x))
    assert np.array_equal(bv.numpy(), np.asarray(bv_x))
    q = tdsp.quantize_at_gains(
        torch.from_numpy(mag), torch.zeros(mag.shape, dtype=torch.bool),
        torch.from_numpy(gains.astype(np.int32)), iso=iso,
    )
    assert np.array_equal(q.numpy(), np.minimum(separate, 15).astype(np.int32))


@pytest.mark.parametrize("F,P,cap", PACK_SHAPES)
def test_pack_plain_matches_pallas(F, P, cap):
    ch, nb = pack_input(F, P, cap)
    b_pl, t_pl = jax.jit(lambda c, n: pk.pack_pallas(c, n, cap, interpret=True))(
        jnp.asarray(ch), jnp.asarray(nb)
    )
    by, tot = kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), cap)
    assert by.dtype == torch.uint8 and by.shape == (F, cap)
    assert np.array_equal(by.numpy(), np.asarray(b_pl))
    assert np.array_equal(tot.numpy(), np.asarray(t_pl))


def test_pack_plain_matches_host_packer():
    rng = np.random.default_rng(1)
    F, G = 5, 4
    q = rng.integers(-15, 16, size=(F, G, 576)).astype(np.int32)
    bv = rng.integers(0, 289, size=(F, G)).astype(np.int32)
    chunks, nbits = tdsp.pair_chunks_device(torch.from_numpy(q), torch.from_numpy(bv))
    by, total = kernels.pack(chunks.reshape(F, -1), nbits.reshape(F, -1), 2160)
    for f in range(F):
        host_bytes, part_bits = pack_frame_main_data(q[f], bv[f])
        assert int(total[f]) == part_bits.sum()
        assert by[f, : len(host_bytes)].numpy().tobytes() == host_bytes


def test_pack_plain_truncates_at_cap_like_xla():
    """Frames longer than the cap: bytes past it are dropped, total_bits is
    the full count (the host then rejects hb > cap)."""
    ch, nb = pack_input(4, 1152, 894, seed=2, overflow=True)
    b_x, t_x = jdsp.pack_main_data(jnp.asarray(ch), jnp.asarray(nb), 894)
    by, tot = kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), 894)
    assert np.array_equal(by.numpy(), np.asarray(b_x))
    assert np.array_equal(tot.numpy(), np.asarray(t_x))
    assert int(tot.min()) > 894 * 8


# --- dispatch: a CUDA tensor never reaches a plain version ---------------------


def test_cuda_tensors_launch_the_kernel_never_the_plain_version(monkeypatch):
    launched = []

    def fake_launch(name, device, *args):
        launched.append(name)

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA call reached the plain version")

    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(kernels, "_launch", fake_launch)
    monkeypatch.setattr(kernels, "rate_sweep_plain", no_plain)
    monkeypatch.setattr(kernels, "pack_plain", no_plain)
    monkeypatch.setattr(kernels, "LAUNCHES", {"rate_sweep": 0, "pack": 0})

    mag, g0 = sweep_input(9)
    bits, bv = kernels.rate_sweep(torch.from_numpy(mag), torch.from_numpy(g0))
    assert bits.shape == (9, 20) and bv.shape == (9, 20)
    ch, nb = pack_input(3, 576, 894)
    by, tot = kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), 894)
    assert by.shape == (3, 894) and tot.shape == (3,)
    assert launched == ["rate_sweep", "pack"]
    assert kernels.LAUNCHES == {"rate_sweep": 1, "pack": 1}


def test_cpu_tensors_take_the_plain_version_and_count_nothing(monkeypatch):
    monkeypatch.setattr(kernels, "LAUNCHES", {"rate_sweep": 0, "pack": 0})
    mag, g0 = sweep_input(5)
    kernels.rate_sweep(torch.from_numpy(mag), torch.from_numpy(g0))
    ch, nb = pack_input(2, 576, 894)
    kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), 894)
    assert kernels.LAUNCHES == {"rate_sweep": 0, "pack": 0}


@pytest.mark.parametrize(
    "kind", ["dtype", "shape", "contiguity"]
)
def test_cuda_wrapper_rejects_bad_inputs(monkeypatch, kind):
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(kernels, "_launch", lambda *a: pytest.fail("launched"))
    mag, g0 = sweep_input(6)
    mag_t, g_t = torch.from_numpy(mag), torch.from_numpy(g0)
    if kind == "dtype":
        mag_t = mag_t.double()
    elif kind == "shape":
        g_t = g_t[:5]
    else:
        mag_t = torch.from_numpy(np.asfortranarray(mag))
    with pytest.raises((TypeError, ValueError)):
        kernels.rate_sweep(mag_t, g_t)


def test_cpu_and_cuda_inputs_do_not_mix():
    mag, g0 = sweep_input(4)
    with pytest.raises(ValueError):
        kernels._require_cuda(torch.from_numpy(mag), torch.from_numpy(g0))

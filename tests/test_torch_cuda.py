"""Card-only tests of the port: the hand-written CUDA kernels against their
plain PyTorch versions, and the port's entry points on a CUDA device against
the same entry points on the CPU.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports nothing of JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.ops import dsp, kernels
from swiftmp3_tpu_torch.parallel.batch import encode_batch

from .fixture_lib import FIXTURES, fixture_path, make_signal
from .torch_inputs import knife_edge_sweep_input, pack_input, sweep_input

pytestmark = pytest.mark.cuda

PACK_SHAPES = [(16, 1152, 894), (5, 576, 894), (8, 1812, 1536), (3, 1152, 2160), (2048, 1152, 894)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("iso", [False, True])
def test_rate_sweep_kernel_matches_plain(cuda_device, iso):
    mag, g0 = sweep_input(4099)
    m = torch.from_numpy(mag).to(cuda_device)
    g = torch.from_numpy(g0).to(cuda_device)
    before = kernels.LAUNCHES["rate_sweep"]
    bits, bv = kernels.rate_sweep(m, g, iso=iso)
    assert kernels.LAUNCHES["rate_sweep"] == before + 1
    pb, pv = kernels.rate_sweep_plain(m, g, iso)
    assert torch.equal(bits, pb) and torch.equal(bv, pv)


@pytest.mark.parametrize("iso", [False, True])
def test_rate_sweep_kernel_matches_plain_on_fma_knife_edges(cuda_device, iso):
    """An FMA in the kernel's quantizer would flip these granules' counts."""
    mag, g0 = knife_edge_sweep_input(dsp.INV_STEP34 if iso else dsp.INV_STEP)
    m = torch.from_numpy(mag).to(cuda_device)
    g = torch.from_numpy(g0).to(cuda_device)
    bits, bv = kernels.rate_sweep(m, g, iso=iso)
    pb, pv = kernels.rate_sweep_plain(m, g, iso)
    assert torch.equal(bits, pb) and torch.equal(bv, pv)


@pytest.mark.parametrize("F,P,cap", PACK_SHAPES)
def test_pack_kernel_matches_plain(cuda_device, F, P, cap):
    ch, nb = pack_input(F, P, cap)
    c = torch.from_numpy(ch).to(cuda_device)
    n = torch.from_numpy(nb).to(cuda_device)
    before = kernels.LAUNCHES["pack"]
    by, tot = kernels.pack(c, n, cap)
    assert kernels.LAUNCHES["pack"] == before + 1
    pby, ptot = kernels.pack_plain(c, n, cap)
    assert torch.equal(by, pby) and torch.equal(tot, ptot)


def test_pack_kernel_truncates_at_cap(cuda_device):
    ch, nb = pack_input(64, 1152, 894, overflow=True)
    c = torch.from_numpy(ch).to(cuda_device)
    n = torch.from_numpy(nb).to(cuda_device)
    by, tot = kernels.pack(c, n, 894)
    pby, ptot = kernels.pack_plain(c, n, 894)
    assert int(tot.min()) > 894 * 8
    assert torch.equal(by, pby) and torch.equal(tot, ptot)


def test_session_on_the_card_matches_the_fixture(cuda_device):
    name, kw, kind, seconds, seed = next(f for f in FIXTURES if f[0] == "joint_cbr192_48k_mix")
    o = MP3EncoderOptions(**kw)
    pcm = make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    s = new_session(o, cuda_device)
    with open(fixture_path(name, "tpu"), "rb") as fh:
        assert s.encode(pcm) + s.flush() == fh.read()


def test_batch_on_the_card_matches_cpu_sessions(cuda_device):
    o = MP3EncoderOptions(mode=Mode.STEREO, reservoir_mode="aligned")
    base = make_signal("mix", 0.5, 44100, 2, 31)
    streams = [base, base[: 2 * 1152 * 9 + 10], base[::-1].copy()]
    got = encode_batch(o, streams, cuda_device, frames_per_step=8)
    for pcm, data in zip(streams, got):
        s = new_session(o, "cpu")
        assert data == s.encode(pcm) + s.flush()

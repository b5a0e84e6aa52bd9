"""Each ported compat op against its JAX op on the same inputs (CPU).

Float stages use the JAX package's own tolerances (filterbank: atol 2e-4 and
rel 4e-6, tests/test_pallas.py; MDCT: rel 1e-5). Integer stages are fed the
JAX stage's float outputs and must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu_torch.ops import dsp as tdsp

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spectra(seed: int, shape=(2, 2, 3, 2)) -> np.ndarray:
    """Granule spectra over a wide level range, with one silent granule."""
    rng = np.random.default_rng(seed)
    scale = 10 ** rng.uniform(-5, 0.5, shape + (1,))
    spec = (rng.standard_normal(shape + (576,)) * scale).astype(np.float32)
    spec.reshape(-1, 576)[1] = 0.0
    return spec


def test_ingest_int16_and_nonfinite():
    rng = np.random.default_rng(0)
    i16 = rng.integers(-32768, 32768, (2, 3, 64)).astype(np.int16)
    want = np.asarray(jnp.asarray(i16).astype(jnp.float32) * jnp.float32(1.0 / 32768.0))
    assert np.array_equal(tdsp.ingest(_t(i16)).numpy(), want)
    f = rng.standard_normal((2, 3, 64)).astype(np.float32)
    f[0, 0, :3] = [np.nan, np.inf, -np.inf]
    want = np.asarray(jnp.nan_to_num(jnp.asarray(f), nan=0.0, posinf=0.0, neginf=0.0))
    assert np.array_equal(tdsp.ingest(_t(f)).numpy(), want)


def test_stereo_decide_compat_law():
    rng = np.random.default_rng(1)
    left = rng.standard_normal((3, 5, 1152)).astype(np.float32)
    right = left * rng.uniform(0.2, 1.0, (3, 5, 1)).astype(np.float32)
    right[:, ::2] = rng.standard_normal((3, 3, 1152))  # decorrelated frames
    use_j, c0_j, c1_j = jdsp.stereo_decide(jnp.asarray(left), jnp.asarray(right))
    use_t, c0_t, c1_t = tdsp.stereo_decide(_t(left), _t(right))
    assert np.array_equal(use_t.numpy(), np.asarray(use_j))
    assert use_t.any() and not use_t.all()
    assert np.array_equal(c0_t.numpy(), np.asarray(c0_j))
    assert np.array_equal(c1_t.numpy(), np.asarray(c1_j))


@pytest.mark.parametrize("T", [2, 4])
def test_polyphase_chunk_matmul(T):
    rng = np.random.default_rng(3)
    hist = rng.standard_normal((3, 2, 480)).astype(np.float32)
    pcm = rng.standard_normal((3, 2, T * 1152)).astype(np.float32)
    S_j, x_j = jdsp.polyphase_chunk_matmul(jnp.asarray(hist), jnp.asarray(pcm))
    S_t, x_t = tdsp.polyphase_chunk_matmul(_t(hist), _t(pcm))
    assert np.array_equal(x_t.numpy(), np.asarray(x_j))
    S_j = np.asarray(S_j)
    np.testing.assert_allclose(S_t.numpy(), S_j, rtol=0, atol=2e-4)
    scale = max(float(np.abs(S_j).max()), 1.0)
    assert float(np.abs(S_t.numpy() - S_j).max()) <= 4e-6 * scale


def test_transient_frame():
    rng = np.random.default_rng(4)
    g = (rng.standard_normal((4, 2, 3, 2, 576)) * 0.1).astype(np.float32)
    sub = g.reshape(4, 2, 3, 2, 3, 192)
    sub[0, :, :, :, 0] *= 30.0  # first sub-block loudest: MIXED
    sub[1, :, :, :, 2] *= 30.0  # last sub-block loudest: SHORT
    g[2, 0, 0, 0] = 0.0  # silent granule
    bj, gj = jdsp.transient_frame(jnp.asarray(g))
    bt, gt = tdsp.transient_frame(_t(g))
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    assert np.array_equal(gt.numpy(), np.asarray(gj))
    assert set(np.unique(bt.numpy())) == {0, 1, 2}


def test_mdct_chunk_compat():
    rng = np.random.default_rng(5)
    T = 3
    S = rng.standard_normal((2, 2, 36 * T, 32)).astype(np.float32)
    ov = rng.standard_normal((2, 2, 576)).astype(np.float32)
    bt = rng.choice([0, 1, 2], (2, 2, 2 * T)).astype(np.int32)
    out_j, cur_j = jdsp.mdct_chunk(jnp.asarray(S), jnp.asarray(ov), jnp.asarray(bt))
    out_t, cur_t = tdsp.mdct_chunk(_t(S), _t(ov), _t(bt))
    assert np.array_equal(cur_t.numpy(), np.asarray(cur_j))
    out_j = np.asarray(out_j)
    scale = max(float(np.abs(out_j).max()), 1.0)
    assert float(np.abs(out_t.numpy() - out_j).max()) <= 1e-5 * scale


@pytest.mark.parametrize("iso", [False, True])
def test_initial_gain(iso):
    spec = _spectra(6)
    got = tdsp.initial_gain(_t(spec), iso=iso).numpy()
    assert np.array_equal(got, np.asarray(jdsp.initial_gain(jnp.asarray(spec), iso=iso)))


def test_mean_square():
    x = np.random.default_rng(7).standard_normal((3, 4, 2304)).astype(np.float32)
    np.testing.assert_allclose(
        tdsp.mean_square(_t(x)).numpy(), np.asarray(jdsp.mean_square(jnp.asarray(x))),
        rtol=1e-6,
    )


@pytest.mark.parametrize("iso", [False, True])
def test_quantize_at_gains(iso):
    spec = _spectra(8)
    mag = (np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32)
    gains = np.random.default_rng(8).integers(0, 256, spec.shape[:-1] + (5,)).astype(np.int32)
    want = jdsp.quantize_at_gains(
        jnp.asarray(mag), jnp.asarray(spec < 0), jnp.asarray(gains), iso=iso
    )
    got = tdsp.quantize_at_gains(_t(mag), _t(spec < 0), _t(gains), iso=iso)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _pre_pair(iso: bool, seed: int = 9):
    spec = _spectra(seed)
    g0 = np.asarray(jdsp.initial_gain(jnp.asarray(spec), iso=iso))
    pre_j = jdsp.rate_loop_precompute(jnp.asarray(spec), jnp.asarray(g0), iso=iso)
    pre_t = tdsp.rate_loop_precompute(_t(spec), _t(g0), iso=iso)
    return pre_j, pre_t


@pytest.mark.parametrize("iso", [False, True])
def test_rate_loop_precompute(iso):
    pre_j, pre_t = _pre_pair(iso)
    for k in ("gstart", "k_budget", "bits", "bv", "evaluated", "sign_neg"):
        assert np.array_equal(pre_t[k].numpy(), np.asarray(pre_j[k])), k
    np.testing.assert_allclose(pre_t["mag"].numpy(), np.asarray(pre_j["mag"]), rtol=2e-7)


def test_rate_loop_select_and_finalize():
    pre_j, _ = _pre_pair(False, seed=10)
    rng = np.random.default_rng(10)
    max_bits = rng.integers(-20, 3000, np.asarray(pre_j["gstart"]).shape).astype(np.int32)
    max_bits.reshape(-1)[:4] = -1  # no candidate fits: the overflow quirk
    sel_j = jdsp.rate_loop_select(
        pre_j["bits"], pre_j["evaluated"], pre_j["k_budget"], jnp.asarray(max_bits)
    )
    sel_t = tdsp.rate_loop_select(
        _t(pre_j["bits"]), _t(pre_j["evaluated"]), _t(pre_j["k_budget"]), _t(max_bits)
    )
    for a, b in zip(sel_t, sel_j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    has_fit = np.asarray(sel_j[1])
    assert has_fit.any() and not has_fit.all()  # both walk outcomes exercised
    pre_t = {k: (v if k == "iso" else _t(v)) for k, v in pre_j.items()}
    fin_j = jdsp.rate_loop_finalize(pre_j, sel_j[0], sel_j[1])
    fin_t = tdsp.rate_loop_finalize(pre_t, _t(sel_j[0]), _t(sel_j[1]))
    for a, b in zip(fin_t, fin_j):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("base,quality", [(128, 5), (320, 9), (64, 0)])
def test_vbr_choose_bitrate(base, quality):
    rng = np.random.default_rng(11)
    energy = (10 ** rng.uniform(-6, 0, 64)).astype(np.float32)
    ehist = (10 ** rng.uniform(-6, 0, (64, 10))).astype(np.float32)
    count = rng.integers(0, 11, 64).astype(np.int32)
    ehist[np.arange(10)[None, :] >= count[:, None]] = 0.0
    want = jdsp.vbr_choose_bitrate(
        jnp.asarray(energy), jnp.asarray(ehist), jnp.asarray(count), base, quality
    )
    got = tdsp.vbr_choose_bitrate(_t(energy), _t(ehist), _t(count), base, quality)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sr", [32000, 44100, 48000])
def test_bitrate_index_and_value(sr):
    rates = np.arange(0, 400, dtype=np.int32)  # exact hits, ties, out of range
    idx_j = np.asarray(jdsp.bitrate_index_device(jnp.asarray(rates), sr))
    idx_t = tdsp.bitrate_index_device(_t(rates), sr)
    assert np.array_equal(idx_t.numpy(), idx_j)
    val_j = np.asarray(jdsp.bitrate_value_device(jnp.asarray(idx_j)))
    assert np.array_equal(tdsp.bitrate_value_device(idx_t).numpy(), val_j)


@pytest.mark.parametrize("sr", [32000, 44100, 48000])
def test_region_counts(sr):
    bv = np.arange(289, dtype=np.int32)
    r0_j, r1_j = jdsp.region_counts(jnp.asarray(bv), sr)
    r0_t, r1_t = tdsp.region_counts(_t(bv), sr)
    assert np.array_equal(r0_t.numpy(), np.asarray(r0_j))
    assert np.array_equal(r1_t.numpy(), np.asarray(r1_j))


def test_preflag():
    spec = _spectra(12)
    spec[0, 0, :, :, 432:] *= 50.0  # top-quarter heavy granules
    got = tdsp.preflag(_t(spec)).numpy()
    assert np.array_equal(got, np.asarray(jdsp.preflag(jnp.asarray(spec))))
    assert got.any() and not got.all()


def test_pair_chunks_device():
    rng = np.random.default_rng(13)
    q = rng.integers(-15, 16, size=(6, 576)).astype(np.int32)
    q[0] = 0
    bv = rng.integers(0, 289, size=6).astype(np.int32)
    c_j, n_j = jdsp.pair_chunks_device(jnp.asarray(q), jnp.asarray(bv))
    c_t, n_t = tdsp.pair_chunks_device(_t(q), _t(bv))
    assert np.array_equal(c_t.numpy(), np.asarray(c_j))
    assert np.array_equal(n_t.numpy(), np.asarray(n_j))

"""The port's hq slice against the JAX package (CPU).

- the linbits tables (table ids 24-31, their widths, codes, lengths and pair
  costs), indexed directly in the port, equal the JAX lookups over their
  whole index range;
- each hq op matches its JAX twin on the same inputs: the linbits entropy
  layout, sweep, finalize and chunks exactly; the onset/drop wants across a
  chunk boundary and the sequencing law with masked tails exactly; the
  window-sequencing MDCT within the JAX MDCT tests' tolerance; the
  demand-donation law against the golden encoder's;
- sessions on both hq configurations equal the JAX backend's bytes frozen
  under tests/fixtures/torch/ (made once by tests/torch_freeze_fixtures.py:
  the JAX hq chunk program is never compiled here), and so do five more
  strict configurations. Two rows sit on a float knife edge: there the port
  is held to the stream structure, and a test shows that the port with the
  JAX MDCT in place of its own reproduces the JAX bytes exactly;
- a session checkpoint crosses between the packages mid-stream;
- flags the reference never reads at a configuration encode as flag-off;
- the batch layer's lookahead and encoder delay equal sessions.

The JAX ops run under jax.jit, a few small compiles shared by the tests.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmp3_tpu.models import pipeline as jpipe
from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu.ops import reference as jref
from swiftmp3_tpu.options import MP3EncoderOptions as JaxOptions
from swiftmp3_tpu.options import Mode as JaxMode
from swiftmp3_tpu.tables import QCAP_LINBITS
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.options import MP3EncoderOptions
from swiftmp3_tpu_torch.parallel.batch import BatchEncoder, encode_batch

from . import torch_inputs as ti
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")
SR = 44100
# Frames of the telemetry corpus (78) whose bytes may differ from the golden
# encoder's: the JAX backend's hq ceiling (tests/test_ulp_telemetry.py; it
# measured 16/78), and for stereo, which the telemetry suite does not pin,
# the JAX backend's own rate on the frozen files (25/78) under that suite's
# rule, max(2x, +2).
HQ_TELEMETRY_FLIP_CEILING = {"hq_joint": 24, "hq_stereo": 50}
# Frozen JAX rows the port's CPU session does not reproduce byte for byte (6
# of 13 and 1 of 13 frames): the two MDCTs sum in another order, and a few
# ULPs of spectrum move a quantization knife edge of the linbits law
# (test_knife_edge_rows_match_with_the_jax_mdct). ROADMAP Queue 3 logs them.
KNIFE_EDGE_ROWS = ("hq_joint_corpus_burst", "hq_joint_corpus_panned")
HQ_ROWS = [f"{p}_{stem}" for p in ti.HQ_OPTIONS for stem in ti.hq_streams()]


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.array_equal(got, np.asarray(want))


def _hq_options(preset: str, **extra):
    kw = dict(ti.HQ_OPTIONS[preset], **extra)
    return MP3EncoderOptions.hq(**kw), JaxOptions.hq(**dict(kw, mode=JaxMode(kw["mode"])))


def _encode(o, pcm) -> bytes:
    s = new_session(o, CPU)
    return s.encode(pcm) + s.flush()


def _flips(got: bytes, ref: bytes) -> int:
    """Frames whose bytes differ; the structure (every frame's size and
    header) must be equal."""
    fg, fr = parse_frames(got), parse_frames(ref)
    assert [(f.size, got[f.offset : f.offset + 4]) for f in fg] == [
        (f.size, ref[f.offset : f.offset + 4]) for f in fr
    ]
    return sum(
        got[a.offset : a.offset + a.size] != ref[b.offset : b.offset + b.size]
        for a, b in zip(fg, fr)
    )


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


# --- linbits tables -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_linbits_tables():
    """The JAX linbits lookups over their whole range, one compile: the table
    id of every region maximum 0..QCAP_LINBITS, the width of every id, and
    the code and length of every pair index under ids 24-31."""
    m = np.arange(QCAP_LINBITS + 1, dtype=np.int32)
    tids = np.repeat(np.arange(24, 32, dtype=np.int32), 256)
    idx = np.tile(np.arange(256, dtype=np.int32), 8)

    def run(m, tids, idx):
        return (
            jdsp._table_for_max_device(m, linbits=True),
            jdsp._linbits_of_tid(jnp.arange(32, dtype=jnp.int32)),
            jdsp._pair_len_by_tid(tids, idx, linbits=True),
            jdsp._pair_code_by_tid(tids, idx, linbits=True),
        )

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(m, tids, idx))


def test_linbits_tables_equal_the_jax_lookups():
    tfm, widths, lens, codes = _jax_linbits_tables()
    m = torch.arange(QCAP_LINBITS + 1, dtype=torch.int32)
    got = tdsp.table_for_max_device(m, linbits=True)
    assert got.dtype == torch.int32 and _eq(got, tfm)
    assert set(tfm.tolist()) == {0, 1, 2, 5, 7, 15, *range(24, 32)}
    # without linbits the classic ids up to 15 are unchanged
    assert _eq(tdsp.table_for_max_device(m[:16]), tfm[:16])
    assert _eq(tdsp.linbits_of_tid(torch.arange(32)), widths) and _eq(tdsp.LINBITS_OF_TID, widths)
    assert _eq(tdsp.PAIR_LEN[24:].reshape(-1), lens) and _eq(tdsp.PAIR_CODE[24:].reshape(-1), codes)
    x, y = np.arange(256) >> 4, np.arange(256) & 15
    signs = (x != 0).astype(np.int32) + (y != 0)
    esc = (x == 15).astype(np.int32) + (y == 15)
    for tid in range(24, 32):
        want = tdsp.PAIR_LEN[tid] + signs + widths[tid] * esc
        assert _eq(tdsp.PAIR_COST[tid], want), tid


# --- linbits layout, sweep, finalize, chunks ----------------------------------------


def _quantized_linbits(seed: int, n: int = 24) -> np.ndarray:
    """Quantized granules with escapes of every 24-family width (magnitudes
    up to QCAP_LINBITS), exact 15s, zero tails and count1 regions."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-15, 16, (n, 576)).astype(np.int32)
    q = (q * (rng.random((n, 576)) < rng.uniform(0.05, 1.0, (n, 1)))).astype(np.int32)
    for i in range(n):
        top = 15 + (1 << int(rng.integers(0, 14))) - 1
        k = int(rng.integers(1, 40))
        pos = rng.integers(0, 576, k)
        q[i, pos] = rng.integers(15, top + 1, k) * rng.choice([-1, 1], k)
        tail = int(rng.integers(0, 577))
        q[i, tail:] = 0
        ones = int(rng.integers(0, 120))
        q[i, max(tail - ones, 0) : tail] = np.sign(q[i, max(tail - ones, 0) : tail])
    q[0] = 0
    q[1, 10] = QCAP_LINBITS
    q[2, 3] = -15
    return q


@functools.lru_cache(maxsize=None)
def _jax_linbits_layout():
    q = _quantized_linbits(2)
    is_long = np.random.default_rng(3).random(q.shape[0]) < 0.6

    def run(q, is_long):
        lay = jdsp.strict_layout_device(q, SR, is_long, True, True, linbits=True)
        return lay, jdsp.strict_chunks_device(q, lay, linbits=True)

    return q, is_long, *jax.tree_util.tree_map(np.asarray, jax.jit(run)(q, is_long))


def test_linbits_layout_and_chunks():
    q, is_long, lay_j, (c_j, n_j) = _jax_linbits_layout()
    lay_t = tdsp.strict_layout_device(_t(q), SR, _t(is_long), True, True, linbits=True)
    assert sorted(lay_t) == sorted(lay_j)
    for k in lay_j:
        assert lay_t[k].dtype == torch.int32 and _eq(lay_t[k], lay_j[k]), k
    assert (lay_j["tid0"] >= 24).any() and (lay_j["tid1"] >= 24).any()
    cap = np.minimum(np.abs(q), QCAP_LINBITS)
    got_abs = tdsp.strict_layout_device(_t(cap), SR, _t(is_long), True, True, True, linbits=True)
    for k in lay_j:
        assert _eq(got_abs[k], lay_j[k]), k
    c_t, n_t = tdsp.strict_chunks_device(_t(q), lay_t, linbits=True)
    assert c_t.shape == (q.shape[0], 864 + 144)
    assert _eq(c_t, c_j) and _eq(n_t, n_j)
    # every slot fits the pack kernel (at most 15 bits), and the slots carry
    # exactly the priced bits
    assert int(n_t.max()) <= 14 and int(n_t.max()) >= 13
    assert _eq(n_t.sum(-1, dtype=torch.int32), lay_j["bits"])
    assert ((c_t >> n_t) == 0).all()


def _hq_spectra(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """[1, 2, 4, 2, 576] spectra over a wide level range, a silent granule
    and bands of zeros, and an hq block sequence with every type (START and
    STOP included), shared by the two channels."""
    rng = np.random.default_rng(seed)
    shape = (1, 2, 4, 2)
    scale = 10 ** rng.uniform(-4, 1.0, shape + (1,))
    spec = (rng.standard_normal(shape + (576,)) * scale).astype(np.float32)
    spec.reshape(-1, 576)[1] = 0.0
    spec.reshape(-1, 576)[2, :40] *= 50.0
    spec.reshape(-1, 576)[3, 100:200] = 0.0
    blk = np.array([[0, 3], [2, 2], [4, 0], [1, 0]], np.int32)
    return spec, np.broadcast_to(blk, shape).copy()


@functools.lru_cache(maxsize=None)
def _jax_linbits_sweep():
    """One compile of the JAX linbits strict ops over _hq_spectra: the
    scalefactors on the long scalefactor layout (START/STOP as LONG), the
    linbits initial gains, the sweep (iso_short, with START/STOP), a
    selection whose budgets include the 4095 clamp and no-fit granules,
    strict_finalize and the chunks."""
    spec, block = _hq_spectra(5)
    rng = np.random.default_rng(6)
    max_bits = rng.integers(-20, 4095, block.shape).astype(np.int32)
    max_bits.reshape(-1)[:2] = -1  # no candidate fits: the overflow quirk
    max_bits.reshape(-1)[2] = 4095

    def run(spec, block, max_bits):
        is_long = block == jdsp.BLOCK_LONG
        sf_block = jnp.where(block > jdsp.BLOCK_SHORT, jdsp.BLOCK_LONG, block)
        sfd = jdsp.granule_scalefactors_device(spec, SR, sf_block, iso_short=True)
        g0 = jdsp.initial_gain_scaled(spec, sfd["mag_scale"], target=jref.LINBITS_Q_TARGET)
        pre = jdsp.rate_loop_precompute_strict(
            spec, g0, SR, is_long, True, True, True, mag_scale=sfd["mag_scale"],
            part2=sfd["part2"], block=block, iso_short=True, linbits=True,
        )
        k_sel, has_fit, _ = jdsp.rate_loop_select(
            pre["bits"], pre["evaluated"], pre["k_budget"], max_bits
        )
        gain, q, lay = jdsp.strict_finalize(pre, k_sel, has_fit)
        return {
            "sfd": sfd,
            "g0": g0,
            "pre": {k: v for k, v in pre.items() if k not in ("iso", "strict", "linbits")},
            "k_sel": k_sel,
            "has_fit": has_fit,
            "final": (gain, q, lay),
            "chunks": jdsp.strict_chunks_device(q, lay, linbits=True),
        }

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(spec, block, max_bits))
    return (spec, block), out


def test_linbits_initial_gain_and_sweep():
    (spec, block), want = _jax_linbits_sweep()
    sf_block = np.where(block > 2, 0, block)
    sfd = tdsp.granule_scalefactors_device(_t(spec), SR, _t(sf_block), iso_short=True)
    for k in want["sfd"]:
        assert _eq(sfd[k], want["sfd"][k]), k
    g0 = tdsp.initial_gain_scaled(_t(spec), sfd["mag_scale"], target=tpipe.LINBITS_Q_TARGET)
    assert _eq(g0, want["g0"])
    pre = tdsp.rate_loop_precompute_strict(
        _t(spec), g0, SR, _t(block == 0), True, True, True, mag_scale=sfd["mag_scale"],
        part2=sfd["part2"], block=_t(block), iso_short=True, linbits=True,
    )
    pre_j = want["pre"]
    for k in ("gstart", "k_budget", "bits", "evaluated", "sign_neg"):
        assert _eq(pre[k], pre_j[k]), k
    np.testing.assert_allclose(pre["mag"].numpy(), pre_j["mag"], rtol=2e-7)
    assert pre["linbits"] and int(pre_j["bits"].max()) > 4095  # past the 12-bit field


def test_linbits_finalize_and_chunks():
    (_, block), want = _jax_linbits_sweep()
    pre = {k: _t(v) for k, v in want["pre"].items()}
    pre.update(iso=True, strict=(SR, True, True), linbits=True)
    assert not want["has_fit"].all() and want["has_fit"].any()
    g_t, q_t, lay_t = tdsp.strict_finalize(pre, _t(want["k_sel"]), _t(want["has_fit"]))
    g_j, q_j, lay_j = want["final"]
    assert _eq(g_t, g_j) and _eq(q_t, q_j)
    assert int(np.abs(q_j).max()) > 15  # escapes on the selected gains
    for k in lay_j:
        assert _eq(lay_t[k], lay_j[k]), k
    c_t, n_t = tdsp.strict_chunks_device(q_t, lay_t, linbits=True)
    assert _eq(c_t, want["chunks"][0]) and _eq(n_t, want["chunks"][1])


# --- window sequencing -------------------------------------------------------------


def _granule_pcm(seed: int, shape) -> np.ndarray:
    """Raw granules [..., G, 576]: a tone with loud attacks (onsets) and
    sudden silences (drops)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape + (576,)) * 0.05).astype(np.float32)
    flat = x.reshape(-1, 576)
    flat[1::5, 300:400] *= 40.0
    flat[2::7, 96:] *= 1e-3
    flat[3::6, :] = 0.0
    return x


@functools.lru_cache(maxsize=None)
def _jax_sequencing():
    """One compile: onset wants over a chain of 2 x 6 granules as one piece
    (unknown past) and as two chunks (the second's past the first's tails),
    and the sequencing law over random wants with masked tails."""
    g = _granule_pcm(7, (3, 2, 12))
    rng = np.random.default_rng(8)
    B, G = 64, 8
    want = rng.random((B, G)) < 0.3
    want_next = rng.random((B, G)) < 0.3
    n_valid = rng.integers(0, G + 1, B)
    n_valid[:2] = [0, G]
    valid = np.arange(G)[None, :] < n_valid[:, None]
    prev_short = rng.random(B) < 0.5
    prev_want = rng.random(B) < 0.5
    inf = np.full((3, 2, 2), np.inf, np.float32)

    def run(g, want, want_next, valid, prev_short, prev_want):
        whole = jdsp.onset_wants_chunk(g, inf)
        first = jdsp.onset_wants_chunk(g[..., :6, :], inf)
        second = jdsp.onset_wants_chunk(g[..., 6:, :], first[1][..., -1, :])
        seq = jdsp.sequence_blocks_chunk(want, want_next, valid, prev_short, prev_want)
        return whole, first, second, seq

    out = jax.jit(run)(g, want, want_next, valid, prev_short, prev_want)
    inputs = (g, want, want_next, valid, prev_short, prev_want)
    return inputs, jax.tree_util.tree_map(np.asarray, out)


def test_onset_wants_across_a_chunk_boundary():
    (g, *_), (whole, first, second, _) = _jax_sequencing()
    inf = torch.full((3, 2, 2), float("inf"))
    w_t, tails_t = tdsp.onset_wants_chunk(_t(g), inf)
    assert _eq(w_t, whole[0]) and w_t.any() and not w_t.all()
    np.testing.assert_allclose(tails_t.numpy(), whole[1], rtol=1e-6)
    f_w, f_tails = tdsp.onset_wants_chunk(_t(g[..., :6, :]), inf)
    s_w, _ = tdsp.onset_wants_chunk(_t(g[..., 6:, :]), f_tails[..., -1, :])
    assert _eq(f_w, first[0]) and _eq(s_w, second[0])
    # the carried tails make two chunks one chain; the unknown past fires nothing
    assert _eq(torch.cat([f_w, s_w], -1), w_t)
    assert not tdsp.onset_wants_chunk(torch.zeros(1, 1, 576), torch.full((1, 2), float("inf")))[0].any()


def test_sequence_blocks_with_masked_tails():
    (_, want, want_next, valid, ps, pw), (*_, (bt_j, ps_j, pw_j)) = _jax_sequencing()
    bt_t, ps_t, pw_t = tdsp.sequence_blocks_chunk(_t(want), _t(want_next), _t(valid), _t(ps), _t(pw))
    assert bt_t.dtype == torch.int32 and _eq(bt_t, bt_j)
    assert _eq(ps_t, ps_j) and _eq(pw_t, pw_j)
    assert set(np.unique(bt_j).tolist()) == {0, 2, 3, 4}


@functools.lru_cache(maxsize=None)
def _jax_mdct(iso_mixed_alias: bool, window_seq: bool):
    return jax.jit(
        functools.partial(jdsp.mdct_chunk, iso_mixed_alias=iso_mixed_alias, window_seq=window_seq)
    )


def _assert_mdct_close(got: torch.Tensor, want) -> None:
    """The JAX MDCT tests' tolerance (tests/test_pallas.py): 1e-5 x the
    largest magnitude, at least 1e-5."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


def test_mdct_chunk_window_sequencing():
    """START and STOP granules (and every other type) at the session's
    chunk shape, [1, 2, 36 x 8, 32]."""
    rng = np.random.default_rng(9)
    S = rng.standard_normal((1, 2, 36 * 8, 32)).astype(np.float32)
    ov = rng.standard_normal((1, 2, 576)).astype(np.float32)
    bt = np.tile(np.array([0, 3, 2, 2, 4, 0, 3, 4], np.int32), 2)[None, None].repeat(2, 1)
    out_j, cur_j = _jax_mdct(True, True)(S, ov, bt)
    out_t, cur_t = tdsp.mdct_chunk(_t(S), _t(ov), _t(bt), iso_mixed_alias=True, window_seq=True)
    assert _eq(cur_t, cur_j)
    _assert_mdct_close(out_t, out_j)
    long_t, _ = tdsp.mdct_chunk(_t(S), _t(ov), _t(np.zeros_like(bt)), iso_mixed_alias=True)
    for b in (3, 4):  # transitions differ from LONG on their scaled half only
        assert not torch.equal(out_t[bt == b], long_t[bt == b])
    assert torch.equal(out_t[bt == 0], long_t[bt == 0])


# --- the demand budget -----------------------------------------------------------


def _golden_donation(demands, total_bits, bits_per_granule):
    """The golden encoder's stage-2 budgets under demand_budget
    (swiftmp3_tpu/encoder.py:637-682), transcribed."""
    if sum(demands) <= 0:
        return [bits_per_granule] * len(demands)
    G = len(demands)
    share = total_bits // G
    sur = [max(share - d, 0) for d in demands]
    defi = [max(d - share, 0) for d in demands]
    pool, sdef = sum(sur), sum(defi)
    take = min(pool, sdef)
    return [
        min(share - (s * take) // max(pool, 1) + (take * dd) // max(sdef, 1), 4095)
        for s, dd in zip(sur, defi)
    ]


def test_demand_budget_donation():
    rng = np.random.default_rng(11)
    demand = rng.integers(0, 3500, (64, 4)).astype(np.int32)
    demand[0] = [100, 3000, 200, 2900]  # surplus and deficit: donation
    demand[1] = 0  # no demand: the equal split
    demand[2] = [900, 900, 900, 900]  # no deficit: an exact no-op
    demand[3] = [0, 9000, 0, 0]  # one hungry granule past the 12-bit field
    total = rng.integers(3000, 16000, 64).astype(np.int32)
    total[3] = 16000
    equal = np.minimum(total // 4, 4095).astype(np.int32)
    got = tdsp.demand_budget_bits(_t(demand), _t(total), _t(equal))
    assert got.dtype == torch.int32
    for b in range(64):
        want = _golden_donation(demand[b].tolist(), int(total[b]), int(equal[b]))
        assert got[b].tolist() == want, b
    assert got[0].tolist() != [int(total[0]) // 4] * 4 and got[3].tolist()[1] == 4095
    assert got[2].tolist() == [int(total[2]) // 4] * 4


# --- sessions against the frozen JAX streams -----------------------------------------


@functools.lru_cache(maxsize=None)
def _port_hq_stream(row: str) -> bytes:
    preset, stem = next((p, row[len(p) + 1 :]) for p in ti.HQ_OPTIONS if row.startswith(p + "_"))
    return _encode(_hq_options(preset)[0], ti.hq_streams()[stem])


@pytest.mark.parametrize("row", HQ_ROWS)
def test_hq_session_matches_the_jax_bytes(row):
    ref = _read(ti.jax_path(row))
    if row in KNIFE_EDGE_ROWS:
        # the structure exactly, the bytes within the corpus's flip budget
        # (test_hq_flip_rate_vs_golden_on_the_telemetry_corpus holds the rate)
        assert 0 < _flips(_port_hq_stream(row), ref) <= HQ_TELEMETRY_FLIP_CEILING["hq_joint"]
    else:
        assert _port_hq_stream(row) == ref


@pytest.mark.parametrize("row", KNIFE_EDGE_ROWS)
def test_knife_edge_rows_match_with_the_jax_mdct(row, monkeypatch):
    """The port's session with the JAX package's MDCT in place of its own
    (the same filterbank samples, overlap and block types in) reproduces
    the JAX bytes exactly, while every call's two MDCTs agree within the
    JAX MDCT tests' tolerance: the rows differ by a float knife edge, not a
    law."""
    port_mdct = tdsp.mdct_chunk

    def jax_mdct(S, overlap, block_type, iso_mixed_alias=False, window_seq=False):
        out, signed = _jax_mdct(iso_mixed_alias, window_seq)(
            S.numpy(), overlap.numpy(), block_type.numpy()
        )
        mine, _ = port_mdct(S, overlap, block_type, iso_mixed_alias, window_seq)
        _assert_mdct_close(mine, out)
        return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(signed))

    monkeypatch.setattr(tdsp, "mdct_chunk", jax_mdct)
    preset = next(p for p in ti.HQ_OPTIONS if row.startswith(p + "_"))
    got = _encode(_hq_options(preset)[0], ti.hq_streams()[row[len(preset) + 1 :]])
    assert got == _read(ti.jax_path(row))


@pytest.mark.parametrize("row", ti.STRICT_EXTRA_ROWS, ids=[r[0] for r in ti.STRICT_EXTRA_ROWS])
def test_strict_configuration_matches_the_jax_bytes(row):
    name, kw, preset, kind, seconds, seed = row
    o = MP3EncoderOptions.spec_strict(**kw) if preset == "spec_strict" else MP3EncoderOptions(**kw)
    pcm = ti.make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    assert _encode(o, pcm) == _read(ti.jax_path(name))


@pytest.mark.parametrize("preset", list(ti.HQ_OPTIONS))
def test_hq_flip_rate_vs_golden_on_the_telemetry_corpus(preset):
    bad = total = 0
    for stem in ti.corpus_stereo():
        ref = _read(ti.golden_path(f"corpus_{stem}", preset))
        bad += _flips(_port_hq_stream(f"{preset}_corpus_{stem}"), ref)
        total += len(parse_frames(ref))
    assert total == 78 and bad <= HQ_TELEMETRY_FLIP_CEILING[preset]


# --- checkpoints, the carry and the host contract ------------------------------------


def test_hq_checkpoint_jax_to_port_and_back():
    """A session checkpoint in the middle of an hq stream. The port resumes
    from the JAX backend's and gives the unbroken stream's bytes; the port's
    own checkpoint there is, bit for bit, the one the JAX backend resumed
    from to give the same bytes when tests/torch_freeze_fixtures.py froze
    it."""
    stem, preset, cut = ti.HQ_CHECKPOINT
    o, _ = _hq_options(preset)
    pcm = ti.hq_streams()[stem]
    whole = _read(ti.jax_path(f"{preset}_{stem}"))
    jax_state, extra = ti.load_session_state(ti.checkpoint_path("jax"))
    head = int(extra["head_len"])
    assert {"seq_prev_short", "seq_prev_want", "onset_prev2"} <= set(jax_state["backend"])
    s = new_session(o, CPU)
    s.load_state_dict(jax_state)
    assert whole[:head] + s.encode(pcm[cut:]) + s.flush() == whole
    s = new_session(o, CPU)
    assert s.encode(pcm[:cut]) == whole[:head]
    mine = s.state_dict()
    frozen, _ = ti.load_session_state(ti.checkpoint_path("port"))
    for k in ("fed", "fed_samples", "reservoir_avail", "buffered_slots", "frame_count",
              "total_bytes", "frame_sizes"):
        assert mine[k] == frozen[k], k
    assert bytes(mine["reservoir_stream"]) == frozen["reservoir_stream"]
    assert [bytes(h) for h in mine["buffered_heads"]] == frozen["buffered_heads"]
    assert mine["pcm"].tobytes() == frozen["pcm"].tobytes()
    assert sorted(mine["backend"]) == sorted(frozen["backend"])
    for k, v in mine["backend"].items():
        assert v.dtype == frozen["backend"][k].dtype and v.tobytes() == frozen["backend"][k].tobytes(), k


def test_hq_carry_matches_the_jax_layout():
    """init_carry's keys, shapes, dtypes and values under window_sequencing
    (+inf block energies) equal the JAX package's, and carry_to_jax /
    carry_from_jax round-trip them."""
    o, jo = _hq_options("hq_joint")
    want = {k: np.asarray(v) for k, v in jpipe.init_carry(3, jo).items()}
    got = tpipe.carry_to_jax(tpipe.init_carry(3, o, CPU))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    back = tpipe.carry_to_jax(tpipe.carry_from_jax(got, CPU, o))
    assert all(np.array_equal(back[k], got[k]) for k in got)
    with pytest.raises(ValueError, match="missing"):
        tpipe.carry_from_jax({k: v for k, v in got.items() if not k.startswith(("seq", "onset"))}, CPU, o)


def test_hq_host_contract_matches_jax():
    """frame_results_from_outputs maps START and STOP granules (ISO block
    types 1 and 3) and the rest of an hq frame as the JAX function does."""
    o, jo = _hq_options("hq_stereo")
    pcm = ti.hq_streams()["corpus_burst"].reshape(-1)
    B, T = 1, 8
    frames = pcm[: T * 2304].reshape(B, T, 2304)
    la = np.stack([pcm[(t + 1) * 2304 : (t + 1) * 2304 + 1152] for t in range(T)])[None]
    _, outs = tpipe.make_chunk_fn(o)(
        tpipe.init_carry(B, o, CPU), _t(frames), torch.zeros(B, T, dtype=torch.bool),
        torch.ones(B, T, dtype=torch.bool), _t(la),
    )
    got = tpipe.fetch_outputs(outs, o)
    want = jpipe.fetch_outputs({"packed": outs["packed"].numpy()}, jo)
    assert {2, 3, 4} <= set(np.unique(got["block_type"]).tolist())
    for t in range(T):
        fr_t = tpipe.frame_results_from_outputs(got, o, t, 0)
        fr_j = jpipe.frame_results_from_outputs(want, jo, t, 0)
        assert [[dataclasses.astuple(g) for g in gr] for gr in fr_t.granules] == [
            [dataclasses.astuple(g) for g in gr] for gr in fr_j.granules
        ]
        assert fr_t.main_data == fr_j.main_data and fr_t.scfsi == fr_j.scfsi


def test_window_sequencing_needs_the_lookahead():
    o, _ = _hq_options("hq_stereo")
    pcm = torch.zeros(1, 2, 2304)
    flags = torch.zeros(1, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="lookahead"):
        tpipe.make_chunk_fn(o)(tpipe.init_carry(1, o, CPU), pcm, flags, ~flags)
    with pytest.raises(ValueError, match="lookahead"):
        BatchEncoder(o, 1, 2, CPU).step(pcm.numpy(), flags.numpy(), (~flags).numpy())


def test_hq_batch_matches_sessions():
    """encode_batch under hq (the one-granule encoder delay, each frame's
    lookahead and the final-frame marks) equals one session per stream:
    streams of an exact frame multiple, a partial last frame, int16 and an
    empty one."""
    o, _ = _hq_options("hq_joint")
    base = ti.make_signal("burst", 0.4, SR, 2, 25)
    streams = [
        base,
        base[: 2 * 1152 * 5],
        base[::-1].copy()[: 2 * 4000 + 2],
        (ti.make_signal("mix", 0.2, SR, 2, 26) * 32767).astype(np.int16),
        np.zeros(0, np.float32),
    ]
    got = encode_batch(o, streams, CPU, frames_per_step=4)
    for pcm, data in zip(streams, got):
        assert data == _encode(o, pcm)
    assert got[-1] == b""


# --- flags the reference never reads at these configurations ----------------------


INACTIVE = {
    # intensity stereo above 24 kbps a channel
    "intensity_stereo_128k": (
        lambda: MP3EncoderOptions.spec_strict(mode="joint_stereo", intensity_stereo=True),
        dict(intensity_stereo=False),
    ),
    # distortion control below 112 kbps a channel (hq stereo 128 kbps)
    "distortion_control_64k_a_channel": (
        lambda: MP3EncoderOptions.hq(mode="stereo", distortion_control=True),
        dict(distortion_control=False),
    ),
    # a lowpass cut at Nyquist, and one above it with the adaptive gate
    "lowpass_at_nyquist": (
        lambda: MP3EncoderOptions.spec_strict(mode="joint_stereo", lowpass_hz=22050),
        dict(lowpass_hz=None),
    ),
    "adaptive_lowpass_above_nyquist": (
        lambda: MP3EncoderOptions.hq(mode="joint_stereo", lowpass_hz=24000, adaptive_lowpass=True),
        dict(lowpass_hz=None, adaptive_lowpass=False),
    ),
}


@pytest.mark.parametrize("case", sorted(INACTIVE))
def test_inactive_flag_encodes_as_flag_off(case):
    make, off = INACTIVE[case]
    o = make()
    flag_off = dataclasses.replace(o, **off)
    pcm = ti.make_signal("burst", 0.25, SR, 2, 27)
    assert o != flag_off and _encode(o, pcm) == _encode(flag_off, pcm)

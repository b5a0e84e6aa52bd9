"""The port's spec_strict slice against the JAX package (CPU).

- every strict table, indexed directly in the port, equals the JAX
  where-tree lookup over its whole index range;
- each strict op (entropy layout, sweep, finalize, chunks, scalefactor laws,
  scfsi, reorders) matches its JAX twin exactly on the same inputs (integer
  stages) or within the JAX tests' tolerances (float stages);
- the strict chunk program equals jax.jit(make_chunk_fn) at B=2 x T=2, on
  integer outputs, from a fresh carry and from one whose priced and real
  stream-length mirrors differ;
- a strict carry JAX -> port -> JAX mid-stream;
- sessions: the 4 strict rows of tests/fixture_lib.FIXTURES structurally
  equal to the JAX backend's committed streams, the telemetry corpus against
  the golden encoder's frozen strict streams within the JAX ceiling, and
  batches equal to sessions.

One chunk program of the JAX package is compiled here, shared by the chunk
and the checkpoint tests. The JAX ops run under jax.jit, grouped into a few
cached compiles: compiling is far cheaper than dispatching them eagerly on
the CPU, and each compile costs seconds.
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
from swiftmp3_tpu.tables import HUFFMAN_TABLES
from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.models import pipeline as tpipe
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.options import MP3EncoderOptions
from swiftmp3_tpu_torch.parallel.batch import encode_batch

from .torch_inputs import STRICT_FIXTURES, STRICT_OPTIONS, corpus_stereo, fixture_path
from .torch_inputs import golden_path, make_signal
from .util import parse_frames

torch.set_num_threads(1)

CPU = torch.device("cpu")
SRS = [32000, 44100, 48000]
# Frames whose bytes may differ from the JAX backend's committed strict
# streams (measured 0 of 66 on the CPU) and the JAX backend's own strict
# ceiling on the telemetry corpus (tests/test_ulp_telemetry.py; it measured
# 8/72, the port 4/72 on the CPU).
STRICT_FIXTURE_FLIP_CEILING = 2
STRICT_TELEMETRY_FLIP_CEILING = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.array_equal(got, np.asarray(want))


def _jit(fn, **static):
    """fn under jax.jit with its static keyword arguments bound."""
    return jax.jit(functools.partial(fn, **static))


def _strict_options(**extra):
    kw = dict(STRICT_OPTIONS, **extra)
    jkw = dict(kw, mode=JaxMode(kw["mode"]))
    return MP3EncoderOptions.spec_strict(**kw), JaxOptions.spec_strict(**jkw)


def _spectra(seed: int, shape=(2, 2, 3, 2)) -> np.ndarray:
    """Granule spectra over a wide level range, with one silent granule, a
    loud low band and bands of exact zeros (empty scalefactor bands)."""
    rng = np.random.default_rng(seed)
    scale = 10 ** rng.uniform(-4, 0.5, shape + (1,))
    spec = (rng.standard_normal(shape + (576,)) * scale).astype(np.float32)
    spec.reshape(-1, 576)[1] = 0.0
    spec.reshape(-1, 576)[2, :40] *= 30.0
    spec.reshape(-1, 576)[3, 100:200] = 0.0
    return spec


def _blocks(shape, seed: int) -> np.ndarray:
    b = np.random.default_rng(seed).choice([0, 1, 2], shape).astype(np.int32)
    b.reshape(-1)[:3] = [0, 1, 2]
    return b


def _quantized(seed: int, n: int = 24) -> np.ndarray:
    """Quantized granules: magnitudes 0-15 with zero tails of every length,
    all-zero and all-one granules, count1 regions at both alignments."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-15, 16, (n, 576)).astype(np.int32)
    q = (q * (rng.random((n, 576)) < rng.uniform(0.05, 1.0, (n, 1)))).astype(np.int32)
    for i in range(n):
        tail = int(rng.integers(0, 577))
        q[i, tail:] = 0
        ones = int(rng.integers(0, 120))
        q[i, max(tail - ones, 0) : tail] = np.sign(q[i, max(tail - ones, 0) : tail])
    q[0] = 0
    q[1] = 1
    q[2, :] = 0
    q[2, 575] = -1
    return q


# --- tables ---------------------------------------------------------------------


_jax_pair_len = jax.jit(jdsp._pair_len_by_tid)
_jax_pair_code = jax.jit(jdsp._pair_code_by_tid)


@pytest.mark.parametrize("tid", [0, 1, 2, 5, 7, 15])
def test_pair_tables_equal_the_jax_lookups(tid):
    idx = jnp.arange(256, dtype=jnp.int32)
    tids = jnp.full((256,), tid, jnp.int32)
    assert _eq(tdsp.PAIR_LEN[tid], _jax_pair_len(tids, idx))
    # codes: the JAX dense lookup is defined inside the table's corner only
    n = HUFFMAN_TABLES[tid].max_value + 1 if tid else 16
    inside = ((np.arange(256) >> 4) < n) & ((np.arange(256) & 15) < n)
    want = np.where(inside, np.asarray(_jax_pair_code(tids, idx)), 0)
    assert _eq(tdsp.PAIR_CODE[tid], want)
    signs = (np.arange(256) >> 4 != 0).astype(np.int32) + (np.arange(256) & 15 != 0)
    assert _eq(tdsp.PAIR_COST[tid], (tdsp.PAIR_LEN[tid] + signs) * (tid != 0))


def test_table_for_max_and_count1_tables():
    m = jnp.arange(16, dtype=jnp.int32)
    assert _eq(tdsp.TABLE_FOR_MAX, jax.jit(jdsp._table_for_max_device)(m))
    for words, table in (
        (jdsp._COUNT1A_LEN_WORDS, tdsp.COUNT1A_LEN_T),
        (jdsp._COUNT1A_CODE_WORDS, tdsp.COUNT1A_CODE_T),
    ):
        assert _eq(table, jax.jit(functools.partial(jdsp._nibble_lookup, words))(m))


def test_scalefactor_constants_equal_the_reference():
    assert tdsp.SLEN_TABLE == jref.SLEN_TABLE
    assert tdsp.SF_SLOTS == jref.SF_SLOTS == jdsp.SF_SLOTS
    assert tdsp.SCFSI_GROUPS == jref.SCFSI_GROUPS
    assert (tdsp.PSY_SLOPE, tdsp.PSY_ALPHA_NUM, tdsp.PSY_ALPHA_DEN) == (
        jref.PSY_SLOPE, jref.PSY_ALPHA_NUM, jref.PSY_ALPHA_DEN)
    # the port prices every grid gain exactly: the reference's anchors are all 20
    assert jref.STRICT_ANCHORS == tuple(range(tdsp.N_GAIN_CANDIDATES))
    sf = jnp.arange(16, dtype=jnp.int32)
    assert tdsp.SF_MULT34.tobytes() == np.asarray(jax.jit(jdsp.sf_mult34_lookup)(sf)).tobytes()
    # every (need1, need2) the compress table covers, through the JAX finisher
    slots = np.zeros((25, 36), np.int32)
    for n1 in range(5):
        for n2 in range(5):
            slots[n1 * 5 + n2, 0] = (1 << n1) - 1
            slots[n1 * 5 + n2, 11] = (1 << n2) - 1
    want = _jit(jdsp._finish_slots_device, n1_slots=11, n2_slots=10)(jnp.asarray(slots))
    got = tdsp._finish(_t(slots), 11, 10)
    for k in ("compress", "slen1", "slen2", "slot_nbits", "part2"):
        assert _eq(got[k], want[k]), k


@functools.lru_cache(maxsize=None)
def _jax_reorders():
    """Region bounds and both reorders (long head kept or not) of the JAX
    package at every MPEG-1 rate, one compile."""
    r0, r1 = np.meshgrid(np.arange(15), np.arange(8))
    r0, r1 = r0.ravel().astype(np.int32), r1.ravel().astype(np.int32)
    x = np.random.default_rng(1).standard_normal((3, 576)).astype(np.float32)

    def run(r0, r1, x):
        return {
            sr: {
                "bounds": jdsp._region_bounds(r0, r1, sr),
                **{
                    f"{way}_{mixed}": fn(x, sr, mixed)
                    for mixed in (False, True)
                    for way, fn in (
                        ("stream", jdsp.reorder_natural_to_stream),
                        ("natural", jdsp.reorder_stream_to_natural),
                    )
                },
            }
            for sr in SRS
        }

    return (r0, r1, x), jax.jit(run)(r0, r1, x)


@pytest.mark.parametrize("sr", SRS)
def test_region_bounds_and_reorders(sr):
    (r0, r1, x), want = _jax_reorders()
    want = want[sr]
    for a, b in zip(tdsp._region_bounds(_t(r0), _t(r1), sr), want["bounds"]):
        assert _eq(a, b)
    for mixed in (False, True):
        s_t = tdsp.reorder_natural_to_stream(_t(x), sr, mixed)
        assert _eq(s_t, want[f"stream_{mixed}"])
        assert _eq(tdsp.reorder_stream_to_natural(s_t, sr, mixed), x)
        assert _eq(tdsp.reorder_stream_to_natural(_t(x), sr, mixed), want[f"natural_{mixed}"])


# --- entropy layout, sweep, finalize, chunks --------------------------------------

LAYOUT_SR = 44100


@functools.lru_cache(maxsize=None)
def _jax_layouts():
    """The JAX layout of _quantized granules under every (count1_coding,
    region_table_select), and the strict chunks of the full layout, one
    compile."""
    q = _quantized(2)
    is_long = np.random.default_rng(3).random(q.shape[0]) < 0.6

    def run(q, is_long):
        lays = {
            f"{c1}_{rts}": jdsp.strict_layout_device(q, LAYOUT_SR, is_long, c1, rts)
            for c1 in (False, True)
            for rts in (False, True)
        }
        return lays, jdsp.strict_chunks_device(q, lays["True_True"])

    return q, is_long, *jax.jit(run)(q, is_long)


@pytest.mark.parametrize("count1", [False, True])
@pytest.mark.parametrize("rts", [False, True])
def test_strict_layout_device(count1, rts):
    q, is_long, lays, _ = _jax_layouts()
    want = lays[f"{count1}_{rts}"]
    got = tdsp.strict_layout_device(_t(q), LAYOUT_SR, _t(is_long), count1, rts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32 and _eq(got[k], want[k]), k
    # unsigned input (the sweep's) gives the same layout
    got_abs = tdsp.strict_layout_device(_t(np.abs(q)), LAYOUT_SR, _t(is_long), count1, rts, True)
    for k in want:
        assert _eq(got_abs[k], want[k]), k


def test_strict_chunks_device():
    q, _, lays, (c_j, n_j) = _jax_layouts()
    lay = lays["True_True"]
    c_t, n_t = tdsp.strict_chunks_device(_t(q), {k: _t(v) for k, v in lay.items()})
    assert _eq(c_t, c_j) and _eq(n_t, n_j)
    assert int(n_t.sum()) == int(np.asarray(lay["bits"]).sum())


SWEEP_SR = 48000


@functools.lru_cache(maxsize=None)
def _jax_strict_ops():
    """One compile of the JAX strict ops over spectra with all three block
    types (the second granule of stream 0 equal to its first, so scfsi
    shares): scalefactors (iso_short, and psy without it at 32 kHz), the
    initial gains, masking thresholds, the sweep (iso_short), a selection
    with some granules that fit nothing, strict_finalize, scfsi with its
    part2 and the scalefactor chunks. Returns (inputs, outputs) as numpy."""
    spec = _spectra(5)
    spec[0, :, :, 1] = spec[0, :, :, 0]
    block = _blocks(spec.shape[:-1], 5)
    block[0] = 0
    rng = np.random.default_rng(6)
    max_bits = rng.integers(-20, 2500, block.shape).astype(np.int32)
    max_bits.reshape(-1)[:3] = -1  # no candidate fits: the overflow quirk

    def run(spec, block, max_bits):
        is_long = block == jdsp.BLOCK_LONG
        sfd = jdsp.granule_scalefactors_device(spec, SWEEP_SR, block, iso_short=True)
        g0 = jdsp.initial_gain_scaled(spec, sfd["mag_scale"])
        pre = jdsp.rate_loop_precompute_strict(
            spec, g0, SWEEP_SR, is_long, True, True, True, mag_scale=sfd["mag_scale"],
            part2=sfd["part2"], block=block, iso_short=True,
        )
        k_sel, has_fit, _ = jdsp.rate_loop_select(
            pre["bits"], pre["evaluated"], pre["k_budget"], max_bits
        )
        gain, q, lay = jdsp.strict_finalize(pre, k_sel, has_fit)
        nib, write = jdsp.scfsi_device(sfd["sf"], is_long)
        return {
            "sfd": sfd,
            "sfd_psy": jdsp.granule_scalefactors_device(spec, 32000, block, psy=True),
            "g0": g0,
            "masking": jdsp.masking_thresholds(spec, SWEEP_SR, 3),
            "pre": {k: v for k, v in pre.items() if k not in ("iso", "strict", "linbits")},
            "k_sel": k_sel,
            "has_fit": has_fit,
            "final": (gain, q, lay),
            "scfsi": (nib, write, jdsp.scfsi_part2_device(sfd, write)),
            "sf_chunks": jdsp.scalefactor_chunks_device(sfd, write),
        }

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(spec, block, max_bits))
    return (spec, block), out


def test_granule_scalefactors():
    (spec, block), want = _jax_strict_ops()
    for sr, psy, iso_short, ref in (
        (SWEEP_SR, False, True, want["sfd"]),
        (32000, True, False, want["sfd_psy"]),
    ):
        got = tdsp.granule_scalefactors_device(_t(spec), sr, _t(block), psy=psy, iso_short=iso_short)
        assert sorted(ref) <= sorted(got)
        for k in ref:
            # mag_scale: the same float32 powers of two, placed by a gather
            assert got[k].dtype == _t(ref[k]).dtype and _eq(got[k], ref[k]), (sr, k)
        assert ref["part2"].any()


def test_initial_gain_scaled_and_masking_thresholds():
    (spec, _), want = _jax_strict_ops()
    got = tdsp.initial_gain_scaled(_t(spec), _t(want["sfd"]["mag_scale"]))
    assert _eq(got, want["g0"])
    got = tdsp.masking_thresholds(_t(spec), SWEEP_SR, 3).numpy()
    np.testing.assert_allclose(got, want["masking"], rtol=1e-5)


def test_rate_loop_precompute_strict():
    (spec, block), want = _jax_strict_ops()
    sfd, pre_j = want["sfd"], want["pre"]
    args = dict(mag_scale=_t(sfd["mag_scale"]), part2=_t(sfd["part2"]))
    pre_t = tdsp.rate_loop_precompute_strict(
        _t(spec), _t(want["g0"]), SWEEP_SR, _t(block == 0), True, True, True, **args,
        block=_t(block), iso_short=True,
    )
    for k in ("gstart", "k_budget", "bits", "evaluated", "sign_neg"):
        assert _eq(pre_t[k], pre_j[k]), k
    np.testing.assert_allclose(pre_t["mag"].numpy(), pre_j["mag"], rtol=2e-7)
    assert pre_t["strict"] == (SWEEP_SR, True, True)
    # without iso_short the sweep takes its input as given: fed the
    # stream-ordered spectra and amplification, it prices the same bits
    perm = tdsp.build_reorder_perms(SWEEP_SR)[block]
    plain = tdsp.rate_loop_precompute_strict(
        _t(np.take_along_axis(spec, perm, -1)), _t(want["g0"]), SWEEP_SR, _t(block == 0), True,
        True, True, mag_scale=_t(np.take_along_axis(sfd["mag_scale"], perm, -1)),
        part2=args["part2"],
    )
    for k in ("gstart", "bits", "mag", "sign_neg"):
        assert _eq(plain[k], pre_t[k]), k


def test_strict_finalize():
    (_, block), want = _jax_strict_ops()
    pre_t = {k: _t(v) for k, v in want["pre"].items()}
    pre_t.update(iso=True, strict=(SWEEP_SR, True, True))
    assert not want["has_fit"].all() and want["has_fit"].any()
    g_t, q_t, lay_t = tdsp.strict_finalize(pre_t, _t(want["k_sel"]), _t(want["has_fit"]))
    g_j, q_j, lay_j = want["final"]
    assert _eq(g_t, g_j) and _eq(q_t, q_j)
    for k in lay_j:
        assert _eq(lay_t[k], lay_j[k]), k


def test_scfsi_and_scalefactor_chunks():
    (_, block), want = _jax_strict_ops()
    sfd_t = {k: _t(v) for k, v in want["sfd"].items()}
    nib_j, write_j, part2_j = want["scfsi"]
    nib_t, write_t = tdsp.scfsi_device(sfd_t["sf"], _t(block == 0))
    assert _eq(nib_t, nib_j) and _eq(write_t, write_j)
    assert (nib_t.numpy() == 15).any() and (nib_t.numpy() == 0).any()
    assert _eq(tdsp.scfsi_part2_device(sfd_t, write_t), part2_j)
    c_t, n_t = tdsp.scalefactor_chunks_device(sfd_t, write_t)
    assert _eq(c_t, want["sf_chunks"][0]) and _eq(n_t, want["sf_chunks"][1])
    c_t, n_t = tdsp.scalefactor_chunks_device(sfd_t)
    assert _eq(c_t, want["sfd"]["sf_slots"]) and _eq(n_t, want["sfd"]["slot_nbits"])


# --- the chunk program -----------------------------------------------------------


def _chunk_input(B, T, seed):
    """Correlated stereo (M/S frames) with an antiphase frame (the symmetric
    arm), a decorrelated frame (L/R) and attacks whose loudest sub-block is
    the last (SHORT) or the first (MIXED); stream 0 starts quiet."""
    rng = np.random.default_rng(seed)
    left = rng.standard_normal((B, T, 1152)).astype(np.float32) * 0.2
    for i in range(1, 5):
        left[..., i:] += left[..., :-i] / (i + 1)
    right = left * np.float32(0.9) + rng.standard_normal(left.shape).astype(np.float32) * 0.01
    right[1, 0] = -0.9 * left[1, 0]
    right[0, 1] = rng.standard_normal(1152).astype(np.float32) * 0.2
    left[0, 0] *= 0.01
    right[0, 0] *= 0.01
    for x in (left, right):
        x[0, 0, 576 + 400 : 576 + 500] *= 300.0
        x[1, 1, :150] *= 30.0
    return np.stack([left, right], axis=-1).reshape(B, T, 2304)


CHUNK_B, CHUNK_T = 2, 2


@functools.lru_cache(maxsize=None)
def _chunk_programs():
    """The strict chunk program of both packages (spec_strict, scfsi and
    psy_scalefactors on), the JAX one jitted once for the file."""
    o, jo_opts = _strict_options(scfsi=True, psy_scalefactors=True)
    return o, jo_opts, jax.jit(jpipe.make_chunk_fn(jo_opts)), tpipe.make_chunk_fn(o)


def _carry_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        ref = np.asarray(want[name])
        if ref.dtype == np.float32:
            np.testing.assert_allclose(np.asarray(v), ref, rtol=1e-6, atol=1e-7, err_msg=name)
        else:
            assert _eq(v, ref), name


def test_strict_chunk_program_matches_jax():
    o, jo_opts, jrun, trun = _chunk_programs()
    B, T = CHUNK_B, CHUNK_T
    final = np.zeros((B, T), bool)
    valid = np.ones((B, T), bool)
    valid[1, 1] = False  # stream 1 ends inside the first chunk
    jc = jpipe.init_carry(B, jo_opts)
    tc = tpipe.init_carry(B, o, CPU)
    seen = set()
    for k in range(3):
        pcm = _chunk_input(B, T, k)
        if k == 2:
            # a checkpoint whose priced mirror leads its real one
            jc = {**jc, "est_stream_len": np.asarray(jc["stream_len"]) + np.int32(37)}
            tc = {**tc, "est_stream_len": _t(jc["est_stream_len"])}
        jc, jo = jrun(jc, pcm, final, valid)
        tc, to = trun(tc, _t(pcm), _t(final), _t(valid))
        want = jpipe.fetch_outputs(jo, jo_opts)
        got = tpipe.fetch_outputs(to, o)
        assert sorted(got) == sorted(want)
        for name in want:
            assert _eq(got[name], want[name]), (k, name)
        assert _eq(to["packed"], jo["packed"])
        seen |= set(np.unique(want["block_type"])) | {f"ms{m}" for m in np.unique(want["mode_ext"])}
        valid = np.ones((B, T), bool)
    assert {0, 1, 2, "ms0", "ms2"} <= seen and (np.asarray(want["scfsi"]) != 0).any()
    assert not np.array_equal(np.asarray(jc["est_stream_len"]), np.asarray(jc["stream_len"]))
    _carry_equal({k: v.numpy() for k, v in tc.items()}, {k: jc[k] for k in tc})


def test_strict_checkpoint_jax_to_port_and_back():
    """A strict carry crosses JAX -> port -> JAX mid-stream (carry_from_jax,
    carry_to_jax): the port's chunk after a JAX chunk, and the JAX chunk
    after the port's, equal an all-JAX run, bytes and carry."""
    o, jo_opts, jrun, trun = _chunk_programs()
    B, T = CHUNK_B, CHUNK_T
    final = np.zeros((B, T), bool)
    valid = np.ones((B, T), bool)
    pcms = [_chunk_input(B, T, 10 + k) for k in range(3)]
    ref_c = jpipe.init_carry(B, jo_opts)
    ref = []
    for pcm in pcms:
        ref_c, jo = jrun(ref_c, pcm, final, valid)
        ref.append(np.asarray(jo["packed"]))
    jc, _ = jrun(jpipe.init_carry(B, jo_opts), pcms[0], final, valid)
    tc = tpipe.carry_from_jax({k: np.asarray(v) for k, v in jc.items()}, CPU)
    tc, to = trun(tc, _t(pcms[1]), _t(final), _t(valid))
    assert _eq(to["packed"], ref[1])
    jc, jo = jrun(tpipe.carry_to_jax(tc), pcms[2], final, valid)
    assert _eq(jo["packed"], ref[2])
    _carry_equal({k: np.asarray(v) for k, v in jc.items()}, ref_c)


def test_strict_host_contract_matches_jax():
    """frame_results_from_outputs reads mixed and short granules, their
    scalefactor fields and the per-frame mode_extension as the JAX function
    does."""
    o, jo_opts = _strict_options()
    B, T = 2, 3
    _, outs = tpipe.make_chunk_fn(o)(
        tpipe.init_carry(B, o, CPU), _t(_chunk_input(B, T, 0)),
        torch.zeros(B, T, dtype=torch.bool), torch.ones(B, T, dtype=torch.bool),
    )
    got = tpipe.fetch_outputs(outs, o)
    want = jpipe.fetch_outputs({"packed": outs["packed"].numpy()}, jo_opts)
    assert {0, 1, 2} <= set(np.unique(got["block_type"]))
    for b in range(B):
        for t in range(T):
            fr_t = tpipe.frame_results_from_outputs(got, o, t, b)
            fr_j = jpipe.frame_results_from_outputs(want, jo_opts, t, b)
            assert [[dataclasses.astuple(g) for g in gr] for gr in fr_t.granules] == [
                [dataclasses.astuple(g) for g in gr] for gr in fr_j.granules
            ]
            for f in ("bitrate_index", "padding", "main_data_begin", "slot_size",
                      "scfsi", "mode_ext", "main_data"):
                assert getattr(fr_t, f) == getattr(fr_j, f), f


# --- sessions ------------------------------------------------------------------


def _flips(got: bytes, ref: bytes) -> int:
    fg, fr = parse_frames(got), parse_frames(ref)
    assert [(f.size, got[f.offset : f.offset + 4]) for f in fg] == [
        (f.size, ref[f.offset : f.offset + 4]) for f in fr
    ]
    return sum(
        got[a.offset : a.offset + a.size] != ref[b.offset : b.offset + b.size]
        for a, b in zip(fg, fr)
    )


@pytest.mark.parametrize("row", STRICT_FIXTURES, ids=[f[0] for f in STRICT_FIXTURES])
def test_strict_fixture_rows_match_the_jax_streams(row):
    name, kw, kind, seconds, seed = row
    o = MP3EncoderOptions(**kw)
    pcm = make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    s = new_session(o, CPU)
    got = s.encode(pcm) + s.flush()
    with open(fixture_path(name, "tpu"), "rb") as fh:
        assert _flips(got, fh.read()) <= STRICT_FIXTURE_FLIP_CEILING


def test_strict_flip_rate_vs_golden_on_the_telemetry_corpus():
    o = MP3EncoderOptions.spec_strict(**STRICT_OPTIONS)
    bad = total = 0
    for stem, pcm in corpus_stereo().items():
        s = new_session(o, CPU)
        got = s.encode(pcm) + s.flush()
        with open(golden_path(f"corpus_{stem}", "strict"), "rb") as fh:
            ref = fh.read()
        bad += _flips(got, ref)
        total += len(parse_frames(ref))
    assert total == 72 and bad <= STRICT_TELEMETRY_FLIP_CEILING


def test_strict_batch_matches_sessions():
    """encode_batch over streams of different lengths (an exact frame
    multiple, a partial last frame, int16) equals one session per stream."""
    o = MP3EncoderOptions.spec_strict(**STRICT_OPTIONS)
    base = make_signal("burst", 0.4, 44100, 2, 25)
    streams = [
        base,
        base[: 2 * 1152 * 5],
        base[::-1].copy()[: 2 * 4000 + 2],
        (make_signal("mix", 0.2, 44100, 2, 26) * 32767).astype(np.int16),
    ]
    got = encode_batch(o, streams, CPU, frames_per_step=4)
    for pcm, data in zip(streams, got):
        s = new_session(o, CPU)
        assert data == s.encode(pcm) + s.flush()


def test_strict_carry_keeps_both_stream_mirrors():
    """carry_from_jax / carry_to_jax round-trip a strict checkpoint whose
    priced and real stream-length mirrors differ."""
    _, jo_opts = _strict_options()
    state = {k: np.asarray(v) for k, v in jpipe.init_carry(2, jo_opts).items()}
    state["stream_len"] = np.array([120, 7], np.int32)
    state["est_stream_len"] = np.array([131, 0], np.int32)
    back = tpipe.carry_to_jax(tpipe.carry_from_jax(state, CPU))
    assert sorted(back) == sorted(state)
    for k in state:
        assert back[k].dtype == state[k].dtype and np.array_equal(back[k], state[k]), k

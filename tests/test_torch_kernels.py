"""The port's kernels: plain versions against the Pallas kernels, dispatch.

On the CPU the plain PyTorch versions of K1 (rate sweep) and K2 (pack) are
held bit-exact against the JAX package's Pallas kernels run in interpret
mode, as the JAX package's own tests run them; K3's (the polyphase
filterbank) within the JAX package's own K3 tolerance, 2e-5, against the
stepwise filterbank and the Pallas kernel. The CUDA kernels themselves run
only on a card (tests/test_torch_cuda.py). A mocked launch shows that a CUDA
tensor never reaches a plain version, a mocked library that the C call runs
with the tensors' device current, and a mocked nvcc that a failed build
raises; K2's launch plan (its grid, tiles and shared memory) is held to the
constants of its CUDA source.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swiftmp3_tpu.io.huffman_pack import pack_chunks, pack_frame_main_data
from swiftmp3_tpu.ops import dsp as jdsp
from swiftmp3_tpu.ops import pallas_kernels as pk
from swiftmp3_tpu_torch.ops import dsp as tdsp
from swiftmp3_tpu_torch.ops import kernels

from .torch_inputs import (
    SCAN_OPTIONS,
    fma_knife_edges,
    knife_edge_sweep_input,
    pack_input,
    polyphase_input,
    scan_input,
    scan_options,
    strict_pack_input,
    strict_sweep_input,
    sweep_input,
)

torch.set_num_threads(1)

# ... and the strict path's slots a frame: 1872 in stereo, 936 in mono
PACK_SHAPES = [
    (16, 1152, 894), (5, 576, 894), (8, 1812, 1536), (3, 1152, 2160),
    (4, 1872, 894), (4, 936, 910),
]
K3_TOLERANCE = 2e-5  # tests/test_pallas.py
NO_LAUNCHES = {
    "rate_sweep": 0, "pack": 0, "polyphase": 0, "rate_loop_scan": 0, "placement_scan": 0,
    "strict_sweep": 0,
}


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


def test_sweep_cost_table_is_pair_length_plus_sign_bits():
    """The CUDA sweep's one lookup per pair: cost[16 qx + qy] is the table-15
    code length plus one sign bit per nonzero value, for all 256 pairs, and
    fits a byte."""
    cost = kernels.sweep_cost_table(torch.device("cpu"))
    assert cost.dtype == torch.uint8 and cost.shape == (256,) and cost.is_contiguous()
    want = [
        int(tdsp.T15_LEN[16 * qx + qy]) + (qx != 0) + (qy != 0)
        for qx in range(16)
        for qy in range(16)
    ]
    assert max(want) <= 255 and cost.tolist() == want
    assert np.array_equal(tdsp.T15_LEN, np.asarray(jdsp._T15_LEN).reshape(-1))


@pytest.mark.parametrize("iso", [False, True])
def test_sweep_quantizer_without_conversions_equals_floor_and_clamp(iso):
    """A float32 model of the CUDA sweep's quantizer: s = mag*inv + 0.5 (the
    product and the sum rounded apart), t = min(s, 15.5), w = t + 2^23
    rounded toward minus infinity, q = the low four bits of w's pattern. It
    equals min(floor(s), 15) on the FMA knife edges of every gain, around
    every integer and half-integer up to 17, and at 0, subnormals, 1e30,
    +inf and NaN (which clamps to 15, as fminf(floorf(NaN), 15) does)."""
    table = (tdsp.INV_STEP34 if iso else tdsp.INV_STEP).astype(np.float32)
    sums = []
    for g, mags in fma_knife_edges(table).items():
        sums.append((mags * table[g]).astype(np.float32) + np.float32(0.5))
    near = np.arange(0, 35, dtype=np.float32) / np.float32(2)  # 0, 0.5, .. 17
    lo = hi = near
    around = [near]
    for _ in range(3):
        lo = np.nextafter(lo, np.float32(-1))
        hi = np.nextafter(hi, np.float32(np.inf))
        around += [lo, hi]
    special = np.array([0.0, 1e-45, 1e-38, 1e-10, 1e30, np.inf, np.nan], np.float32)
    for m in np.concatenate([special[:5], np.float32([0.3, 7.0, 3e4])]):
        sums.append((m * table).astype(np.float32) + np.float32(0.5))  # every gain
    s = np.concatenate(sums + around + [special]).astype(np.float32)
    s = s[~(s < 0)]  # magnitudes and inverse steps are never negative
    assert s.size > 2000 and np.isnan(s).any() and np.isinf(s).any()

    t = np.fmin(s, np.float32(15.5))  # fminf: the number, when one side is NaN
    # t + 2^23 rounded down to float32 (whose spacing there is 1): the float64
    # sum is exact for t >= 2^-6, and below that both are 2^23 + a fraction
    w = np.floor(t.astype(np.float64) + 8388608.0).astype(np.float32)
    assert np.array_equal(w.astype(np.float64), np.floor(t.astype(np.float64) + 8388608.0))
    q = w.view(np.uint32) & 15
    assert np.array_equal(w.view(np.uint32) >> 4, np.full(s.shape, 0x4B000000 >> 4, np.uint32))
    want = np.fmin(np.floor(s), np.float32(15.0)).astype(np.uint32)
    assert np.array_equal(q, want)
    # the pair index: the two patterns combine under one mask
    wx, wy = w.view(np.uint32)[:-1], w.view(np.uint32)[1:]
    assert np.array_equal((wx * np.uint32(16) + wy) & np.uint32(255), 16 * want[:-1] + want[1:])


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


@pytest.mark.parametrize("mode", ["joint_stereo", "mono"])
def test_pack_plain_matches_host_packer_on_strict_frames(mode):
    """The strict chunk program's frames (scalefactor slots, then pair and
    quad slots a granule) pack as the reference's host packer packs them."""
    chunks, nbits, cap = strict_pack_input(torch.device("cpu"), mode=mode)
    assert chunks.shape[1] == (1872 if mode == "joint_stereo" else 936)
    by, total = kernels.pack(chunks, nbits, cap)
    c, n = chunks.numpy(), nbits.numpy()
    assert (n[:, :36] > 0).any()  # scalefactor slots lead granule 0
    for f in range(c.shape[0]):
        live = n[f] > 0
        host, bits = pack_chunks(c[f][live].astype(np.int64), n[f][live].astype(np.int64))
        assert int(total[f]) == bits and by[f, : len(host)].numpy().tobytes() == host


def test_pack_plain_truncates_at_cap_like_xla():
    """Frames longer than the cap: bytes past it are dropped, total_bits is
    the full count (the host then rejects hb > cap)."""
    ch, nb = pack_input(4, 1152, 894, seed=2, overflow=True)
    b_x, t_x = jdsp.pack_main_data(jnp.asarray(ch), jnp.asarray(nb), 894)
    by, tot = kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), 894)
    assert np.array_equal(by.numpy(), np.asarray(b_x))
    assert np.array_equal(tot.numpy(), np.asarray(t_x))
    assert int(tot.min()) > 894 * 8


def test_polyphase_plain_matches_stepwise_and_pallas():
    hist, pcm = polyphase_input()
    S_ref, x_ref = jdsp.polyphase_chunk(jnp.asarray(hist), jnp.asarray(pcm))
    S_pal, x_pal = pk.polyphase_chunk_pallas(jnp.asarray(hist), jnp.asarray(pcm), interpret=True)
    S, x = kernels.polyphase_chunk(torch.from_numpy(hist), torch.from_numpy(pcm))
    assert S.shape == S_ref.shape == (3, 2, 288, 32)
    assert np.abs(S.numpy() - np.asarray(S_ref)).max() <= K3_TOLERANCE
    assert np.abs(S.numpy() - np.asarray(S_pal)).max() <= K3_TOLERANCE
    assert np.array_equal(x.numpy(), np.asarray(x_ref))
    assert np.array_equal(x.numpy(), np.asarray(x_pal))


@pytest.mark.parametrize("T", [3, 5])
def test_polyphase_plain_matches_stepwise_when_windows_are_no_multiple_of_96(T):
    """36T = 108 or 180 windows: not a multiple of the Pallas tile (96),
    which the Pallas kernel asserts; the plain version takes any T."""
    hist, pcm = polyphase_input(B=2, ch=1, T=T, seed=T)
    S_ref, x_ref = jdsp.polyphase_chunk(jnp.asarray(hist), jnp.asarray(pcm))
    S, x = kernels.polyphase_chunk_plain(torch.from_numpy(hist), torch.from_numpy(pcm))
    assert S.shape == (2, 1, 36 * T, 32)
    assert np.abs(S.numpy() - np.asarray(S_ref)).max() <= K3_TOLERANCE
    assert np.array_equal(x.numpy(), np.asarray(x_ref))


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
    monkeypatch.setattr(kernels, "polyphase_chunk_plain", no_plain)
    monkeypatch.setattr(kernels, "rate_loop_scan_plain", no_plain)
    monkeypatch.setattr(kernels, "placement_scan_plain", no_plain)
    monkeypatch.setattr(kernels, "strict_sweep_plain", no_plain)
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))

    mag, g0 = sweep_input(9)
    bits, bv = kernels.rate_sweep(torch.from_numpy(mag), torch.from_numpy(g0))
    assert bits.shape == (9, 20) and bv.shape == (9, 20)
    ch, nb = pack_input(3, 576, 894)
    by, tot = kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), 894)
    assert by.shape == (3, 894) and tot.shape == (3,)
    hist, pcm = polyphase_input(B=2, ch=2, T=3)
    S, x = kernels.polyphase_chunk(torch.from_numpy(hist), torch.from_numpy(pcm))
    assert S.shape == (2, 2, 108, 32) and x.shape == (2, 2, 480 + 3 * 1152)
    cfg, carry, ins, p_carry, hb = scan_input(scan_options("hq_joint"), B=3, T=5)
    new, outs = kernels.rate_loop_scan(cfg, carry, **ins)
    assert [tuple(o.shape) for o in outs] == [(5, 3)] * 4 + [(5, 3, 4)] * 3
    assert outs[5].dtype == torch.bool and new["slot_fifo"].shape == (3, 1)
    new, mdb = kernels.placement_scan(cfg, p_carry, hb, outs[3], ins["final"], ins["valid"])
    assert mdb.shape == (5, 3) and new["stream_len"].shape == (3,)
    mag, g0, is_long, b0, part2 = (torch.from_numpy(x) for x in strict_sweep_input(6))
    bits = kernels.strict_sweep(
        mag, g0, tdsp.inv_step_table(True, mag.device), is_long, b0, part2,
        sample_rate=22050, count1_coding=True, region_table_select=True, linbits=False,
    )
    assert bits.shape == (6, 20) and bits.dtype == torch.int32
    assert launched == [
        "rate_sweep", "pack", "polyphase", "rate_loop_scan", "placement_scan", "strict_sweep",
    ]
    assert kernels.LAUNCHES == {
        "rate_sweep": 1, "pack": 1, "polyphase": 1, "rate_loop_scan": 1, "placement_scan": 1,
        "strict_sweep": 1,
    }


@pytest.mark.parametrize(
    "n_rows,T,tiles,per_block,blocks",
    [
        (512, 128, 18, 6, 1536),  # the main path's chunk: 3 blocks a row
        (2, 8, 2, 1, 4),  # a session chunk: 288 positions, a ragged second tile
        (6, 3, 1, 1, 6),
        (5, 5, 1, 1, 5),
        (2, 29, 5, 1, 10),
        (1024, 15, 3, 2, 2048),  # 540 positions: blocks of 2 and 1 tiles
        (4096, 128, 18, 6, 12288),  # capped at K3_MAX_TILES_PER_BLOCK, spread evenly
    ],
)
def test_polyphase_launch_plan(monkeypatch, n_rows, T, tiles, per_block, blocks):
    """The tiling the wrapper hands to the CUDA kernel: every tile of a row
    belongs to one block, blocks hold at most K3_MAX_TILES_PER_BLOCK
    consecutive tiles, and the shared-memory size is the cosine matrix, one
    tile's samples and its padded partial sums."""
    plan = kernels.polyphase_plan(n_rows, T * 1152)
    assert plan == {
        "tiles": tiles, "tiles_per_block": per_block, "blocks": blocks,
        "smem_bytes": 112512,
    }
    assert (tiles - 1) * kernels.K3_TILE < 36 * T <= tiles * kernels.K3_TILE
    per_row = blocks // n_rows
    assert (per_row - 1) * per_block < tiles <= per_row * per_block
    assert per_block <= kernels.K3_MAX_TILES_PER_BLOCK
    assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024  # two blocks an SM

    calls = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *args: calls.append(args))
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    if n_rows <= 6:
        hist, pcm = polyphase_input(B=n_rows, ch=1, T=T)
        kernels.polyphase_subbands(torch.from_numpy(hist), torch.from_numpy(pcm))
        assert calls[0][5:] == (n_rows, T * 1152, per_block, 112512)


def test_polyphase_launch_plan_refuses_a_grid_past_the_limit():
    assert kernels.polyphase_plan(2**31 - 1, 576)["blocks"] == kernels.MAX_GRID_BLOCKS
    with pytest.raises(ValueError, match="grid limit"):
        kernels.polyphase_plan(2**31, 576)
    with pytest.raises(ValueError, match="grid limit"):
        kernels.polyphase_plan(2**30, 9 * 256 * 32)  # 9 tiles a row: 2 blocks a row


def test_polyphase_plan_constants_match_the_cuda_source():
    import re

    with open(f"{kernels.CSRC_DIR}/polyphase.cu") as fh:
        src = fh.read()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == kernels.K3_TILE
    assert int(re.search(r"constexpr int kHist = (\d+);", src).group(1)) == kernels.HIST
    assert "constexpr int kPartialStride = 64 + 4;" in src
    assert "constexpr int kSmemFloats = 64 * 32 + kSpan + kTile * kPartialStride;" in src
    assert "constexpr int kSpan = 32 * kTile + kHist;" in src


@pytest.mark.parametrize(
    "F,P,cap,blocks,per_sm,tiles,smem",
    [
        (32768, 1152, 894, 264, 2, 3, 105984),  # the main path: the grid at its limit
        (2048, 1152, 894, 256, 2, 3, 105984),  # the serving pool: a warp a frame
        (12673, 1152, 894, 264, 2, 3, 105984),  # each warp 6 frames, some 7
        (32768, 576, 444, 264, 2, 2, 102272),  # LSF: one tile and a short one
        (32768, 4176, 582, 264, 2, 9, 103424),  # intensity stereo's frame
        (3, 66816, 16384, 1, 1, 131, 229888),  # the widest slots and cap: one block an SM
        (64, 1152, 2160, 8, 1, 3, 116096),  # cap 2160: past two blocks an SM
        (5, 1, 1, 1, 2, 1, 98816),
        (0, 1152, 894, 0, 2, 3, 105984),
    ],
)
def test_pack_launch_plan(monkeypatch, F, P, cap, blocks, per_sm, tiles, smem):
    """The persistent grid the wrapper hands to the CUDA kernel: no larger
    than the blocks that fit on the SMs at once, no smaller than one warp a
    frame needs; tiles of K2_TILE slots cover a frame; the blocks an SM
    holds fit its shared memory."""
    plan = kernels.pack_plan(F, P, cap)
    assert plan == {"blocks": blocks, "blocks_per_sm": per_sm, "tiles": tiles, "smem_bytes": smem}
    assert blocks <= per_sm * kernels.SM_COUNT
    assert blocks * kernels.K2_WARPS >= F or blocks == per_sm * kernels.SM_COUNT
    assert (blocks - 1) * kernels.K2_WARPS < F or F == 0
    assert (tiles - 1) * kernels.K2_TILE < max(P, 1) <= tiles * kernels.K2_TILE
    assert 1 <= per_sm <= kernels.K2_MAX_BLOCKS_PER_SM
    assert per_sm * (smem + kernels.BLOCK_SMEM_RESERVED) <= kernels.SM_SMEM_BYTES
    assert smem <= kernels.BLOCK_SMEM_BYTES

    calls = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *args: calls.append(args))
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    if 0 < F * P <= 20000:
        ch, nb = pack_input(F, P, cap)
        kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), cap)
        assert calls[0][4:] == (F, P, cap, blocks, smem)


def test_pack_plan_fits_shared_memory_at_every_cap():
    """Every cap the wrapper accepts, 1 to 16384, fits one block's 227 KB,
    at any P (the ring's tiles do not grow with P)."""
    for cap in range(1, 16385):
        plan = kernels.pack_plan(1, 66816, cap)
        assert plan["smem_bytes"] <= kernels.BLOCK_SMEM_BYTES and plan["blocks_per_sm"] >= 1
    assert kernels.pack_plan(1, 1, 894)["smem_bytes"] == kernels.pack_plan(1, 66816, 894)["smem_bytes"]
    kernels.pack_plan.cache_clear()


@pytest.mark.parametrize("kind", ["cap_zero", "cap_past", "slots_past", "dtype", "shape"])
def test_cuda_pack_wrapper_refuses_what_the_plan_cannot_hold(monkeypatch, kind):
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(kernels, "_launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    ch, nb = pack_input(2, 576, 894)
    c, n, cap = torch.from_numpy(ch), torch.from_numpy(nb), 894
    if kind == "cap_zero":
        cap = 0
    elif kind == "cap_past":
        cap = 16385
    elif kind == "slots_past":  # bit offsets past int32, scaled down
        monkeypatch.setattr(kernels, "MAX_PACK_SLOTS", 575)
        kernels.pack_plan.cache_clear()
    elif kind == "dtype":
        n = n.to(torch.int64)
    else:
        n = n[:, :575].contiguous()
    with pytest.raises((TypeError, ValueError)):
        kernels.pack(c, n, cap)
    kernels.pack_plan.cache_clear()
    assert kernels.LAUNCHES == NO_LAUNCHES


def test_pack_plan_constants_match_the_cuda_source():
    import re

    with open(f"{kernels.CSRC_DIR}/pack.cu") as fh:
        src = fh.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert constant("kWarps") == kernels.K2_WARPS
    assert constant("kTile") == kernels.K2_TILE
    assert constant("kStages") == kernels.K2_STAGES
    assert "constexpr int kMaxBlocksPerSm = 32 / kWarps;" in src
    assert kernels.K2_MAX_BLOCKS_PER_SM == 32 // kernels.K2_WARPS
    assert f"constexpr int kMaxBlockSmem = {kernels.BLOCK_SMEM_BYTES};" in src
    assert "return ((cap + 3) / 4 + 1 + 3) / 4 * 4;" in src
    assert "return 4 * (kStages * 2 * kTile + image_words(cap)) + 16 * kStages;" in src
    assert "return kWarps * warp_smem_bytes(cap);" in src


def test_cpu_tensors_take_the_plain_version_and_count_nothing(monkeypatch):
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    mag, g0 = sweep_input(5)
    kernels.rate_sweep(torch.from_numpy(mag), torch.from_numpy(g0))
    ch, nb = pack_input(2, 576, 894)
    kernels.pack(torch.from_numpy(ch), torch.from_numpy(nb), 894)
    hist, pcm = polyphase_input(B=1, ch=2, T=2)
    kernels.polyphase_chunk(torch.from_numpy(hist), torch.from_numpy(pcm))
    kernels.polyphase_subbands(torch.from_numpy(hist), torch.from_numpy(pcm))
    cfg, carry, ins, p_carry, hb = scan_input(scan_options("strict"), B=2, T=3)
    kernels.rate_loop_scan(cfg, carry, **ins)
    kernels.placement_scan(cfg, p_carry, hb, hb, ins["final"], ins["valid"])
    assert kernels.LAUNCHES == NO_LAUNCHES


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


@pytest.mark.parametrize("kind", ["dtype", "hist_shape", "whole_frames", "contiguity"])
def test_cuda_polyphase_wrapper_rejects_bad_inputs(monkeypatch, kind):
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(kernels, "_launch", lambda *a: pytest.fail("launched"))
    hist, pcm = polyphase_input(B=2, ch=1, T=2)
    hist_t, pcm_t = torch.from_numpy(hist), torch.from_numpy(pcm)
    if kind == "dtype":
        pcm_t = pcm_t.double()
    elif kind == "hist_shape":
        hist_t = hist_t[..., :479]
    elif kind == "whole_frames":
        pcm_t = pcm_t[..., :1000].contiguous()
    else:
        pcm_t = torch.from_numpy(np.asfortranarray(pcm))
    with pytest.raises((TypeError, ValueError)):
        kernels.polyphase_chunk(hist_t, pcm_t)


def test_cpu_and_cuda_inputs_do_not_mix():
    mag, g0 = sweep_input(4)
    with pytest.raises(ValueError):
        kernels._require_cuda(torch.from_numpy(mag), torch.from_numpy(g0))


@pytest.mark.parametrize("how", ["missing", "failing"])
def test_failed_kernel_build_raises(monkeypatch, tmp_path, how):
    """No nvcc, or an nvcc that fails, raises with its output; nothing is
    loaded and no plain version stands in."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    if how == "missing":
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
        monkeypatch.setenv("PATH", str(tmp_path))
        match = "nvcc not found"
    else:
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\necho 'fake nvcc: error'\nexit 3\n")
        fake.chmod(0o755)
        monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
        match = "nvcc exit 3"
    with pytest.raises(RuntimeError, match=match):
        kernels.build_kernels()
    assert kernels._libs == {}


def test_launch_runs_the_c_call_under_the_tensors_device(monkeypatch):
    """kernels._launch makes the tensors' device current around the C call
    (the entry points launch on the device cudaGetDevice names), takes that
    device's stream inside the guard, and leaves the guard after the call;
    a nonzero code still raises."""
    order = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            order.append(("enter", self.device))

        def __exit__(self, *exc):
            order.append(("exit", self.device))

    class Stream:
        cuda_stream = 77

    class Lib:
        code = 0

        def swm_rate_sweep(self, *args):
            order.append(("call", args))
            return self.code

        def swm_error_string(self, code):
            return b"refused"

    def current_stream(device):
        order.append(("stream", device))
        return Stream()

    lib = Lib()
    dev = torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setitem(kernels._libs, "rate_sweep", lib)
    kernels._launch("rate_sweep", dev, 1, 2)
    assert order == [("enter", dev), ("stream", dev), ("call", (1, 2, 77)), ("exit", dev)]
    lib.code = 98
    with pytest.raises(RuntimeError, match="error 98 .refused."):
        kernels._launch("rate_sweep", dev, 1, 2)
    assert order[-1] == ("exit", dev)


# --- K4: the scans over T ------------------------------------------------------


@pytest.mark.parametrize("preset", list(SCAN_OPTIONS))
def test_scans_take_the_plain_version_on_the_cpu(monkeypatch, preset):
    """On CPU tensors the wrappers return the plain versions' results
    (today's loops over T, op for op), launch nothing and count nothing."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    monkeypatch.setattr(kernels, "_launch", lambda *a: pytest.fail("launched"))
    cfg, carry, ins, p_carry, hb = scan_input(scan_options(preset), B=3, T=6, seed=4)
    new, outs = kernels.rate_loop_scan(cfg, carry, **ins)
    p_new, p_outs = kernels.rate_loop_scan_plain(cfg, carry, **ins)
    assert all(torch.equal(a, b) for a, b in zip(outs, p_outs))
    assert new.keys() == p_new.keys() and all(torch.equal(new[k], p_new[k]) for k in new)
    slot, final, valid = outs[3], ins["final"], ins["valid"]
    c2, mdb = kernels.placement_scan(cfg, p_carry, hb, slot, final, valid)
    p_c2, p_mdb = kernels.placement_scan_plain(cfg, p_carry, hb, slot, final, valid)
    assert torch.equal(mdb, p_mdb) and all(torch.equal(c2[k], p_c2[k]) for k in c2)
    assert kernels.LAUNCHES == NO_LAUNCHES


@pytest.mark.parametrize(
    "kind",
    ["dtype", "shape", "carry_dtype", "fifo_shape", "device", "mixed_devices", "missing",
     "unread", "placement_dtype", "placement_shape", "placement_device"],
)
def test_scan_wrappers_refuse_bad_inputs(monkeypatch, kind):
    """A wrong dtype, shape or device raises before either the plain version
    or the kernel runs, and so does an input the config needs but is not
    given (or is given but not read)."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    monkeypatch.setattr(kernels, "rate_loop_scan_plain", lambda *a, **k: pytest.fail("ran"))
    monkeypatch.setattr(kernels, "placement_scan_plain", lambda *a, **k: pytest.fail("ran"))
    cfg, carry, ins, p_carry, hb = scan_input(scan_options("hq_joint"), B=3, T=4)
    meta = torch.device("meta")
    slot = hb.clone()
    if kind == "dtype":
        ins["bits"] = ins["bits"].to(torch.int64)
    elif kind == "shape":
        ins["k_budget"] = ins["k_budget"][:, :2]
    elif kind == "carry_dtype":
        carry["vbr_ehist"] = carry["vbr_ehist"].double()
    elif kind == "fifo_shape":
        carry["slot_fifo"] = carry["slot_fifo"][:2]
    elif kind == "device":
        ins["granule_e"] = ins["granule_e"].to(meta)
    elif kind == "mixed_devices":
        carry = {k: v.to(meta) for k, v in carry.items()}
    elif kind == "missing":
        ins["demand"] = None
    elif kind == "unread":
        ins["frame_e"] = ins["granule_e"][..., 0]
    elif kind == "placement_dtype":
        hb = hb.to(torch.int16)
    elif kind == "placement_shape":
        slot = slot[:3]
    else:
        p_carry["stream_len"] = p_carry["stream_len"].to(meta)
    with pytest.raises((TypeError, ValueError)):
        if kind.startswith("placement"):
            kernels.placement_scan(cfg, p_carry, hb, slot, ins["final"], ins["valid"])
        else:
            kernels.rate_loop_scan(cfg, carry, **ins)
    assert kernels.LAUNCHES == NO_LAUNCHES


@pytest.mark.parametrize("field", ["n_gran", "depth", "cands", "frames"])
def test_scan_params_refuse_what_the_kernel_cannot_hold(field):
    cfg = scan_input(scan_options("demand_vbr"), B=1, T=1)[0]
    K, T = 1, 1
    if field == "frames":
        T = 0
    elif field == "n_gran":
        cfg = dataclasses.replace(cfg, n_gran=kernels.K4_MAX_GRANULES + 1)
    elif field == "depth":
        K = kernels.K4_MAX_DEPTH + 1
    else:
        cfg = dataclasses.replace(cfg, cands=cfg.cands + (1,) * kernels.K4_MAX_CANDS)
    with pytest.raises(ValueError):
        kernels.scan_params(cfg, 1, T, K)


@pytest.mark.parametrize(
    "preset,scans", [("compat", (1, 0)), ("energy_vbr", (1, 0)), ("strict", (1, 1)),
                     ("hq_joint", (1, 1)), ("lsf_strict", (1, 1))],
)
def test_chunk_program_runs_one_scan_a_chunk(monkeypatch, preset, scans):
    """make_chunk_fn calls rate_loop_scan once a chunk, and placement_scan
    once under the strict entropy (spec_strict, hq) and not otherwise: no
    Python loop over T is left around them."""
    from swiftmp3_tpu_torch.models import pipeline

    calls = {"rate_loop_scan": 0, "placement_scan": 0}

    def counted(name):
        fn = getattr(kernels, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return call

    for name in calls:
        monkeypatch.setattr(kernels, name, counted(name))
    o = scan_options(preset)
    B, T = 2, 3
    rng = np.random.default_rng(5)
    pcm = torch.from_numpy(
        (rng.standard_normal((B, T, o.samples_per_frame * o.channels)) * 3000).astype(np.int16)
    )
    la = torch.zeros((B, T, 576 * o.channels), dtype=torch.int16)
    run = pipeline.make_chunk_fn(o)
    carry = pipeline.init_carry(B, o, torch.device("cpu"))
    for _ in range(2):
        carry, _ = run(carry, pcm, torch.zeros((B, T), dtype=torch.bool),
                       torch.ones((B, T), dtype=torch.bool), la)
    assert (calls["rate_loop_scan"], calls["placement_scan"]) == (2 * scans[0], 2 * scans[1])


def test_scan_layout_matches_the_cuda_source():
    """The parameter block and the pointer blocks the wrapper hands K4 name
    the fields of csrc/rate_loop_scan.cu's structs in their order, and the
    kernel's limits equal the wrapper's."""
    import re

    with open(f"{kernels.CSRC_DIR}/rate_loop_scan.cu") as fh:
        src = fh.read()

    def fields(struct):
        body = re.search(rf"struct {struct} {{(.*?)}};", src, re.S).group(1)
        return re.findall(r"^\s*[\w ]+?\*? ?(\w+)(?:\[\d+\])?;", body, re.M)

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert fields("SwmScanParams") == [f[0] for f in kernels._ScanParams._fields_]
    assert fields("SwmScanIo") == [f[0] for f in kernels._ScanIo._fields_]
    assert fields("SwmPlacementIo") == [f[0] for f in kernels._PlacementIo._fields_]
    assert "int bitrates[16];" in src and kernels.K4_MAX_CANDS == 16 == constant("kTable")
    assert constant("kCandidates") == kernels.N_GAIN_CANDIDATES
    assert constant("kMaxGranules") == kernels.K4_MAX_GRANULES
    assert constant("kMaxDepth") == kernels.K4_MAX_DEPTH
    assert constant("kMaxCands") == kernels.K4_MAX_CANDS
    assert constant("kHistory") == kernels.K4_HISTORY
    assert constant("kPart23Max") == tdsp.PART23_MAX_BITS
    assert [constant(n) for n in ("kCbr", "kEnergy", "kDemand")] == list(kernels.RATE_LAWS.values())


# --- K5: the strict sweep -----------------------------------------------------------


@pytest.mark.parametrize("linbits", [False, True], ids=["table15", "linbits"])
@pytest.mark.parametrize("region_table_select", [False, True], ids=["t15", "select"])
@pytest.mark.parametrize("count1_coding", [False, True], ids=["no_count1", "count1"])
def test_strict_sweep_on_cpu_is_the_gain_loop_and_launches_nothing(
    monkeypatch, count1_coding, region_table_select, linbits
):
    """On CPU tensors kernels.strict_sweep prices each of the 20 gains as
    the sweep always has: quantize at the gain (dsp.quantize_at_gains, the
    law's step; linbits: the unfloored ISO step up to QCAP_LINBITS), lay
    the granule out (dsp.strict_layout_device), add part2. Long, switching
    and all-zero granules, gstart near 255; at MPEG-1 with the fixed 36 and
    at 22.05 kHz with the switching bounds. Nothing launches."""
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    monkeypatch.setattr(kernels, "_launch", lambda *a: pytest.fail("a CPU tensor launched"))
    for sr, seed in ((44100, 1), (22050, 2)):
        mag, g0, is_long, b0, part2 = (
            torch.from_numpy(x) for x in strict_sweep_input(16, seed, linbits, sr)
        )
        b0 = b0 if sr < 32000 else None
        iso = linbits or sr < 32000
        inv = tdsp.inv_step_table(iso, mag.device, floor=not linbits)
        got = kernels.strict_sweep(
            mag, g0, inv, is_long, b0, part2, sample_rate=sr, count1_coding=count1_coding,
            region_table_select=region_table_select, linbits=linbits,
        )
        gains = torch.clamp(g0[:, None] + 4 * torch.arange(20, dtype=torch.int32), max=255)
        q = tdsp.quantize_at_gains(
            mag, torch.zeros(mag.shape, dtype=torch.bool), gains, iso=iso,
            qcap=tdsp.QCAP_LINBITS if linbits else 15, floor=not linbits,
        )
        want = torch.stack([
            tdsp.strict_layout_device(
                q[:, a], sr, is_long, count1_coding, region_table_select, linbits=linbits,
                b0_switch=b0,
            )["bits"]
            for a in range(20)
        ], dim=-1) + part2[:, None]
        assert got.dtype == torch.int32 and torch.equal(got, want), sr
    assert kernels.LAUNCHES == NO_LAUNCHES


def test_strict_sweep_tables_hold_what_the_plain_layout_reads():
    """K5's tables: the [32 x 256] pair costs are dsp.PAIR_COST (each fits a
    byte); at each MPEG-1, MPEG-2 and MPEG-2.5 rate the region bounds of
    every big_values 0..288 are the b0 and b1 strict_layout_device lays out
    for a long granule with that big_values; table_for_max with the ESC
    bounds picks table_for_max_device's id for every maximum up to
    QCAP_LINBITS; the count1 A lengths are the layout's. The word table's
    offsets are the CUDA source's."""
    import re

    cpu = torch.device("cpu")
    cost = kernels.strict_cost_table(cpu)
    assert cost.dtype == torch.uint8 and cost.shape == (32 * 256,)
    assert np.array_equal(cost.numpy(), tdsp.PAIR_COST.reshape(-1))
    assert 0 <= tdsp.PAIR_COST.min() and tdsp.PAIR_COST.max() <= 255
    q = torch.zeros((289, 576), dtype=torch.int32)
    bv = torch.arange(289)
    q[bv[1:], 2 * bv[1:] - 1] = 2  # the last line above 1 ends big_values
    for sr in (44100, 32000, 22050, 11025, 8000):
        lut = kernels.strict_sweep_lut(sr, cpu)
        assert lut.dtype == torch.int32 and lut.shape == (kernels.K5_LUT_WORDS,)
        lay = tdsp.strict_layout_device(q, sr, torch.ones(289, dtype=torch.bool), True, True)
        assert torch.equal(lay["bv"], bv.to(torch.int32))
        region = lut[kernels.K5_LUT_REGION:kernels.K5_LUT_TABLE_FOR_MAX]
        assert torch.equal(region & 0xFFFF, lay["b0"]) and torch.equal(region >> 16, lay["b1"]), sr
    m = torch.arange(tdsp.QCAP_LINBITS + 1, dtype=torch.int32)
    tfm = lut[kernels.K5_LUT_TABLE_FOR_MAX:kernels.K5_LUT_ESC_BOUNDS]
    esc = lut[kernels.K5_LUT_ESC_BOUNDS:kernels.K5_LUT_COUNT1_LEN]
    above = ((esc[:len(tdsp.ESC_BOUNDS)][None, :] < (m - 15)[:, None]).sum(-1)).to(torch.int32)
    base = tfm[torch.clamp(m, max=15).long()]
    assert torch.equal(base[:16], tdsp.table_for_max_device(m[:16]))
    assert torch.equal(torch.where(m > 15, 24 + above, base), tdsp.table_for_max_device(m, True))
    assert torch.equal(lut[kernels.K5_LUT_COUNT1_LEN:], tdsp.constant("count1a_len", cpu))
    with open(f"{kernels.CSRC_DIR}/strict_sweep.cu") as fh:
        src = fh.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert [constant(n) for n in ("kLutRegion", "kLutTableForMax", "kLutEscBounds",
                                  "kLutCount1Len", "kLutWords", "kEscBounds")] == [
        kernels.K5_LUT_REGION, kernels.K5_LUT_TABLE_FOR_MAX, kernels.K5_LUT_ESC_BOUNDS,
        kernels.K5_LUT_COUNT1_LEN, kernels.K5_LUT_WORDS, len(tdsp.ESC_BOUNDS),
    ]


def test_strict_sweep_launch_is_counted_in_launches_and_in_the_trace(monkeypatch):
    """A card call of kernels.strict_sweep launches once (mocked here): one
    in LAUNCHES["strict_sweep"] and, while the port traces, one in the
    counter "sweep.strict_launches"; the options reach the C entry point as
    ints, an absent b0_switch or part2 as a null pointer, and the granules'
    flags broadcast to one a granule."""
    from swiftmp3_tpu_torch.utils import profiling

    calls = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *args: calls.append(args))
    monkeypatch.setattr(kernels, "LAUNCHES", dict(NO_LAUNCHES))
    mag, g0 = (torch.from_numpy(x) for x in sweep_input(6))
    g0 = g0.reshape(2, 3)
    inv = tdsp.inv_step_table(True, mag.device, floor=False)
    profiling.reset()
    profiling.enable()
    try:
        kernels.strict_sweep(
            mag.reshape(2, 3, 576), g0, inv, torch.tensor([True, False, True]),
            sample_rate=44100, count1_coding=True, region_table_select=False, linbits=True,
        )
    finally:
        profiling.disable()
    assert kernels.LAUNCHES["strict_sweep"] == 1
    assert profiling.snapshot()["counters"] == {"sweep.strict_launches": 1}
    profiling.reset()
    (args,) = calls
    assert args[3] is None and args[4] is None  # b0_switch, part2
    assert args[9:] == (6, 1, 0, 1)  # granules, count1_coding, region_table_select, linbits


@pytest.mark.parametrize(
    "preset,sweeps", [("compat", 0), ("strict", 1), ("hq_joint", 1), ("lsf_strict", 1),
                      ("strict_is_32k", 1), ("hq_dc3p_mono128", 4)],
)
def test_chunk_program_prices_each_strict_pass_in_one_sweep_call(monkeypatch, preset, sweeps):
    """make_chunk_fn calls kernels.strict_sweep once for each strict sweep
    of a chunk (1, or 1 + dc_passes under distortion control) and not at
    all on the compat path, which K1 prices."""
    from swiftmp3_tpu_torch.models import pipeline

    from .torch_inputs import preset_options

    calls = []
    sweep = kernels.strict_sweep
    monkeypatch.setattr(kernels, "strict_sweep", lambda *a, **k: calls.append(1) or sweep(*a, **k))
    o = preset_options(preset)
    B, T = 2, 2
    rng = np.random.default_rng(6)
    pcm = torch.from_numpy(
        (rng.standard_normal((B, T, o.samples_per_frame * o.channels)) * 3000).astype(np.int16)
    )
    la = torch.zeros((B, T, 576 * o.channels), dtype=torch.int16)
    pipeline.make_chunk_fn(o)(
        pipeline.init_carry(B, o, torch.device("cpu")), pcm,
        torch.zeros((B, T), dtype=torch.bool), torch.ones((B, T), dtype=torch.bool), la,
    )
    assert len(calls) == sweeps

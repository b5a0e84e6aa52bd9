"""Card-only tests of the port: the hand-written CUDA kernels against their
plain PyTorch versions (K2 also at the strict and hq paths' shapes, on the
pack input of every hq configuration, the hq flags' included, with frames
past the cap, against the host packer on strict frames, and at the edges of
its launch plan), the port's
entry points on a CUDA device against the same entry points on the CPU,
compat, spec_strict and hq, and the serving pool and reset_lanes on the card
against sessions on the card; K1, K2 and K3 on the LSF and free-format
paths' inputs and odd LSF chunks, and LSF rows on the card with the CPU
filterbank and MDCT against the JAX bytes; K1 and K2 on a card other than
the current one (skips below two cards); the graft entry's step on the card
(`graft_entry.entry()`) against the CPU's, and its dry run; K4's two scans
over T against their plain versions in every configuration the chunk
program runs them in, and the chunk program launching each once a chunk;
K5, the strict sweep, against its plain version over the option grid, on
FMA knife edges and on the chunk program's own inputs, launched once a
sweep, and an hq and an LSF batch priced by it giving the CPU's bytes.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports nothing of JAX and nothing of the JAX package, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from swiftmp3_tpu_torch.encoder import new_session
from swiftmp3_tpu_torch.io.huffman_pack import pack_chunks
from swiftmp3_tpu_torch.ops import dsp, kernels
from swiftmp3_tpu_torch.options import MP3EncoderOptions
from swiftmp3_tpu_torch.parallel.batch import encode_batch

from .torch_inputs import (
    COMPAT_FIXTURES,
    SCAN_OPTIONS,
    DC_IS_OPTIONS,
    HQ_FLAG_OPTIONS,
    HQ_OPTIONS,
    STRICT_FIXTURES,
    STRICT_OPTIONS,
    dc_is_options,
    dc_is_streams,
    energy_knife_edge_scan_input,
    fixture_path,
    hq_pack_input,
    knife_edge_sweep_input,
    make_signal,
    pack_input,
    scan_input,
    scan_options,
    strict_pack_input,
    strict_sweep_input,
    sweep_input,
)

pytestmark = pytest.mark.cuda

# from the sixth: the strict and the hq paths' slots a frame and caps, stereo
# and mono (hq mono 128 kbps also distortion control's); then the hq flags'
# (96 kbps joint stereo and mono, demand VBR's band up to 172 kbps), and
# intensity stereo's (hq joint stereo 32 kbps)
PACK_SHAPES = [
    (16, 1152, 894), (5, 576, 894), (8, 1812, 1536), (3, 1152, 2160), (2048, 1152, 894),
    (2048, 1872, 894), (2048, 936, 910), (2048, 4176, 894), (2048, 2088, 910),
    (2048, 4176, 790), (2048, 2088, 806), (2048, 2088, 1014), (2048, 4176, 582),
    # the LSF and free-format paths' slots and caps
    (2048, 576, 444), (2048, 936, 444), (2048, 1044, 460), (2048, 2088, 982),
    # the dry run's compat joint-stereo VBR step (quality 3), a bulk
    # position's frames (chip_smoke.py [K2 entry])
    (8192, 1152, 1104),
]
# K2's edges (kernels.pack_plan: a grid of at most 264 blocks of 8 warps at
# cap 894, a warp a frame at a time; tiles of K2_TILE = 512 slots staged by
# bulk copies where 16-byte aligned): one frame; more than three times the
# grid's 2112 frames at once; one slot a frame; P = 4k + 2 (every other row,
# and each row's last tile, not 16-byte aligned); an odd P; the most slots
# chip_smoke.py packs a frame (16 x 4176); cap 1 and cap 16384; all-zero
# nbits; frames past the cap; and inputs whose base is not 16-byte aligned
# (every tile by ordinary loads)
PACK_EDGE_CASES = [
    (1, 1152, 894, "under"), (12673, 1152, 894, "under"), (64, 1, 894, "under"),
    (64, 1158, 894, "under"), (64, 577, 300, "over"), (3, 66816, 16384, "under"),
    (3, 66816, 894, "over"), (64, 1152, 1, "over"), (64, 1152, 16384, "under"),
    (64, 1152, 894, "zero"), (64, 1152, 894, "offset"),
]
# frames whose bytes may differ between the card and the CPU: a float ULP in
# the matmul or reduction order can move a quantization knife edge
STRICT_CARD_FLIP_CEILING = 2
# the hq law's knife edges are finer (peaks quantize near 2048) and a flipped
# short want moves a window sequence: the telemetry rate, 24 of 78 frames
HQ_CARD_FLIP_RATE = (24, 78)
# (rows, T): the session chunk, 36T below one 256-position tile, a batch
# chunk, two shapes with a ragged last tile (180 positions; 1044 = 4 tiles +
# 20), and one whose blocks walk 2 tiles and 1 ragged tile (540 positions);
# the JAX package's K3 tolerance (tests/test_pallas.py)
POLYPHASE_SHAPES = [(2, 8), (6, 3), (64, 32), (5, 5), (2, 29), (1024, 15)]
K3_TOLERANCE = 2e-5
# K4: one stream, a ragged last block of warps, the corpus batch; one frame,
# the serving pool's chunk, the corpus chunk
SCAN_SHAPES = [(B, T) for B in (1, 7, 256) for T in (1, 32, 128)]
SCAN_OUTPUTS = ("br_idx", "padding", "mdb", "slot", "k_sel", "has_fit", "bits_sel")


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


@pytest.mark.parametrize("iso", [False, True])
def test_rate_sweep_kernel_matches_plain_on_extreme_magnitudes(cuda_device, iso):
    """Zeros, subnormals and magnitudes whose product overflows: the
    quantizer's clamp and its floor without a conversion hold at the ends of
    the float range, at every start gain."""
    rng = np.random.default_rng(11)
    values = np.array([0, 1e-45, 1e-40, 1e-38, 1e-10, 0.3, 7.0, 1e30, 3e38], np.float32)
    mag = rng.choice(values, (256, 576))
    mag[:9] = values[:, None]
    m = torch.from_numpy(mag).to(cuda_device)
    g = torch.arange(256, dtype=torch.int32, device=cuda_device)
    bits, bv = kernels.rate_sweep(m, g, iso=iso)
    pb, pv = kernels.rate_sweep_plain(m, g, iso)
    assert torch.equal(bits, pb) and torch.equal(bv, pv)
    assert int(bv[7].min()) == 288 and int(bv[0].max()) == 0


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


@pytest.mark.parametrize("F,P,cap,kind", PACK_EDGE_CASES)
def test_pack_kernel_matches_plain_at_the_edges(cuda_device, F, P, cap, kind):
    ch, nb = pack_input(F, P, cap, overflow=kind == "over")
    if kind == "zero":
        nb[:] = 0
    c = torch.from_numpy(ch).to(cuda_device)
    n = torch.from_numpy(nb).to(cuda_device)
    if kind == "offset":  # contiguous views 4 bytes past a 16-byte boundary
        c = torch.cat([c.new_zeros(1), c.reshape(-1)])[1:].view(F, P)
        n = torch.cat([n.new_zeros(1), n.reshape(-1)])[1:].view(F, P)
        assert c.data_ptr() % 16 == 4 and n.data_ptr() % 16 == 4
    before = kernels.LAUNCHES["pack"]
    by, tot = kernels.pack(c, n, cap)
    assert kernels.LAUNCHES["pack"] == before + 1
    pby, ptot = kernels.pack_plain(c, n, cap)
    assert torch.equal(by, pby) and torch.equal(tot, ptot)
    if kind == "over":
        assert int(tot.min()) > 8 * cap
    if kind == "zero":
        assert int(tot.abs().max()) == 0 and int(by.max()) == 0


def test_pack_kernel_truncates_at_cap(cuda_device):
    ch, nb = pack_input(64, 1152, 894, overflow=True)
    c = torch.from_numpy(ch).to(cuda_device)
    n = torch.from_numpy(nb).to(cuda_device)
    by, tot = kernels.pack(c, n, 894)
    pby, ptot = kernels.pack_plain(c, n, 894)
    assert int(tot.min()) > 894 * 8
    assert torch.equal(by, pby) and torch.equal(tot, ptot)


@pytest.mark.parametrize("rows,T", POLYPHASE_SHAPES)
def test_polyphase_kernel_matches_plain(cuda_device, rows, T):
    rng = np.random.default_rng(rows * 100 + T)
    hist = torch.from_numpy((rng.standard_normal((rows, 480)) * 0.2).astype(np.float32))
    pcm = torch.from_numpy((rng.standard_normal((rows, T * 1152)) * 0.5).astype(np.float32))
    hist, pcm = hist.to(cuda_device), pcm.to(cuda_device)
    before = kernels.LAUNCHES["polyphase"]
    S, x = kernels.polyphase_chunk(hist, pcm)
    assert kernels.LAUNCHES["polyphase"] == before + 1
    S_p, x_p = kernels.polyphase_chunk_plain(hist, pcm)
    assert kernels.polyphase_plan(rows, T * 1152)["tiles_per_block"] == (2 if rows == 1024 else 1)
    assert S.shape == S_p.shape == (rows, 36 * T, 32)
    assert float((S - S_p).abs().max()) <= K3_TOLERANCE
    assert torch.equal(x, x_p)
    S_m, _ = dsp.polyphase_chunk_matmul(hist, pcm)
    assert float((S - S_m).abs().max()) <= K3_TOLERANCE


@pytest.mark.parametrize("mode", ["joint_stereo", "mono"])
def test_pack_kernel_matches_the_host_packer_on_strict_frames(cuda_device, mode):
    chunks, nbits, cap = strict_pack_input(cuda_device, B=8, T=4, mode=mode)
    assert chunks.shape[1] == (1872 if mode == "joint_stereo" else 936)
    by, total = kernels.pack(chunks, nbits, cap)
    pby, ptot = kernels.pack_plain(chunks, nbits, cap)
    assert torch.equal(by, pby) and torch.equal(total, ptot)
    c, n, by = chunks.cpu().numpy(), nbits.cpu().numpy(), by.cpu().numpy()
    assert (n[:, :36] > 0).any()
    for f in range(c.shape[0]):
        live = n[f] > 0
        host, bits = pack_chunks(c[f][live].astype(np.int64), n[f][live].astype(np.int64))
        assert int(total[f]) == bits and by[f, : len(host)].tobytes() == host


def _flips(got: bytes, ref: bytes) -> int:
    from .util import parse_frames

    fg, fr = parse_frames(got), parse_frames(ref)
    assert [f.size for f in fg] == [f.size for f in fr]
    return sum(
        got[a.offset : a.offset + a.size] != ref[b.offset : b.offset + b.size]
        for a, b in zip(fg, fr)
    )


@pytest.mark.parametrize("row", STRICT_FIXTURES, ids=[f[0] for f in STRICT_FIXTURES])
def test_strict_session_on_the_card_matches_the_cpu(cuda_device, row):
    name, kw, kind, seconds, seed = row
    o = MP3EncoderOptions(**kw)
    pcm = make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    s = new_session(o)
    got = s.encode(pcm) + s.flush()
    s = new_session(o, "cpu")
    assert _flips(got, s.encode(pcm) + s.flush()) <= STRICT_CARD_FLIP_CEILING


def test_strict_batch_on_the_card_matches_cpu_sessions(cuda_device):
    o = MP3EncoderOptions.spec_strict(**STRICT_OPTIONS)
    base = make_signal("burst", 0.5, 44100, 2, 32)
    streams = [base, base[: 2 * 1152 * 9 + 10], base[::-1].copy()]
    got = encode_batch(o, streams, frames_per_step=8)
    for pcm, data in zip(streams, got):
        s = new_session(o, "cpu")
        assert _flips(data, s.encode(pcm) + s.flush()) <= STRICT_CARD_FLIP_CEILING


def test_session_on_the_card_matches_the_fixture(cuda_device):
    name, kw, kind, seconds, seed = next(
        f for f in COMPAT_FIXTURES if f[0] == "joint_cbr192_48k_mix"
    )
    o = MP3EncoderOptions(**kw)
    pcm = make_signal(kind, seconds, o.sample_rate, o.channels, seed)
    s = new_session(o)
    with open(fixture_path(name, "tpu"), "rb") as fh:
        assert s.encode(pcm) + s.flush() == fh.read()


def test_batch_on_the_card_matches_cpu_sessions(cuda_device):
    o = MP3EncoderOptions(mode="stereo", reservoir_mode="aligned")
    base = make_signal("mix", 0.5, 44100, 2, 31)
    streams = [base, base[: 2 * 1152 * 9 + 10], base[::-1].copy()]
    got = encode_batch(o, streams, frames_per_step=8)
    for pcm, data in zip(streams, got):
        s = new_session(o, "cpu")
        assert data == s.encode(pcm) + s.flush()


@pytest.mark.parametrize("mode", ["joint_stereo", "mono"])
def test_pack_kernel_matches_plain_on_the_hq_path(cuda_device, mode):
    """K2 on the pack input the hq chunk program gives it (P = 4176 in
    stereo, 2088 in mono), and on the same slots twice over, so that every
    frame runs past the cap and is truncated there."""
    chunks, nbits, cap = hq_pack_input(cuda_device, B=4, T=4, mode=mode)
    assert chunks.shape[1] == (4176 if mode == "joint_stereo" else 2088)
    for c, n in ((chunks, nbits), (torch.cat([chunks] * 3, 1), torch.cat([nbits] * 3, 1))):
        c, n = c.contiguous(), n.contiguous()
        by, tot = kernels.pack(c, n, cap)
        pby, ptot = kernels.pack_plain(c, n, cap)
        assert torch.equal(by, pby) and torch.equal(tot, ptot)
    assert (ptot > 8 * cap).any()


def test_hq_step_on_the_card_matches_the_cpu(cuda_device):
    """One BatchEncoder step of the hq preset (joint stereo) on the card,
    rendered, against the same step on the CPU: the same frame structure,
    bytes within the hq flip rate."""
    from swiftmp3_tpu_torch.parallel.batch import BatchEncoder

    from .torch_inputs import bench_audio, step_lookahead

    o = MP3EncoderOptions.hq(**HQ_OPTIONS["hq_joint"])
    B, T = 4, 16
    audio = [bench_audio(np.random.default_rng(3), B, T, 2, 44100) for _ in range(2)]
    final = np.zeros((B, T), bool)
    valid = np.ones((B, T), bool)
    got = {}
    for dev in ("cuda", "cpu"):
        enc = BatchEncoder(o, B, T, dev)
        outs = enc.step(audio[0], final, valid, step_lookahead(audio, 0, 2))
        streams = enc.drain(outs, valid)
        got[dev] = [a + b for a, b in zip(streams, enc.flush())]
        enc.close()
    num, den = HQ_CARD_FLIP_RATE
    for card, cpu in zip(got["cuda"], got["cpu"]):
        assert _flips(card, cpu) <= num * T // den


@pytest.mark.parametrize("preset", list(HQ_FLAG_OPTIONS))
def test_pack_kernel_matches_plain_on_the_hq_flag_paths(cuda_device, preset):
    """K2 on the pack input of each hq flag configuration (its own P and
    cap), and on the same slots three times over, past the cap."""
    chunks, nbits, cap = hq_pack_input(cuda_device, B=4, T=4, preset=preset)
    for c, n in ((chunks, nbits), (torch.cat([chunks] * 3, 1), torch.cat([nbits] * 3, 1))):
        c, n = c.contiguous(), n.contiguous()
        by, tot = kernels.pack(c, n, cap)
        pby, ptot = kernels.pack_plain(c, n, cap)
        assert torch.equal(by, pby) and torch.equal(tot, ptot)
    assert (ptot > 8 * cap).any()


def _pool_streams(channels: int) -> list:
    rng = np.random.default_rng(11)
    lengths = [3 * 1152 + 400, 2 * 1152, 5 * 1152 + 1, 576, 4 * 1152, 0, 3 * 1152 + 7]
    streams = []
    for i, n in enumerate(lengths):
        pcm = make_signal("burst" if i % 2 else "mix", max(n, 1) / 44100, 44100, channels, 50 + i)
        streams.append(pcm[: n * channels])
    streams[3] = (streams[3] * 32767).astype(np.int16)  # an int16 stream among float ones
    return streams


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("hq", [False, True], ids=["compat", "hq"])
def test_pool_on_the_card_matches_card_sessions(cuda_device, hq, pipelined):
    """The pool on the card, 2 lanes for 7 streams (lanes recycled, one
    stream drip-fed, one closed empty), byte for byte the card sessions'."""
    from swiftmp3_tpu_torch.parallel import StreamPool

    o = MP3EncoderOptions.hq(mode="mono", bitrate_kbps=128) if hq else MP3EncoderOptions(
        mode="stereo"
    )
    streams = _pool_streams(o.channels)
    pool = StreamPool(o, lanes=2, frames_per_step=3, pipelined=pipelined)
    sids = []
    for i, pcm in enumerate(streams):
        sid = pool.submit()
        if i == 0:
            for k in range(0, len(pcm), 1000):
                pool.feed(sid, pcm[k : k + 1000])
                pool.step()
        else:
            pool.feed(sid, pcm)
        pool.close(sid)
        sids.append(sid)
    pool.run_until_idle()
    for sid, pcm in zip(sids, streams):
        s = new_session(o)
        assert pool.result(sid) == s.encode(pcm) + s.flush()
        assert pool.xing_header(sid) == s.generate_xing_header()
    pool.shutdown()


def _bits(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


def test_reset_lanes_on_the_card(cuda_device):
    """reset_lanes on CUDA tensors: unmasked lanes bit for bit, masked lanes
    init_carry's state (+inf block energies included)."""
    from swiftmp3_tpu_torch.models.pipeline import init_carry
    from swiftmp3_tpu_torch.parallel.batch import BatchEncoder

    from .torch_inputs import bench_audio, step_lookahead

    o = MP3EncoderOptions.hq(**HQ_FLAG_OPTIONS["hq_joint_96k"])
    B, T = 4, 4
    audio = [bench_audio(np.random.default_rng(5), B, T, 2, 44100) for _ in range(2)]
    enc = BatchEncoder(o, B, T)
    valid = np.ones((B, T), bool)
    enc.drain(enc.step(audio[0], np.zeros((B, T), bool), valid, step_lookahead(audio, 0, 2)), valid)
    before = {k: v.clone() for k, v in enc.carry.items()}
    mask = np.array([True, False, False, True])
    enc.reset_lanes(mask)
    init = init_carry(B, o, cuda_device)
    for k, v in enc.carry.items():
        assert v.is_cuda and _bits(v[1:3]) == _bits(before[k][1:3]), k
        assert _bits(v[[0, 3]]) == _bits(init[k][[0, 3]]), k
    assert torch.isinf(enc.carry["onset_prev2"][0]).all()
    enc.close()


@pytest.mark.parametrize("preset", ["hq_mono_96k", "hq_vbr_demand_q5"])
def test_mono_hq_on_the_card_with_the_cpu_filterbank_matches_the_jax_bytes(
    cuda_device, preset, monkeypatch
):
    """On the card the mono hq rows keep the JAX backend's frame structure,
    but the card's filterbank and MDCT sum in another order, which moves
    linbits knife edges (whole streams of tonal content). With the port's
    CPU filterbank and MDCT in their place, and every other op on the card,
    the bytes are the JAX backend's exactly."""
    from .torch_inputs import hq_flag_streams, jax_path

    o = MP3EncoderOptions.hq(**HQ_FLAG_OPTIONS[preset])
    pm, md = dsp.polyphase_chunk_matmul, dsp.mdct_chunk
    for stem in ("corpus_tonal", "corpus_panned"):
        pcm = hq_flag_streams(preset)[stem]
        with open(jax_path(f"{preset}_{stem}"), "rb") as fh:
            ref = fh.read()
        s = new_session(o)
        _flips(s.encode(pcm) + s.flush(), ref)  # the structure
        monkeypatch.setattr(
            dsp, "polyphase_chunk_matmul",
            lambda h, p: tuple(x.to(h.device) for x in pm(h.cpu(), p.cpu())),
        )
        monkeypatch.setattr(
            dsp, "mdct_chunk",
            lambda S, ov, bt, *a, **k: tuple(
                x.to(S.device) for x in md(S.cpu(), ov.cpu(), bt.cpu(), *a, **k)
            ),
        )
        s = new_session(o)
        assert s.encode(pcm) + s.flush() == ref
        monkeypatch.undo()


@pytest.mark.parametrize("preset", list(DC_IS_OPTIONS))
def test_pack_kernel_matches_plain_on_the_dc_is_paths(cuda_device, preset):
    """K2 on the pack input of distortion control and intensity stereo
    (their own P and cap), and on the same slots eight times over, past the
    cap (a 32 kbps frame holds few bits)."""
    chunks, nbits, cap = hq_pack_input(cuda_device, B=4, T=4, preset=preset)
    for c, n in ((chunks, nbits), (torch.cat([chunks] * 8, 1), torch.cat([nbits] * 8, 1))):
        c, n = c.contiguous(), n.contiguous()
        by, tot = kernels.pack(c, n, cap)
        pby, ptot = kernels.pack_plain(c, n, cap)
        assert torch.equal(by, pby) and torch.equal(tot, ptot)
    assert (ptot > 8 * cap).any()


@pytest.mark.parametrize("preset", list(DC_IS_OPTIONS))
def test_dc_is_on_the_card_with_the_cpu_filterbank_matches_the_jax_bytes(
    cuda_device, preset, monkeypatch
):
    """Each distortion-control and intensity configuration on the card keeps
    the JAX backend's frame structure on its own filterbank and MDCT, and
    with the port's CPU filterbank and MDCT in their place (every other op
    on the card) gives the JAX backend's bytes exactly."""
    from .torch_inputs import jax_path

    o = dc_is_options(preset, MP3EncoderOptions)
    stem, pcm = next(iter(dc_is_streams(preset).items()))
    with open(jax_path(f"{preset}_{stem}"), "rb") as fh:
        ref = fh.read()
    s = new_session(o)
    _flips(s.encode(pcm) + s.flush(), ref)  # the structure
    pm, md = dsp.polyphase_chunk_matmul, dsp.mdct_chunk
    monkeypatch.setattr(
        dsp, "polyphase_chunk_matmul",
        lambda h, p: tuple(x.to(h.device) for x in pm(h.cpu(), p.cpu())),
    )
    monkeypatch.setattr(
        dsp, "mdct_chunk",
        lambda S, ov, bt, *a, **k: tuple(
            x.to(S.device) for x in md(S.cpu(), ov.cpu(), bt.cpu(), *a, **k)
        ),
    )
    s = new_session(o)
    assert s.encode(pcm) + s.flush() == ref


@pytest.mark.parametrize("path", ["lsf strict", "lsf hq", "lsf iso", "free format"])
def test_kernels_match_plain_on_the_lsf_paths(cuda_device, path):
    """K2 on the pack input of each LSF and free-format path (P = 936, 1044,
    576, 2088; caps 444, 460, 444, 982) and on its slots enough times over
    to pass the cap; K1 on the lsf iso path's sweep input (ISO law)."""
    from .torch_inputs import path_kernel_inputs

    inputs = path_kernel_inputs(cuda_device, path, B=4, T=5)
    chunks, nbits, cap = inputs["pack"]
    reps = max(3, 8 * cap // int(nbits.sum(dim=1).max()) + 1)
    for c, n in ((chunks, nbits), (torch.cat([chunks] * reps, 1), torch.cat([nbits] * reps, 1))):
        c, n = c.contiguous(), n.contiguous()
        by, tot = kernels.pack(c, n, cap)
        pby, ptot = kernels.pack_plain(c, n, cap)
        assert torch.equal(by, pby) and torch.equal(tot, ptot)
    assert (ptot > 8 * cap).any()
    assert ("rate_sweep" in inputs) == (path == "lsf iso")
    if path == "lsf iso":
        mag, gstart, iso = inputs["rate_sweep"]
        mag, gstart = mag.reshape(-1, 576).contiguous(), gstart.reshape(-1).contiguous()
        assert iso and gstart.numel() == 4 * 5 * 2
        bits, bv = kernels.rate_sweep(mag, gstart, iso=True)
        pb, pv = kernels.rate_sweep_plain(mag, gstart, True)
        assert torch.equal(bits, pb) and torch.equal(bv, pv)


@pytest.mark.parametrize("T", [1, 3, 127])
def test_polyphase_kernel_matches_plain_at_odd_lsf_chunks(cuda_device, T):
    """K3 on T frames of 576 samples (18T windows, not a multiple of 4 at
    odd T) against its plain version and the folded matmul."""
    rng = np.random.default_rng(T)
    hist = torch.from_numpy((rng.standard_normal((4, 2, 480)) * 0.2).astype(np.float32)).to(cuda_device)
    pcm = torch.from_numpy((rng.standard_normal((4, 2, T * 576)) * 0.5).astype(np.float32)).to(cuda_device)
    S, x = kernels.polyphase_chunk(hist, pcm)
    S_p, x_p = kernels.polyphase_chunk_plain(hist, pcm)
    S_m, _ = dsp.polyphase_chunk_matmul(hist, pcm)
    assert S.shape == (4, 2, 18 * T, 32) and torch.equal(x, x_p)
    assert float((S - S_p).abs().max()) <= K3_TOLERANCE
    assert float((S - S_m).abs().max()) <= K3_TOLERANCE


@pytest.mark.parametrize("row", ["lsf_strict_mono48_8k_mixed", "lsf_hq_mono48_16k_content",
                                 "lsf_strict_noshort_joint48_22k_mixed",
                                 "ff_strict_mono150_44k_noise"])
def test_lsf_on_the_card_with_the_cpu_filterbank_matches_the_jax_bytes(cuda_device, row, monkeypatch):
    """An LSF or free-format row on the card keeps the JAX backend's frame
    structure as a session, and as a batch of 7-frame steps (odd LSF
    chunks); with the port's CPU filterbank and MDCT in place of the card's
    (every other op on the card) they give the JAX backend's session bytes
    and the JAX package's batch bytes at 7 frames a step exactly."""
    from .torch_inputs import ODD_STEP, jax_path, lsf_row_options, lsf_row_pcm, walk_frames

    o = lsf_row_options(row, MP3EncoderOptions)
    pcm = lsf_row_pcm(row)
    free = o.bitrate_kbps if o.free_format else None
    refs = []
    for stem in (row, f"{row}_step{ODD_STEP}"):
        with open(jax_path(stem), "rb") as fh:
            refs.append(fh.read())

    def both():
        s = new_session(o)
        return [s.encode(pcm) + s.flush(), encode_batch(o, [pcm], frames_per_step=ODD_STEP)[0]]

    for data, ref in zip(both(), refs):
        assert [f["size"] for f in walk_frames(data, free)] == [f["size"] for f in walk_frames(ref, free)]
    pm, md = dsp.polyphase_chunk_matmul, dsp.mdct_chunk
    monkeypatch.setattr(
        dsp, "polyphase_chunk_matmul",
        lambda h, p: tuple(x.to(h.device) for x in pm(h.cpu(), p.cpu())),
    )
    monkeypatch.setattr(
        dsp, "mdct_chunk",
        lambda S, ov, bt, *a, **k: tuple(
            x.to(S.device) for x in md(S.cpu(), ov.cpu(), bt.cpu(), *a, **k)
        ),
    )
    assert both() == refs


def test_kernels_launch_on_the_tensors_card(cuda_device):
    """K1 and K2 on the last card while the first is current (a mesh
    position's tensors away from the current device): each wrapper launches
    under its tensors' device, bit-exact against its plain version there."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards, this host has {n}")
    dev = torch.device("cuda", n - 1)
    torch.cuda.set_device(0)
    mag, g0 = sweep_input(4099)
    m, g = torch.from_numpy(mag).to(dev), torch.from_numpy(g0).to(dev)
    bits, bv = kernels.rate_sweep(m, g)
    pb, pv = kernels.rate_sweep_plain(m, g)
    ch, nb = pack_input(2048, 1152, 894)
    c, nbits = torch.from_numpy(ch).to(dev), torch.from_numpy(nb).to(dev)
    by, tot = kernels.pack(c, nbits, 894)
    pby, ptot = kernels.pack_plain(c, nbits, 894)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0 and bits.device == by.device == dev
    assert torch.equal(bits, pb) and torch.equal(bv, pv)
    assert torch.equal(by, pby) and torch.equal(tot, ptot)


def test_entry_on_the_card_launches_k1_and_k2_and_matches_the_cpu(cuda_device):
    """graft_entry.entry() on the card: one call launches K1 and K2 once
    each, and its fetched outputs equal entry("cpu")'s (flips within
    chip_smoke.py's ENTRY_FLIP_CEILING); the dry run over two positions on
    the card passes its own checks and launches K1 once and K2 twice a
    position."""
    from swiftmp3_tpu_torch.graft_entry import dryrun_multichip, entry
    from swiftmp3_tpu_torch.models.pipeline import fetch_outputs
    from swiftmp3_tpu_torch.options import Mode

    from chip_smoke import ENTRY_FLIP_CEILING
    from .torch_inputs import differing_frames

    o = MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128)
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in [*args[0].values(), *args[1:]])
    kernels.build_kernels()
    kernels.reset_launch_counts()
    _, outs = fn(*args)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["rate_sweep"], kernels.LAUNCHES["pack"]) == (1, 1)
    cpu_fn, cpu_args = entry("cpu")
    _, cpu_outs = cpu_fn(*cpu_args)
    assert differing_frames(fetch_outputs(outs, o), fetch_outputs(cpu_outs, o)) <= ENTRY_FLIP_CEILING
    kernels.reset_launch_counts()
    got = dryrun_multichip(2)
    assert (kernels.LAUNCHES["rate_sweep"], kernels.LAUNCHES["pack"]) == (2, 4)
    assert sorted(got) == ["hq", "vbr"] and got["vbr"][0]["main_data"].shape == (4, 2, 1104)


@pytest.mark.parametrize("B,T", SCAN_SHAPES)
@pytest.mark.parametrize("preset", list(SCAN_OPTIONS))
def test_scan_kernels_match_plain(cuda_device, preset, B, T):
    """K4's selection scan and its placement scan against their plain
    versions on the card, bit for bit, on every output and carry tensor: a
    carry that is not fresh, rows ending early with `final` on their last
    valid frame, rows with invalid frames mid-chunk; each call one launch."""
    seed = 100_003 * len(preset) + 1009 * B + T
    cfg, carry, ins, p_carry, hb = scan_input(scan_options(preset), B, T, seed, cuda_device)
    before = dict(kernels.LAUNCHES)
    new, outs = kernels.rate_loop_scan(cfg, carry, **ins)
    assert kernels.LAUNCHES["rate_loop_scan"] == before["rate_loop_scan"] + 1
    p_new, p_outs = kernels.rate_loop_scan_plain(cfg, carry, **ins)
    for name, got, want in zip(SCAN_OUTPUTS, outs, p_outs):
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert new.keys() == p_new.keys()
    for name in new:
        assert torch.equal(new[name], p_new[name]), name
    slot, final, valid = outs[3], ins["final"], ins["valid"]
    c2, mdb = kernels.placement_scan(cfg, p_carry, hb, slot, final, valid)
    assert kernels.LAUNCHES["placement_scan"] == before["placement_scan"] + 1
    p_c2, p_mdb = kernels.placement_scan_plain(cfg, p_carry, hb, slot, final, valid)
    assert torch.equal(mdb, p_mdb)
    assert all(torch.equal(c2[k], p_c2[k]) for k in ("stream_len", "slot_fifo"))


def test_energy_vbr_scan_matches_plain_where_the_sum_order_decides(cuda_device):
    """Rows whose first frame's bitrate index differs between torch.sum's
    order over the ten-entry energy history on the card and another order
    of the same shuffle tree: the plain version on the card gives the card
    order's index (tests/torch_inputs.card_sum_of_ten), and K4 gives the
    plain version's."""
    (cfg, carry, ins, _, _), want = energy_knife_edge_scan_input(256, 8, 17, cuda_device)
    _, outs = kernels.rate_loop_scan(cfg, carry, **ins)
    _, p_outs = kernels.rate_loop_scan_plain(cfg, carry, **ins)
    assert np.array_equal(p_outs[0][0].cpu().numpy(), want)
    assert all(torch.equal(a, b) for a, b in zip(outs, p_outs))


@pytest.mark.parametrize(
    "preset,scans", [("compat", (1, 0)), ("strict", (1, 1)), ("hq_joint", (1, 1))]
)
def test_chunk_program_on_the_card_launches_each_scan_once(cuda_device, preset, scans):
    from swiftmp3_tpu_torch.models import pipeline

    o = scan_options(preset)
    B, T = 3, 4
    rng = np.random.default_rng(9)
    pcm = torch.from_numpy(
        (rng.standard_normal((B, T, 1152 * o.channels)) * 3000).astype(np.int16)
    ).to(cuda_device)
    la = torch.zeros((B, T, 576 * o.channels), dtype=torch.int16, device=cuda_device)
    flags = torch.zeros((B, T), dtype=torch.bool, device=cuda_device)
    run = pipeline.make_chunk_fn(o)
    before = dict(kernels.LAUNCHES)
    run(pipeline.init_carry(B, o, cuda_device), pcm, flags, ~flags, la)
    torch.cuda.synchronize()
    assert (
        kernels.LAUNCHES["rate_loop_scan"] - before["rate_loop_scan"],
        kernels.LAUNCHES["placement_scan"] - before["placement_scan"],
    ) == scans


# K5's option grid: count1_coding x region_table_select x linbits x ISO law
STRICT_SWEEP_GRID = [
    (c1, select, linbits, iso)
    for c1 in (False, True) for select in (False, True)
    for linbits in (False, True) for iso in (False, True)
]


def _strict_sweep_pair(mag, g0, inv, is_long, b0, part2, **options):
    """K5 and its plain version on the same inputs, K5 launched once."""
    before = kernels.LAUNCHES["strict_sweep"]
    got = kernels.strict_sweep(mag, g0, inv, is_long, b0, part2, **options)
    assert kernels.LAUNCHES["strict_sweep"] == before + 1
    return got, kernels.strict_sweep_plain(mag, g0, inv, is_long, b0, part2, **options)


@pytest.mark.parametrize("sample_rate", [44100, 22050])
@pytest.mark.parametrize("count1_coding,region_table_select,linbits,iso", STRICT_SWEEP_GRID)
def test_strict_sweep_kernel_matches_plain(
    cuda_device, sample_rate, count1_coding, region_table_select, linbits, iso
):
    """K5 against its plain version on the card, bit for bit, over the
    option grid at 44.1 kHz and at 22.05 kHz with the switching region-0
    bounds: long and switching granules (short, START/STOP), an all-zero
    granule, gstart at 0 and 252-255, magnitudes past QCAP_LINBITS, with
    part2 and without, on flat granules and on the chunk program's
    [B, ch, T, gr] layout with is_long broadcast over the channels."""
    seed = 17 * sample_rate + 8 * count1_coding + 4 * region_table_select + 2 * linbits + iso
    mag, g0, is_long, b0, part2 = (
        torch.from_numpy(x).to(cuda_device)
        for x in strict_sweep_input(4104, seed, linbits, sample_rate)
    )
    if sample_rate > 24000:
        b0 = None
    inv = dsp.inv_step_table(iso, cuda_device, floor=not linbits)
    options = dict(sample_rate=sample_rate, count1_coding=count1_coding,
                   region_table_select=region_table_select, linbits=linbits)
    for p2 in (part2, None):
        got, want = _strict_sweep_pair(mag, g0, inv, is_long, b0, p2, **options)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    lead = (57, 2, 18, 2)  # [B, ch, T, gr]
    shaped = (mag.reshape(lead + (576,)), g0.reshape(lead), is_long.reshape(lead)[:, :1],
              None if b0 is None else b0.reshape(lead), part2.reshape(lead))
    got, want = _strict_sweep_pair(*shaped[:2], inv, *shaped[2:], **options)
    assert got.shape == lead + (20,) and torch.equal(got, want)


@pytest.mark.parametrize("iso,linbits", [(False, False), (True, False), (True, True)])
def test_strict_sweep_kernel_matches_plain_on_fma_knife_edges(cuda_device, iso, linbits):
    """Granules whose magnitudes meet the grid gains' FMA knife edges
    (tests/torch_inputs.knife_edge_sweep_input), and granules of
    magnitudes (n + 0.5) / inv and their float neighbours for n up to past
    the law's cap: K5 quantizes as the plain version does (the product and
    the sum rounded apart), under each entropy coding."""
    inv = dsp.inv_step_table(iso, cuda_device, floor=not linbits)
    table = inv.cpu().numpy()
    mag, g0 = knife_edge_sweep_input(table)
    rng = np.random.default_rng(23 + 2 * iso + linbits)
    gains = rng.integers(0, 256, 256).astype(np.int32)
    k = rng.integers(0, 20, (256, 576))
    n = rng.integers(0, 8300 if linbits else 17, (256, 576))
    g = np.minimum(gains[:, None] + 4 * k, 255)  # a grid gain of each line's granule
    half = ((n + 0.5) / table[g].astype(np.float64)).astype(np.float32)
    for _ in range(2):
        step = rng.integers(-1, 2, half.shape)
        half = np.where(step < 0, np.nextafter(half, np.float32(0)),
                        np.where(step > 0, np.nextafter(half, np.float32(np.inf)), half))
    mag = np.concatenate([mag, half.astype(np.float32)])
    g0 = np.concatenate([g0, gains])
    m, g = torch.from_numpy(mag).to(cuda_device), torch.from_numpy(g0).to(cuda_device)
    is_long = torch.arange(len(g0), device=cuda_device) % 3 != 0
    for c1, select in ((True, True), (False, False)):
        got, want = _strict_sweep_pair(
            m, g, inv, is_long, None, None, sample_rate=44100, count1_coding=c1,
            region_table_select=select, linbits=linbits,
        )
        assert torch.equal(got, want)


@pytest.mark.parametrize(
    "preset", ["strict", "hq_joint", "lsf strict", "lsf hq", "hq_dc3p_mono128", "strict_is_32k"]
)
def test_strict_sweep_kernel_matches_plain_on_the_chunk_programs_inputs(cuda_device, preset):
    """K5 on the first sweep input the chunk program hands it on the
    card (spec_strict, hq joint stereo with window sequencing, the two LSF
    strict paths, distortion control at three passes, intensity stereo),
    against its plain version there."""
    from .torch_inputs import (
        LSF_PATHS,
        bench_audio,
        chunk_kernel_inputs,
        panned_audio,
        path_kernel_inputs,
        preset_options,
        step_lookahead,
    )

    if preset in LSF_PATHS:
        inputs = path_kernel_inputs(cuda_device, preset, B=8, T=8)
    else:
        o = preset_options(preset)
        rng = np.random.default_rng(4)
        if o.intensity_stereo:
            audio = [panned_audio(rng, 8, 8, o.sample_rate) for _ in range(2)]
        else:
            audio = [bench_audio(rng, 8, 8, o.channels, o.sample_rate, o.samples_per_frame)
                     for _ in range(2)]
        la = step_lookahead(audio, 0, o.channels) if o.window_sequencing else None
        inputs = chunk_kernel_inputs(o, cuda_device, audio[0], la)
    args, options = inputs["strict_sweep"]
    got, want = _strict_sweep_pair(*args, **options)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "preset,sweeps", [("compat", 0), ("strict", 1), ("hq_joint", 1), ("lsf_strict", 1),
                      ("hq_dc3p_mono128", 4)],
)
def test_chunk_program_on_the_card_launches_k5_once_a_sweep(cuda_device, preset, sweeps):
    """LAUNCHES["strict_sweep"] counts one launch a strict sweep of a chunk
    (1 + dc_passes under distortion control) and none on the compat path."""
    from swiftmp3_tpu_torch.models import pipeline

    from .torch_inputs import preset_options

    o = preset_options(preset)
    B, T = 3, 4
    rng = np.random.default_rng(9)
    pcm = torch.from_numpy(
        (rng.standard_normal((B, T, o.samples_per_frame * o.channels)) * 3000).astype(np.int16)
    ).to(cuda_device)
    la = torch.zeros((B, T, 576 * o.channels), dtype=torch.int16, device=cuda_device)
    flags = torch.zeros((B, T), dtype=torch.bool, device=cuda_device)
    before = kernels.LAUNCHES["strict_sweep"]
    pipeline.make_chunk_fn(o)(pipeline.init_carry(B, o, cuda_device), pcm, flags, ~flags, la)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["strict_sweep"] - before == sweeps


@pytest.mark.parametrize("preset", ["hq_joint", "lsf_strict"])
def test_strict_batch_on_the_card_with_the_cpu_filterbank_matches_the_cpu(
    cuda_device, preset, monkeypatch
):
    """An hq batch (joint stereo 128 kbps, window sequencing, linbits) and
    an LSF batch (spec_strict joint stereo 64 kbps at 22.05 kHz), priced by
    K5 on the card, with the port's CPU filterbank and MDCT in place of the
    card's (every other op on the card), give the CPU batch's bytes."""
    o = scan_options(preset)
    spf = o.samples_per_frame
    base = make_signal("burst", 0.6, o.sample_rate, 2, 37)
    streams = [base, base[: 2 * spf * 9 + 10].copy(), base[::-1].copy()]
    want = encode_batch(o, streams, device="cpu", frames_per_step=8)
    pm, md = dsp.polyphase_chunk_matmul, dsp.mdct_chunk
    monkeypatch.setattr(
        dsp, "polyphase_chunk_matmul",
        lambda h, p: tuple(x.to(h.device) for x in pm(h.cpu(), p.cpu())),
    )
    monkeypatch.setattr(
        dsp, "mdct_chunk",
        lambda S, ov, bt, *a, **k: tuple(
            x.to(S.device) for x in md(S.cpu(), ov.cpu(), bt.cpu(), *a, **k)
        ),
    )
    before = kernels.LAUNCHES["strict_sweep"]
    got = encode_batch(o, streams, device=cuda_device, frames_per_step=8)
    assert kernels.LAUNCHES["strict_sweep"] > before
    assert got == want

"""The chunk program in PyTorch: chunk-parallel DSP + integer scans over T.
Twin of `swiftmp3_tpu.models.pipeline.make_chunk_fn` for the compat preset,
the spec_strict preset and the hq preset with its flags (the static and
adaptive lowpass, demand VBR, reservoir depth 1-8, distortion control,
intensity stereo), at MPEG-1 rates and at the LSF rates of MPEG-2 and 2.5
(8-24 kHz: one granule a frame, 72 slots a kbps, 9/17-byte side info, the
255-byte reservoir reach, the 9-bit scalefac_compress, the band-derived
region-0 boundary of switching granules), and in free format (header index
0, the exact rate sizing the frame).

Per chunk of T frames x B streams:

  Phase 1 (parallel): ingest, stereo decision (with the ISO M/S laws),
    polyphase filterbank, transient detection (blocks shared across M/S
    channels under shared_ms_blocks) or, under window_sequencing, the ISO
    window sequence from the raw PCM and each frame's lookahead granule,
    MDCT, then either the compat initial gains and table-15 rate sweep
    (kernel K1), or the strict path: real scalefactors, scfsi, and the
    strict-entropy sweep pricing all 20 gains exactly (plain PyTorch, as
    the reference computes it outside any Pallas kernel), with the linbits
    ESC tables under linbits_tables. The subband lowpass masks the MDCT
    output (per granule under adaptive_lowpass). Under intensity_stereo,
    gated frames (no mixed granule on the raw L/R) code raw L/R, and those
    with a qualifying region emit intensity: the left spectrum carries L + R
    on the region's lines, the right zero, and the right channel's
    scalefactor slots are priced to hold the marker 7. Under
    distortion_control, each of dc_passes passes quantizes a probe at the
    static equal share, bumps the scalefactors of violating bands in
    all-LONG frames and sweeps again; the demand probes keep the first
    sweep.
  Phase 2 (a scan over T, integers only; kernel K4): bitrate (the energy
    law, or under vbr_demand the smallest rate whose slot covers the
    frame's priced demand), padding, reservoir budget (split by the demand-donation law
    under demand_budget), candidate selection and the reservoir mirror
    (main_data_begin front-aligned at depth > 1). Invalid frames freeze the
    carry.
    The strict path runs this scan on its priced stream-length mirror
    (`est_stream_len`).
  Phase 3 (parallel): re-quantize at the selected gains; compat: regions,
    preflag, table-15 chunks; strict: the entropy layout, a second integer
    scan over T on the actual bits (the real `stream_len` and
    main_data_begin), scalefactor and pair/quad chunks; intensity's
    knife-edge zeroing before the layout and its position slots after it.
    Then the main_data pack (kernel K2) and the packed output
    (mode_extension 0b01 on intensity frames).

The carry and the packed output have the JAX program's names, shapes, dtypes
and byte layout, so `fetch_outputs` reads both and checkpoints cross between
the two backends (`carry_from_jax`, `carry_to_jax`). `valid[b, t]` must be a
prefix in t per stream; the carry-out is taken at each stream's last valid
frame.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..io.framing import FrameResult
from ..io.sideinfo import GranuleInfo
from ..ops import dsp, kernels
from ..options import SAMPLES_PER_GRANULE, MP3EncoderOptions, Mode
from ..tables import (
    BITRATE_TABLE_V1,
    BITRATE_TABLE_V2,
    QCAP_LINBITS,
    bitrate_index,
    bitrate_value,
    bitrate_value_lsf,
    mixed_switch_bound,
    mode_bits,
    switch_bound,
)
from ..utils.profiling import annotate

MAX_FRAME_MAIN_BITS = 1152 * 15  # all pair slots at 15 bits
# the Layer III bitrates (kbps) demand VBR chooses among: MPEG-1, and at LSF
# rates MPEG-2's (the latter a copy of swiftmp3_tpu/ops/reference.py
# LSF_L3_BITRATES; tests hold it equal)
VBR_BITRATES = tuple(int(b) for b in BITRATE_TABLE_V1 if b)
LSF_L3_BITRATES = tuple(int(b) for b in BITRATE_TABLE_V2 if b)
# The linbits law's initial-gain target (peaks quantize near 2048) and its
# demand probe (the grid candidate whose priced bits are a granule's demand
# under demand_budget): copies of swiftmp3_tpu/ops/reference.py
# LINBITS_Q_TARGET and K_DEMAND, held equal by the tests.
LINBITS_Q_TARGET = 2048.0
K_DEMAND = 10

_CARRY_SPEC = {
    # name: (per-stream shape given (channels, reservoir_depth), dtype)
    "fb_hist": (lambda ch, k: (ch, 480), torch.float32),
    "overlap": (lambda ch, k: (ch, 576), torch.float32),
    "stream_len": (lambda ch, k: (), torch.int32),
    "est_stream_len": (lambda ch, k: (), torch.int32),
    "avail": (lambda ch, k: (), torch.int32),
    "pad_rem": (lambda ch, k: (), torch.int32),
    "slot_fifo": (lambda ch, k: (k,), torch.int32),
    "vbr_ehist": (lambda ch, k: (10,), torch.float32),
    "vbr_count": (lambda ch, k: (), torch.int32),
}
# window_sequencing's carry: the previous granule's emitted-short state and
# raw want, and its last two 96-sample block energies per channel (+inf: no
# past yet)
_SEQ_CARRY_SPEC = {
    "seq_prev_short": (lambda ch, k: (), torch.bool),
    "seq_prev_want": (lambda ch, k: (), torch.bool),
    "onset_prev2": (lambda ch, k: (ch, 2), torch.float32),
}


def _carry_spec(window_sequencing: bool) -> dict:
    return {**_CARRY_SPEC, **(_SEQ_CARRY_SPEC if window_sequencing else {})}


def lowpass_cut(options: MP3EncoderOptions) -> int | None:
    """The lowpass's cut subband, or None when the stage does not run: no
    lowpass_hz, or a cut at or above Nyquist, which is a byte no-op
    (pipeline.py:425-427)."""
    lp = options.lowpass_hz
    if lp is None or lp * 64 // options.sample_rate >= 32:
        return None
    return int(lp * 64 // options.sample_rate)


def frame_geometry(options: MP3EncoderOptions) -> tuple[int, int, int]:
    """(slots a kbps, side-info bytes, CRC bytes) of a frame: 144 and 17/32
    (mono/stereo) at MPEG-1; 72 and 9/17 at LSF rates, whose frames carry
    one granule (pipeline.py:141-147, 166-189)."""
    mono = options.channels == 1
    crc = 2 if options.crc_protected else 0
    if options.lsf:
        return 72, 9 if mono else 17, crc
    return 144, 17 if mono else 32, crc


def frame_bitrate(options: MP3EncoderOptions, kbps: int) -> tuple[int, int]:
    """(header bitrate index, kbps) of a frame at `kbps`: in free format
    index 0 and the exact rate (ISO 11172-3 2.4.2.3); else the table entry
    nearest to kbps, from the MPEG-2 table at LSF rates."""
    if options.free_format:
        return 0, kbps
    index = bitrate_index(kbps, options.sample_rate)
    return index, bitrate_value_lsf(index) if options.lsf else bitrate_value(index)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. A CUDA device raises when no card is
    present: nothing falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def init_carry(
    batch: int, options: MP3EncoderOptions, device: torch.device
) -> dict:
    """Fresh per-stream state (pipeline.py:80-115): zeros, and +inf block
    energies (no past) under window_sequencing."""
    ch, k = options.channels, options.reservoir_depth
    carry = {
        name: torch.zeros((batch, *shape(ch, k)), dtype=dtype, device=device)
        for name, (shape, dtype) in _carry_spec(options.window_sequencing).items()
    }
    if options.window_sequencing:
        carry["onset_prev2"].fill_(float("inf"))
    return carry


def lowpass_stage(
    spectra: torch.Tensor, block: torch.Tensor, cut_sb: int, adaptive: bool
) -> torch.Tensor:
    """The subband lowpass on the MDCT output (pipeline.py:425-450): zero
    every coefficient from subband cut_sb up; under adaptive_lowpass only in
    the granules that engage (dsp.adaptive_lowpass_engage), and always in a
    non-LONG granule. spectra: [..., 576]; block: [...] the block types."""
    mask = (torch.arange(576, device=spectra.device) < cut_sb * 18).to(torch.float32)
    if not adaptive:
        return spectra * mask
    engage = (block != dsp.BLOCK_LONG) | dsp.adaptive_lowpass_engage(spectra, cut_sb)
    return torch.where(engage[..., None], spectra * mask, spectra)


def demand_vbr_candidates(options: MP3EncoderOptions) -> tuple[list, list]:
    """Demand VBR's candidate bitrates, the band [32, min(table top, base +
    64 - 4q)] of the MPEG-1 table, or at LSF rates [8, ...] of the MPEG-2
    one, and each one's slot in bits (pipeline.py:736-765). The top is at
    least the base's lowest value + 64 - 36, so the band is never empty."""
    sr = options.sample_rate
    table, low = (LSF_L3_BITRATES, 8) if options.lsf else (VBR_BITRATES, 32)
    top = min(table[-1], options.bitrate_kbps + 64 - options.quality * 4)
    cands = [b for b in table if low <= b <= top]
    slots_per_kbps, side, crc = frame_geometry(options)
    return cands, [((slots_per_kbps * b * 1000) // sr - 4 - crc - side) * 8 for b in cands]


def main_data_cap(options: MP3EncoderOptions) -> int:
    """Static per-frame cap (bytes) of the packed main_data image
    (pipeline.py:118-149): the frame's largest slot (the top VBR rate, 160
    kbps at LSF rates; free format's exact rate) plus the reservoir reach
    (511 bytes, 255 at LSF), bounded by 1152 pair slots x 15 bits; even."""
    sr = options.sample_rate
    if options.vbr:
        top = 160 if options.lsf else 320
        max_kbps = min(top, options.bitrate_kbps + 64 - options.quality * 4)
    else:
        max_kbps = options.bitrate_kbps
    _, br_val = frame_bitrate(options, max_kbps)
    slots_per_kbps, side, crc = frame_geometry(options)
    slot_max = (slots_per_kbps * br_val * 1000) // sr + 1 - 4 - crc - side
    cap = min(MAX_FRAME_MAIN_BITS // 8, slot_max + options.reservoir_cap + 1)
    return cap + (cap & 1)


def max_frame_bytes(options: MP3EncoderOptions) -> int:
    """The most bytes a frame of these options can take, header and side
    information included: a padded frame at the top rate of the header's
    table (320 kbps, 160 at LSF rates; free format's exact rate)."""
    top = options.bitrate_kbps if options.free_format else (160 if options.lsf else 320)
    _, br_val = frame_bitrate(options, top)
    slots_per_kbps, _, _ = frame_geometry(options)
    return (slots_per_kbps * br_val * 1000) // options.sample_rate + 1


def switch_region0(block: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """The region-0 line boundary of switching granules at LSF rates, by
    block type (pipeline.py:567-584): band-derived for SHORT
    (tables.switch_bound(sr, True)) and for START/STOP (switch_bound(sr,
    False)), the decoders' reading for MIXED (tables.mixed_switch_bound: 36,
    or 54 and 108 at MPEG-2.5 rates). Long granules ignore it."""
    return torch.where(
        block == dsp.BLOCK_SHORT,
        switch_bound(sample_rate, True),
        torch.where(
            block == dsp.BLOCK_MIXED,
            mixed_switch_bound(sample_rate),
            switch_bound(sample_rate, False),
        ),
    ).to(torch.int32)


def intensity_stage(
    spectra: torch.Tensor, block: torch.Tensor, gate: torch.Tensor, sample_rate: int
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The intensity analysis and transform (pipeline.py:452-505). spectra
    [B, 2, T, gr, 576], block [B, 2, T, gr] (shared across the channels of
    gated frames), gate [B, T]. A gated frame emits intensity when one of
    its granules has a region (per window in pure-short granules); its left
    spectrum then carries L + R on the region's lines and its right zero.
    Returns (spectra, emit [B, T], the sets the post-walk reads: positions
    and summed bands, long [B, T, gr, 21] and short [B, T, gr, 12, 3], and
    the right channel's granules of emitting frames [B, 2, T, gr] split by
    layout, right_long and right_short)."""
    is_short = block[:, 0] == dsp.BLOCK_SHORT  # [B, T, gr]
    left, right = spectra[:, 0], spectra[:, 1]
    pos, region, has_region, mask_l = dsp.intensity_analyze_device(left, right, sample_rate)
    pos_s, region_s, has_region_s, mask_s = dsp.intensity_analyze_short_device(
        left, right, sample_rate
    )
    has_g = torch.where(is_short, torch.any(has_region_s, dim=-1), has_region)
    emit = gate & torch.any(has_g, dim=-1)
    mask_l = mask_l * (emit[:, :, None] & has_region)[..., None].to(torch.float32)
    mask_s = mask_s * emit[:, :, None, None].to(torch.float32)
    m = torch.where(is_short[..., None], mask_s, mask_l)
    spectra = torch.stack([left + right * m, right * (1.0 - m)], dim=1)
    right_ch = (torch.arange(2, device=spectra.device)[None, :, None, None] == 1) & emit[
        :, None, :, None
    ]
    sets = {
        "pos": pos,
        "summed": region & has_region[..., None],
        "pos_s": pos_s,
        "summed_s": region_s & has_region_s[..., None, :],
        "right_long": right_ch & ~is_short[:, None],
        "right_short": right_ch & is_short[:, None],
    }
    return spectra, emit, sets


def intensity_pad(part2: torch.Tensor, sfd: dict, sets: dict) -> torch.Tensor:
    """part2 priced with the right channel's slots of emitting frames at
    least 7 (pipeline.py:547-565): the long pad on long-layout granules, the
    36-slot pad on pure-short ones."""
    pad_l = dsp.intensity_padded_part2_device(sfd)
    pad_s = dsp.intensity_padded_part2_short_device(sfd)
    return torch.where(
        sets["right_long"], pad_l, torch.where(sets["right_short"], pad_s, part2)
    )


def intensity_q_fixup(q: torch.Tensor, sets: dict, sample_rate: int) -> torch.Tensor:
    """The knife-edge zeroing of the selected quantization (pipeline.py:
    909-923): long-layout granules on their natural order; pure-short ones
    through the short reorder to the natural order and back."""
    q = dsp.intensity_q_fixup(q, sets["right_long"], sample_rate)
    q_nat = dsp.reorder_stream_to_natural(q, sample_rate, False)
    q_nat = dsp.intensity_q_fixup_short(q_nat, sets["right_short"], sample_rate)
    q_s = dsp.reorder_natural_to_stream(q_nat, sample_rate, False)
    return torch.where(sets["right_short"][..., None], q_s, q)


def intensity_post_walk_sfd(
    sfd: dict, quantized: torch.Tensor, sets: dict, sample_rate: int
) -> dict:
    """The right channel's position slots of emitting frames after the walk
    (pipeline.py:928-956): the long law on long-layout granules, the
    per-window law on pure-short ones (on the natural view of the fixed
    quantization)."""
    B, _, T, n_gr = sets["right_long"].shape
    shape = (B, 2, T, n_gr)
    sfd = dsp.intensity_sfd_device(
        sfd,
        quantized,
        sets["pos"][:, None].expand(*shape, 21),
        sets["summed"][:, None].expand(*shape, 21),
        sets["right_long"],
        sample_rate,
    )
    return dsp.intensity_sfd_short_device(
        sfd,
        dsp.reorder_stream_to_natural(quantized, sample_rate, False),
        sets["pos_s"][:, None].expand(*shape, 12, 3),
        sets["summed_s"][:, None].expand(*shape, 12, 3),
        sets["right_short"],
        sample_rate,
    )


def distortion_pass(
    pre: dict,
    spectra: torch.Tensor,
    sfd: dict,
    engaged: torch.Tensor,
    probe_budget: int,
    sample_rate: int,
    proportional: bool,
) -> tuple[dict, torch.Tensor]:
    """One distortion-control pass (pipeline.py:641-664): the probe selection
    at the static equal-share budget on the last sweep, its quantization,
    the bumps, and the bumped scalefactors on engaged granules. Returns
    (the scalefactor dict, the initial gains of the next sweep)."""
    budget = torch.full(pre["gstart"].shape, probe_budget, dtype=torch.int32, device=spectra.device)
    k, fit, _ = dsp.rate_loop_select(pre["bits"], pre["evaluated"], pre["k_budget"], budget)
    gains = pre["gstart"] + 4 * k
    q = dsp.quantize_at_gains(
        pre["mag"], pre["sign_neg"], gains[..., None], iso=pre["iso"],
        qcap=QCAP_LINBITS, floor=False,
    )[..., 0, :]
    gain = torch.where(fit, gains, torch.clamp(gains + 4, max=255)).to(torch.int32)
    bumps = dsp.distortion_bumps_device(
        spectra, q, gain, sfd["sf"], sample_rate, proportional=proportional
    )
    sfd = dsp.distortion_sfd_device(sfd, bumps, engaged, sample_rate)
    g0 = dsp.initial_gain_scaled(spectra, sfd["mag_scale"], target=LINBITS_Q_TARGET)
    return sfd, g0


def rate_loop_config(options: MP3EncoderOptions) -> kernels.RateLoopConfig:
    """What the chunk program's scans over T (kernels.rate_loop_scan and
    placement_scan) read of the options."""
    slots_per_kbps, side_size, crc_size = frame_geometry(options)
    cbr_index, cbr_value = frame_bitrate(options, options.bitrate_kbps)
    rate_law, cands, cand_slot_bits = "cbr", (), ()
    if options.vbr and options.vbr_demand:
        rate_law = "demand"
        cands, cand_slot_bits = (tuple(x) for x in demand_vbr_candidates(options))
    elif options.vbr:
        rate_law = "energy"
    return kernels.RateLoopConfig(
        n_gran=options.n_granules * options.channels,
        sample_rate=options.sample_rate,
        lsf=bool(options.lsf),
        slots_per_kbps=slots_per_kbps,
        side_size=side_size,
        crc_size=crc_size,
        res_cap=options.reservoir_cap,
        rate_law=rate_law,
        cbr_index=cbr_index,
        cbr_value=cbr_value,
        base_kbps=options.bitrate_kbps,
        quality=options.quality,
        cands=cands,
        cand_slot_bits=cand_slot_bits,
        aligned=options.reservoir_mode == "aligned",
        deep=options.reservoir_depth > 1,
        linbits=options.linbits_tables,
        demand_budget=options.spec_strict_entropy and options.demand_budget,
    )


def make_chunk_fn(options: MP3EncoderOptions):
    """Build the chunk encode function
    (carry, pcm [B,T,spf*ch], final [B,T], valid [B,T], la=None) ->
    (carry, outputs), spf = options.samples_per_frame (1152, or 576 at LSF
    rates).

    All tensors lie on one device, the carry's. pcm is float32 or int16
    (normalized by 1/32768). la [B, T, 576*ch]: each frame's lookahead, the
    raw granule after it (zeros past a stream's end), required under
    window_sequencing and ignored otherwise. outputs = {"packed": [B, T,
    cap + 4*M] uint8}: each frame's main_data image followed by its int32
    side-info words, little-endian (the layout `fetch_outputs` reads)."""
    sr = options.sample_rate
    ch = options.channels
    lsf = bool(options.lsf)
    n_gr = options.n_granules  # 1 at LSF rates
    spf = options.samples_per_frame  # 1152, or 576 at LSF rates
    n_gran = n_gr * ch
    slots_per_kbps, side_size, crc_size = frame_geometry(options)
    base_kbps = options.bitrate_kbps
    cap_bytes = main_data_cap(options)
    loop_cfg = rate_loop_config(options)
    iso_quant = options.iso_quantization
    strict = options.spec_strict_entropy
    iso_short = options.iso_short_blocks
    joint = options.mode is Mode.JOINT_STEREO
    mode_ext = mode_bits(options.mode.value)[1]
    layout = meta_layout(options)  # the packed frame's meta fields, in order
    win_seq = options.window_sequencing
    linbits = options.linbits_tables
    demand_budget = loop_cfg.demand_budget
    vbr_demand = loop_cfg.rate_law == "demand"
    cut_sb = lowpass_cut(options)
    intensity = options.intensity_stereo_active and ch == 2
    # distortion control's probe budget: the static equal share of the base
    # rate's main data per granule (pipeline.py:614-622)
    base_main = (slots_per_kbps * base_kbps * 1000) // sr - 4 - crc_size - side_size
    probe_budget = min((base_main * 8) // n_gran, dsp.PART23_MAX_BITS)
    i32 = torch.int32
    demand_k = min(options.quality, 19)  # demand VBR's quality-mapped candidate gain

    def sequence(carry, pcm_bt, left, right, la, final, valid):
        """The ISO window sequence from the raw pre-matrix PCM, shared
        across channels (pipeline.py:228-294): each granule's short want
        (a transient or an onset/drop), the next granule's (the frame's
        lookahead granule for its last, never past a stream's end), then
        the sequencing law. Returns (block [B, ch, T, gr], onset tails
        [B, chs, G, 2], seq_prev_short, seq_prev_want)."""
        B, T = valid.shape
        if ch == 1:
            raw_g = pcm_bt.reshape(B, 1, T, n_gr, 576)
            la_g = la.reshape(B, 1, T, 576)
        else:
            raw_g = torch.stack([left, right], dim=1).reshape(B, 2, T, n_gr, 576)
            la_g = torch.stack([la[..., 0::2], la[..., 1::2]], dim=1)  # [B, 2, T, 576]
        chs = raw_g.shape[1]
        rb, _ = dsp.transient_frame(raw_g)  # [B, chs, T, gr]
        ow, tails = dsp.onset_wants_chunk(
            raw_g.reshape(B, chs, T * n_gr, 576), carry["onset_prev2"]
        )
        want_b = torch.any((rb != dsp.BLOCK_LONG) | ow.reshape(B, chs, T, n_gr), dim=1)
        # the lookahead granule of frame t follows frame t's last granule:
        # that granule's tails are its chain context
        lb, _ = dsp.transient_frame(la_g)  # [B, chs, T]
        la_prev2 = tails.reshape(B, chs, T, n_gr, 2)[..., -1, :]
        ow_la, _ = dsp.onset_wants_chunk(la_g[..., None, :], la_prev2)
        want_la = torch.any((lb != dsp.BLOCK_LONG) | ow_la[..., 0], dim=1)  # [B, T]
        # nothing attacks past a stream's end (the golden law's flush)
        want_la = want_la & ~final
        want_next = torch.cat([want_b[..., 1:], want_la[..., None]], dim=-1)
        bts, seq_ps, seq_pw = dsp.sequence_blocks_chunk(
            want_b.reshape(B, n_gr * T),
            want_next.reshape(B, n_gr * T),
            valid.repeat_interleave(n_gr, dim=1),
            carry["seq_prev_short"],
            carry["seq_prev_want"],
        )
        block_b = bts.reshape(B, 1, T, n_gr).expand(B, ch, T, n_gr)
        return block_b, tails, seq_ps, seq_pw

    def run(carry, pcm, final, valid, la=None):
        with annotate("chunk.phase1"):
            pcm = dsp.ingest(pcm)
            B, T = pcm.shape[0], pcm.shape[1]
            dev = pcm.device

            # ---------------- Phase 1: parallel DSP (batch-major) ----------------
            pcm_bt = pcm.reshape(B, T * pcm.shape[-1])
            use_ms = None  # per-frame M/S decision (joint stereo only)
            left = right = None
            raw_blocks = None  # the raw L/R transient verdicts [B, 2, T, gr]

            def raw_verdicts():
                nonlocal raw_blocks
                if raw_blocks is None:
                    raw_g = torch.stack([left, right], dim=1).reshape(B, 2, T, n_gr, 576)
                    raw_blocks = dsp.transient_frame(raw_g)[0]
                return raw_blocks

            if ch == 2:
                left = pcm_bt[:, 0::2].reshape(B, T, spf)
                right = pcm_bt[:, 1::2].reshape(B, T, spf)
            if win_seq:
                if la is None:
                    raise ValueError(
                        "window_sequencing needs each frame's lookahead granule, "
                        "la [B, T, 576*ch]"
                    )
                block_b, onset_tails, seq_ps, seq_pw = sequence(
                    carry, pcm_bt, left, right, dsp.ingest(la), final, valid
                )
                sb_gain_b = torch.zeros((B, ch, T, n_gr, 3), dtype=i32, device=dev)
            is_gate = is_shared_blk = None  # [B, T]; [B, T, gr]
            if ch == 1:
                pcm_chunk = pcm_bt[:, None, :]
            else:
                if joint:
                    use_ms, c0, c1 = dsp.stereo_decide(
                        left, right, iso_matrix=options.iso_ms_matrix,
                        symmetric=options.ms_symmetric,
                    )
                else:
                    c0, c1 = left, right
                if intensity:
                    # The intensity gate (pipeline.py:296-366): frames whose
                    # granules are all LONG-layout or pure SHORT on the raw L/R
                    # (the sequencing blocks, else the raw transient verdicts,
                    # shared across channels) code raw L/R and may emit
                    # intensity; under ms_symmetric side-dominant M/S frames opt
                    # out. use_ms is masked on gated frames.
                    if win_seq:
                        is_gate = torch.all(block_b[:, 0] != dsp.BLOCK_MIXED, dim=-1)
                    else:
                        is_shared_blk = torch.amax(raw_verdicts(), dim=1)
                        is_gate = torch.all(is_shared_blk != dsp.BLOCK_MIXED, dim=-1)
                    if options.ms_symmetric:
                        _, _, mid_e, side_e = dsp.ms_energies(left, right, options.iso_ms_matrix)
                        is_gate = is_gate & ~(use_ms & (mid_e < side_e * 0.4))
                    c0 = torch.where(is_gate[..., None], left, c0)
                    c1 = torch.where(is_gate[..., None], right, c1)
                    use_ms = use_ms & ~is_gate
                pcm_chunk = torch.stack([c0, c1], dim=1).reshape(B, ch, T * spf)
            granule_pcm = pcm_chunk.reshape(B, ch, T, n_gr, 576)

            S, full_x = dsp.polyphase_chunk_matmul(carry["fb_hist"], pcm_chunk)
            if not win_seq:
                block_b, sb_gain_b = dsp.transient_frame(granule_pcm)  # [B,ch,T,gr], [..,3]
                if options.shared_ms_blocks and use_ms is not None:
                    # M/S frames carry one window layout across both channels: the
                    # raw L/R verdicts, the more transient winning (pipeline.py:388-403)
                    shared = torch.amax(raw_verdicts(), dim=1, keepdim=True)
                    block_b = torch.where(use_ms[:, None, :, None], shared, block_b)
                if lsf and not iso_short:
                    # LSF mixed blocks need the ISO layout of iso_short_blocks;
                    # without it they are SHORT (pipeline.py:380-387, 398-401:
                    # demoting before the shared maximum is demoting after it)
                    block_b = torch.where(block_b == dsp.BLOCK_MIXED, dsp.BLOCK_SHORT, block_b)
                if is_shared_blk is not None:
                    # intensity-gated frames share the raw verdict (pipeline.py:404-411)
                    block_b = torch.where(
                        is_gate[:, None, :, None], is_shared_blk[:, None], block_b
                    )
                if iso_quant:
                    # the unit-gain law emits no per-window gains (pipeline.py:412-417)
                    sb_gain_b = torch.zeros_like(sb_gain_b)
            spectra, cur = dsp.mdct_chunk(
                S, carry["overlap"], block_b.reshape(B, ch, n_gr * T),
                iso_mixed_alias=iso_short, window_seq=win_seq,
            )
            spectra = spectra.reshape(B, ch, T, n_gr, 576)
            if cut_sb is not None:
                spectra = lowpass_stage(spectra, block_b, cut_sb, options.adaptive_lowpass)

            is_emit = None  # [B, T] frames that emit mode_extension 0b01
            if is_gate is not None:
                spectra, is_emit, is_sets = intensity_stage(spectra, block_b, is_gate, sr)

        sfd = scfsi_nib = sf_write = None
        pad_part2 = None
        if strict:
            with annotate("chunk.scalefactors"):
                is_long_b = block_b == dsp.BLOCK_LONG
                # START and STOP granules take the long scalefactor layout and
                # scfsi, but not the long entropy regions (pipeline.py:507-520)
                transition = block_b > dsp.BLOCK_SHORT
                sf_block_b = torch.where(transition, dsp.BLOCK_LONG, block_b)
                long_layout_b = is_long_b | transition
                if options.real_scalefactors:
                    sfd = dsp.granule_scalefactors_device(
                        spectra, sr, sf_block_b, psy=options.psy_scalefactors,
                        iso_short=iso_short, lsf=lsf,
                    )
                    g0 = dsp.initial_gain_scaled(
                        spectra, sfd["mag_scale"], target=LINBITS_Q_TARGET if linbits else 15.0
                    )
                    mag_scale, part2 = sfd["mag_scale"], sfd["part2"]
                    if options.scfsi and not lsf:
                        # granule 1 skips the band groups equal to granule 0's
                        # (an LSF frame has one granule: no scfsi)
                        scfsi_nib, sf_write = dsp.scfsi_device(sfd["sf"], long_layout_b)
                        part2 = dsp.scfsi_part2_device(sfd, sf_write)
                    if is_emit is not None:
                        # the intensity pricing pad (pipeline.py:547-565): the
                        # post-walk overwrite may grow the right channel's slots
                        # of emitted frames to the marker 7. Distortion control
                        # never engages those frames, so the first scalefactors
                        # price them in every pass.
                        pad_part2 = functools.partial(intensity_pad, sfd=sfd, sets=is_sets)
                else:
                    g0 = dsp.initial_gain(spectra, iso=iso_quant)
                    mag_scale = part2 = None

                b0_sw = switch_region0(block_b, sr) if lsf else None

            def sweep(g0, mag_scale, part2):
                if pad_part2 is not None:
                    part2 = pad_part2(part2)
                return dsp.rate_loop_precompute_strict(
                    spectra, g0, sr, is_long_b, iso_quant, options.count1_coding,
                    options.region_table_select, mag_scale=mag_scale, part2=part2,
                    block=block_b, iso_short=iso_short, linbits=linbits, b0_switch=b0_sw,
                )

            with annotate("chunk.sweep"):
                pre = sweep(g0, mag_scale, part2)
                # the demand probes read the first pass's table (pipeline.py:600)
                demand_bits = pre["bits"]
                if options.distortion_control_active:
                    # [B, T] all-LONG frames
                    engaged = torch.all(block_b == dsp.BLOCK_LONG, dim=(1, 3))
                    if is_emit is not None:
                        engaged = engaged & ~is_emit
                    engaged = engaged[:, None, :, None].expand(block_b.shape)
                    for _ in range(options.dc_passes):
                        # the probe and the bumps; the pass's sweep stays outside
                        with annotate("chunk.dc"):
                            sfd, g0 = distortion_pass(
                                pre, spectra, sfd, engaged, probe_budget, sr, options.dc_proportional
                            )
                        mag_scale, part2 = sfd["mag_scale"], sfd["part2"]
                        pre = None  # release the pass's sweep before the next
                        pre = sweep(g0, mag_scale, part2)
        else:
            with annotate("chunk.scalefactors"):
                g0 = dsp.initial_gain(spectra, iso=iso_quant)
            with annotate("chunk.sweep"):
                pre = dsp.rate_loop_precompute(spectra, g0, iso=iso_quant)
                demand_bits = pre["bits"]

        def tm(x):  # [B, ch, T, gr, ...] -> [T, B, G, ...], G = gr*ch + c
            rest = tuple(range(4, x.dim()))
            return x.permute(2, 0, 3, 1, *rest).reshape(T, B, n_gran, *x.shape[4:])

        def bm(x):  # inverse of tm
            y = x.reshape(T, B, n_gr, ch, *x.shape[3:])
            return y.permute(1, 3, 0, 2, *range(4, y.dim()))

        frame_e = demand_t = frame_demand_t = None
        if loop_cfg.rate_law == "energy":
            frame_e = dsp.mean_square(pcm).transpose(0, 1).contiguous()  # [T, B]
        granule_e = tm(dsp.mean_square(granule_pcm)).contiguous()  # [T, B, G]
        final_t = final.transpose(0, 1).contiguous()
        valid_t = valid.transpose(0, 1).contiguous()
        bits_t = tm(pre["bits"]).contiguous()
        evaluated_t = tm(pre["evaluated"]).contiguous()
        k_budget_t = tm(pre["k_budget"]).contiguous()
        if demand_budget:
            demand_t = tm(demand_bits[..., K_DEMAND]).contiguous()  # [T, B, G]
        if vbr_demand:
            frame_demand_t = torch.sum(tm(demand_bits[..., demand_k]), dim=-1, dtype=i32)  # [T, B]
        del demand_bits

        # ---------------- Phase 2: integer scan over T (K4) ----------------
        with annotate("chunk.loop_t"):
            c = {
                k: carry[k]
                for k in ("stream_len", "avail", "pad_rem", "slot_fifo", "vbr_ehist", "vbr_count")
            }
            if strict:
                # the selection runs in the priced world; the real stream_len and
                # mdb come from the second scan below on the actual bits
                c["stream_len"] = carry["est_stream_len"]
            c, (br_idx, padding, mdb, slot, k_sel, has_fit, bits_sel) = kernels.rate_loop_scan(
                loop_cfg, c, bits_t, evaluated_t, k_budget_t, granule_e, final_t, valid_t,
                frame_e=frame_e, demand=demand_t, frame_demand=frame_demand_t,
            )

        # ---------------- Phase 3: parallel finalize (batch-major) --------
        with annotate("chunk.finalize"):
            new_carry = dict(c)
            if strict:
                q_fixup = None
                if is_emit is not None:
                    q_fixup = functools.partial(intensity_q_fixup, sets=is_sets, sample_rate=sr)
                gain_b, quantized, lay = dsp.strict_finalize(
                    pre, bm(k_sel), bm(has_fit), q_fixup=q_fixup
                )
                if is_emit is not None:
                    # the post-walk position slots and the actual part2
                    # (pipeline.py:928-957)
                    sfd = intensity_post_walk_sfd(sfd, quantized, is_sets, sr)
                    part2 = sfd["part2"]
                # part2_3_length and the reservoir on the ACTUAL bits of the
                # selected gains (pipeline.py:958-1006)
                part23 = tm(lay["bits"] + (part2 if part2 is not None else 0))
                hb_t = (torch.sum(part23, dim=-1, dtype=i32) + 7) // 8
                with annotate("chunk.loop_t"):
                    c2, mdb = kernels.placement_scan(
                        loop_cfg,
                        {"stream_len": carry["stream_len"], "slot_fifo": carry["slot_fifo"]},
                        hb_t, slot, final_t, valid_t,
                    )
                new_carry["est_stream_len"] = c["stream_len"]
                new_carry["stream_len"] = c2["stream_len"]
                big_values_b = lay["bv"]
                region0_b, region1_b = lay["r0"], lay["r1"]
                table_sel = torch.stack(
                    [tm(lay["tid0"]), tm(lay["tid1"]), tm(lay["tid2"])], dim=-1
                ).reshape(T, B, 3 * n_gran)
                c1t_b = lay["c1t"]
                chunks, nb = dsp.strict_chunks_device(quantized, lay, linbits=linbits)
                if sfd is not None:
                    # the scalefactor bits lead each granule's main_data (part2)
                    sf_chunks, sf_nbits = dsp.scalefactor_chunks_device(sfd, sf_write)
                    chunks = torch.cat([sf_chunks, chunks], dim=-1)
                    nb = torch.cat([sf_nbits, nb], dim=-1)
                    scfc_b = sfd["compress"]
                else:
                    scfc_b = torch.zeros_like(big_values_b)
            else:
                part23 = bits_sel
                gain_b, quantized, big_values_b = dsp.rate_loop_finalize(
                    pre, bm(k_sel), bm(has_fit)
                )
                region0_b, region1_b = dsp.region_counts(big_values_b, sr)
                table_sel = torch.full((T, B, 3 * n_gran), 15, dtype=i32, device=dev)
                c1t_b = scfc_b = torch.zeros_like(big_values_b)
                chunks, nb = dsp.pair_chunks_device(quantized, big_values_b)
                new_carry["est_stream_len"] = carry["est_stream_len"]
            if iso_quant:
                pref_b = torch.zeros_like(big_values_b)  # no pre-emphasis applied
            else:
                pref_b = dsp.preflag(spectra)

            def frame_major(x):  # [B, ch, T, gr, W] -> [B*T, n_gran*W], (gr, ch) order
                return x.permute(0, 2, 3, 1, 4).reshape(B * T, n_gran * x.shape[-1])

        with annotate("chunk.pack"):
            main_data, _ = kernels.pack(
                frame_major(chunks).contiguous(), frame_major(nb).contiguous(), cap_bytes
            )
            main_data = main_data.reshape(B, T, cap_bytes)

            if scfsi_nib is not None:
                scfsi_t = scfsi_nib.permute(2, 0, 1)  # [B, ch, T] -> [T, B, ch]
            else:
                scfsi_t = torch.zeros((T, B, ch), dtype=i32, device=dev)
            if use_ms is not None and options.iso_mode_ext:
                # the header carries each frame's actual M/S decision
                mode_ext_t = torch.where(use_ms.transpose(0, 1), 2, 0)
            else:
                mode_ext_t = torch.full((T, B), mode_ext, dtype=i32, device=dev)
            if is_emit is not None:
                mode_ext_t = torch.where(is_emit.transpose(0, 1), 1, mode_ext_t)  # intensity
            fields = {  # [T, B, width] each
                "bitrate_index": br_idx[..., None],
                "padding": padding[..., None],
                "mdb": mdb[..., None],
                "slot": slot[..., None],
                "part23": part23,  # part2_3_length
                "big_values": tm(big_values_b),
                "gain": tm(gain_b),
                "block_type": tm(block_b),
                "preflag": tm(pref_b),
                "region0": tm(region0_b),
                "region1": tm(region1_b),
                "subblock_gain": tm(sb_gain_b).reshape(T, B, 3 * n_gran),
                "table_select": table_sel,
                "count1table": tm(c1t_b),
                "scalefac_compress": tm(scfc_b),
                "scfsi": scfsi_t,
                "mode_ext": mode_ext_t[..., None].to(i32),
            }
            if fields.keys() != layout.keys() or any(
                fields[name].shape != (T, B, n) for name, (_, n) in layout.items()
            ):
                shapes = {name: tuple(f.shape) for name, f in fields.items()}
                raise RuntimeError(f"meta fields {shapes} disagree with meta_layout {layout}")
            meta = torch.cat([fields[name] for name in layout], dim=-1).to(i32)
            meta_bytes = meta.transpose(0, 1).contiguous().view(torch.uint8).reshape(B, T, -1)
            outputs = {"packed": torch.cat([main_data, meta_bytes], dim=-1)}

        # ---------------- Carry-out at each stream's last valid frame -------
        with annotate("chunk.carry_out"):
            count_valid = torch.sum(valid, dim=1)  # [B] int64
            # trailing-480 slab of frame t starts at full_x[spf * t]
            idx = (count_valid * spf)[:, None, None] + torch.arange(480, device=dev)
            fb_hist = torch.gather(full_x, 2, idx.expand(B, ch, 480))
            all_ov = torch.cat([carry["overlap"][:, :, None, :], cur], dim=2)
            gi = (n_gr * count_valid)[:, None, None, None].expand(B, ch, 1, 576)
            overlap = torch.gather(all_ov, 2, gi)[:, :, 0]

            new_carry["fb_hist"] = fb_hist
            new_carry["overlap"] = overlap
            if win_seq:
                new_carry["seq_prev_short"] = seq_ps
                new_carry["seq_prev_want"] = seq_pw
                # the last valid granule's tails (index 0: the carry, when no
                # frame is valid), gathered: the +inf sentinel meets no product
                ext_tails = torch.cat([carry["onset_prev2"][:, :, None, :], onset_tails], dim=2)
                gi = (n_gr * count_valid)[:, None, None, None].expand(B, ext_tails.shape[1], 1, 2)
                new_carry["onset_prev2"] = torch.gather(ext_tails, 2, gi)[:, :, 0]
        return new_carry, outputs

    return run


# --- Host side of the output contract (numpy only) ------------------------------


def _iso_block_type(block: int, iso_short: bool) -> int:
    """The side-info block_type of an internal block type: START 1, STOP 3,
    MIXED 2 (+ mixed_block_flag) under iso_short_blocks, else as is."""
    if block == dsp.BLOCK_START:
        return 1
    if block == dsp.BLOCK_STOP:
        return 3
    if block == dsp.BLOCK_MIXED and iso_short:
        return dsp.BLOCK_SHORT
    return block


_GRANULE_FIELDS = (
    "part23",
    "big_values",
    "gain",
    "block_type",
    "preflag",
    "region0",
    "region1",
)


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


_FRAME_FIELDS = ("bitrate_index", "padding", "mdb", "slot", "mode_ext")  # one word a frame


def meta_layout(options: MP3EncoderOptions) -> dict:
    """Where each field lies in a packed frame's meta, the int32 words that
    follow its `main_data_cap` bytes of main_data: {name: (first word,
    words)}, in the chunk program's order, the granule fields G = n_granules
    x channels words wide (subblock_gain and table_select 3 G, scfsi a word
    a channel)."""
    G, ch = options.n_granules * options.channels, options.channels
    widths = [
        ("bitrate_index", 1), ("padding", 1), ("mdb", 1), ("slot", 1),
        *((name, G) for name in _GRANULE_FIELDS),
        ("subblock_gain", 3 * G), ("table_select", 3 * G), ("count1table", G),
        ("scalefac_compress", G), ("scfsi", ch), ("mode_ext", 1),
    ]
    layout, o = {}, 0
    for name, n in widths:
        layout[name] = (o, n)
        o += n
    return layout


def fetch_outputs(outs, options: MP3EncoderOptions) -> dict:
    """Unpack the packed chunk output to named host arrays, all batch-major
    [B, T, ...] (twin of pipeline.py:1206-1240)."""
    n_gran = options.n_granules * options.channels
    packed = _host_array(outs["packed"])
    cap = main_data_cap(options)
    meta = packed[..., cap:].copy().view(np.int32)
    B, T = meta.shape[0], meta.shape[1]
    d = {"main_data": packed[..., :cap]}
    for name, (o, n) in meta_layout(options).items():
        d[name] = meta[..., o] if name in _FRAME_FIELDS else meta[..., o : o + n]
    for name in ("subblock_gain", "table_select"):
        d[name] = d[name].reshape(B, T, n_gran, 3)
    d["hb"] = (d["part23"].sum(axis=-1) + 7) // 8
    return d


def frame_results_from_outputs(
    outs: dict, options: MP3EncoderOptions, t: int, b: int
) -> FrameResult:
    """One (stream, time) slice of fetched outputs as a FrameResult for the
    host assembler (twin of pipeline.py:1243-1308)."""
    ch = options.channels
    n_gr = options.n_granules
    granules = [[None] * ch for _ in range(n_gr)]
    for g in range(n_gr * ch):
        gr, c = divmod(g, ch)
        block = int(outs["block_type"][b, t, g])
        granules[gr][c] = GranuleInfo(
            part23_length=int(outs["part23"][b, t, g]),
            big_values=int(outs["big_values"][b, t, g]),
            global_gain=int(outs["gain"][b, t, g]),
            scalefac_compress=int(outs["scalefac_compress"][b, t, g]),
            window_switching=0 if block == dsp.BLOCK_LONG else 1,
            # iso_short_blocks signals a mixed granule as ISO block_type 2 +
            # mixed_block_flag (the reference's raw enum writes 1, ISO
            # start); window sequencing's START and STOP take ISO 1 and 3
            block_type=_iso_block_type(block, options.iso_short_blocks),
            mixed_block_flag=1 if block == dsp.BLOCK_MIXED else 0,
            table_select=tuple(int(x) for x in outs["table_select"][b, t, g]),
            subblock_gain=tuple(int(x) for x in outs["subblock_gain"][b, t, g]),
            region0_count=int(outs["region0"][b, t, g]),
            region1_count=int(outs["region1"][b, t, g]),
            preflag=int(outs["preflag"][b, t, g]),
            # real_scalefactors amplify by 2^(0.75 sf), which the ISO factor
            # cancels exactly at scalefac_scale = 1
            scalefac_scale=1 if options.real_scalefactors else 0,
            count1table_select=int(outs["count1table"][b, t, g]),
        )
    hb = int(outs["hb"][b, t])
    cap = outs["main_data"].shape[-1]
    if hb > cap:
        raise RuntimeError(
            f"frame main_data ({hb} B) exceeds the device pack cap ({cap} B); "
            "rate-loop overflow beyond the reservoir bound — raise "
            "main_data_cap for this configuration"
        )
    return FrameResult(
        bitrate_index=int(outs["bitrate_index"][b, t]),
        padding=int(outs["padding"][b, t]),
        main_data_begin=int(outs["mdb"][b, t]),
        slot_size=int(outs["slot"][b, t]),
        granules=granules,
        big_values=np.asarray(outs["big_values"][b, t], dtype=np.int32),
        main_data=outs["main_data"][b, t, :hb].tobytes(),
        scfsi=[
            [(int(outs["scfsi"][b, t, c]) >> (3 - g)) & 1 for g in range(4)]
            for c in range(ch)
        ],
        mode_ext=int(outs["mode_ext"][b, t]),
    )


# --- Checkpoints across backends -------------------------------------------------


def carry_from_jax(
    state: dict, device: torch.device, options: MP3EncoderOptions | None = None
) -> dict:
    """The port's carry from a JAX checkpoint (`TPUBackend.state_dict()` or a
    `BatchEncoder.carry` as numpy arrays). Older checkpoints convert as the
    JAX backend converts them (pipeline.py:1370-1388): a pre-depth one
    (prev_slot / has_buffered) to a one-slot fifo; a window-sequencing one
    without the raw-want carry gets zeros, one without the block-energy
    carry +inf (no past). `options`, when given, is the session's: a
    window_sequencing session needs the sequencing carry, and no other
    takes it; without it the carry keeps what the state holds."""
    state = dict(state)
    if "slot_fifo" not in state and "prev_slot" in state:
        ps = np.asarray(state.pop("prev_slot"))
        hb = np.asarray(state.pop("has_buffered"))
        fifo = np.zeros((ps.shape[0], 1), dtype=np.int32)
        fifo[:, -1] = np.where(hb, ps, 0)
        state["slot_fifo"] = fifo
    if "seq_prev_short" in state:
        prev_short = np.asarray(state["seq_prev_short"])
        if "seq_prev_want" not in state:
            state["seq_prev_want"] = np.zeros_like(prev_short)
        if "onset_prev2" not in state:
            ch = np.asarray(state["fb_hist"]).shape[1]
            state["onset_prev2"] = np.full((prev_short.shape[0], ch, 2), np.inf, np.float32)
    seq = options.window_sequencing if options is not None else "seq_prev_short" in state
    spec = _carry_spec(seq)
    missing = sorted(set(spec) - set(state))
    extra = sorted(set(state) - set(spec))
    if missing or extra:
        raise ValueError(
            f"checkpoint carry keys do not fit these options: missing {missing}, "
            f"unknown {extra}"
        )
    carry = {}
    for name, (_, dtype) in spec.items():
        arr = np.array(state[name])  # a writable copy for torch
        carry[name] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return carry


def carry_to_jax(carry: dict) -> dict:
    """The port's carry as the numpy arrays a JAX backend loads."""
    return {k: v.detach().cpu().numpy() for k, v in carry.items()}


class TorchBackend:
    """Single-stream session backend on `device` (the card by default):
    fixed-size chunks of frames, partial chunks padded with valid=False
    lanes (twin of pipeline.TPUBackend)."""

    CHUNK = 8

    def __init__(self, options: MP3EncoderOptions, device="cuda"):
        self.options = options
        self.device = resolve_device(device)
        self._run = make_chunk_fn(options)
        self.carry = init_carry(1, options, self.device)

    def encode_frames(
        self, frames: np.ndarray, is_final: np.ndarray, lookahead: np.ndarray = None
    ) -> List[FrameResult]:
        """Encode frames [F, spf*ch]; under window_sequencing, lookahead
        [F, 576*ch] holds each frame's next raw granule (zeros when absent,
        as past a stream's end)."""
        n = self.options.samples_per_frame * self.options.channels
        la_n = SAMPLES_PER_GRANULE * self.options.channels
        F = len(frames)
        results: List[FrameResult] = []
        for start in range(0, F, self.CHUNK):
            count = min(self.CHUNK, F - start)
            pcm = np.zeros((1, self.CHUNK, n), dtype=np.float32)
            fin = np.zeros((1, self.CHUNK), dtype=bool)
            val = np.zeros((1, self.CHUNK), dtype=bool)
            pcm[0, :count] = frames[start : start + count]
            fin[0, :count] = is_final[start : start + count]
            val[0, :count] = True
            la = None
            if self.options.window_sequencing:
                la = np.zeros((1, self.CHUNK, la_n), dtype=np.float32)
                if lookahead is not None:
                    la[0, :count] = lookahead[start : start + count]
                la = torch.from_numpy(la).to(self.device)
            self.carry, outs = self._run(
                self.carry,
                torch.from_numpy(pcm).to(self.device),
                torch.from_numpy(fin).to(self.device),
                torch.from_numpy(val).to(self.device),
                la,
            )
            outs = fetch_outputs(outs, self.options)
            for t in range(count):
                results.append(frame_results_from_outputs(outs, self.options, t, 0))
        return results

    def notify_flush(self) -> None:
        """Mirror the assembler's flush_buffered (drains the slot fifo)."""
        fifo = self.carry["slot_fifo"].cpu().numpy()
        for key in ("stream_len", "est_stream_len"):
            sl = self.carry[key].cpu().numpy().copy()
            for k in range(fifo.shape[1]):
                sl = np.maximum(sl - fifo[:, k], 0)
            self.carry[key] = torch.from_numpy(sl).to(self.device)
        self.carry["slot_fifo"] = torch.zeros_like(self.carry["slot_fifo"])

    def state_dict(self) -> dict:
        """The carry is the checkpoint; same keys and dtypes as the JAX
        backend's, so either backend resumes the other's."""
        return carry_to_jax(self.carry)

    def load_state_dict(self, state: dict) -> None:
        self.carry = carry_from_jax(state, self.device, self.options)

"""The golden encoder session, frozen for the benchmark: `GoldenBackend` and
`EncoderSession`, copied from the port's `encoder.py` with the device
backend, the JAX checkpoint converters and `MP3Encoder` left out.

The session (PCM buffering, flush, the host frame assembler, checkpoints,
ID3/Xing) is the reference package's `EncoderSession`, copied; its backend
is the golden host implementation (`ops.reference`, frame at a time). It
imports numpy alone: nothing of the measured port and nothing of JAX.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .io.framing import FrameAssembler, FrameResult
from .io.id3 import build_id3_tag
from .io.sideinfo import GranuleInfo
from .io.xing import build_xing_header
from .ops import reference as ref
from .options import SAMPLES_PER_GRANULE, SUBBANDS, MP3EncoderOptions
from .tables import (
    band_table,
    bitrate_index,
    bitrate_value,
    bitrate_value_lsf,
    mixed_reorder_src,
    short_reorder_src,
)

__all__ = [
    "EncoderSession",
    "GoldenBackend",
    "new_session",
    "GAPLESS_ENCODER_DELAY",
    "GAPLESS_DECODER_DELAY",
]

# Gapless bookkeeping (options.gapless_info). The family pipeline delays
# audio by a structural 528 samples (polyphase filterbank + MDCT phase:
# measured as a 1057-sample total source->decode latency through libmpg123,
# minus the standard 529-sample decoder synthesis delay); window_sequencing
# adds its explicit one-granule preroll on top. The LAME info tag's delay
# field carries the encoder part only — players skip delay + 529.
GAPLESS_ENCODER_DELAY = 528
GAPLESS_DECODER_DELAY = 529


def new_session(options: MP3EncoderOptions) -> "EncoderSession":
    """A fresh session on the golden encoder."""
    return EncoderSession(options, GoldenBackend(options))


class GoldenBackend:
    """Pure-numpy frame encoder: the algorithmic spec, frame at a time.

    Owns all integer and DSP state that influences encoding decisions:
    filterbank buffers, MDCT overlap, VBR history, padding accumulator, and
    integer mirrors of the reservoir (the byte stream itself lives in the
    FrameAssembler; the mirrors track its length exactly).
    """

    def __init__(self, options: MP3EncoderOptions):
        self.options = options
        ch = options.channels
        self.fb_buffers = [np.zeros(512, dtype=np.float32) for _ in range(ch)]
        self.overlap = [np.zeros((SUBBANDS, 18), dtype=np.float32) for _ in range(ch)]
        self.vbr = ref.VBRState()
        self.padding_remainder = 0
        self.stream_len = 0
        # strict-entropy walk respec (round 3): the budget runs in the
        # PRICED (t15+delta) world whose stream mirror is est_stream_len /
        # available_bytes, while stream_len mirrors the REAL byte stream
        # (mdb). In compat mode priced == actual and est_stream_len just
        # shadows stream_len.
        self.est_stream_len = 0
        self.available_bytes = 0
        # Buffered-slot FIFO (options.reservoir_depth): slot sizes of the
        # K frames encoded but not yet emitted, oldest first; zeros while
        # the fifo fills (a zero splices nothing, so the fill phase needs
        # no has_buffered conditional). K=1 is the reference's one-frame
        # delay; the depth-general budget/mdb/stuffing law below is
        # byte-identical to the historical one-frame law at K=1 (the
        # equivalence is stream_len' == huffman_bytes - mdb; see
        # ARCHITECTURE.md "Reservoir depth").
        self.slot_fifo = [0] * options.reservoir_depth
        # window_sequencing: was the previously emitted granule SHORT?
        # (the first granule of a frame needs it to place a STOP window)
        self.seq_prev_short = False
        self.seq_prev_want = False
        # onset chain context: per-channel last-two 96-block energies of
        # the previously encoded granule (None = unknown past — blocks
        # without a baseline cannot fire; see reference._onset_fires)
        self.onset_prev2 = None

    def encode_frames(
        self,
        frames: np.ndarray,
        is_final: np.ndarray,
        lookahead: Optional[np.ndarray] = None,
    ) -> List[FrameResult]:
        return [
            self._encode_frame(
                frames[i],
                bool(is_final[i]),
                None if lookahead is None else lookahead[i],
            )
            for i in range(len(frames))
        ]

    def notify_flush(self) -> None:
        """Mirror the assembler's flush_buffered emission (drains every
        buffered frame, oldest first)."""
        for s in self.slot_fifo:
            self.stream_len = max(self.stream_len - s, 0)
            self.est_stream_len = max(self.est_stream_len - s, 0)
        self.slot_fifo = [0] * len(self.slot_fifo)

    def state_dict(self) -> dict:
        return {
            "fb_buffers": [b.copy() for b in self.fb_buffers],
            "overlap": [o.copy() for o in self.overlap],
            "vbr_gain_history": list(self.vbr.gain_history),
            "vbr_energy_history": [float(e) for e in self.vbr.energy_history],
            "padding_remainder": self.padding_remainder,
            "stream_len": self.stream_len,
            "est_stream_len": self.est_stream_len,
            "available_bytes": self.available_bytes,
            "slot_fifo": list(self.slot_fifo),
            "seq_prev_short": self.seq_prev_short,
            "seq_prev_want": self.seq_prev_want,
            "onset_prev2": (
                None
                if self.onset_prev2 is None
                else [np.asarray(e, np.float32).copy() for e in self.onset_prev2]
            ),
        }

    def load_state_dict(self, state: dict) -> None:
        self.fb_buffers = [np.asarray(b, dtype=np.float32).copy() for b in state["fb_buffers"]]
        self.overlap = [np.asarray(o, dtype=np.float32).copy() for o in state["overlap"]]
        self.vbr = ref.VBRState()
        self.vbr.gain_history = list(state["vbr_gain_history"])
        self.vbr.energy_history = [np.float32(e) for e in state["vbr_energy_history"]]
        self.padding_remainder = int(state["padding_remainder"])
        self.stream_len = int(state["stream_len"])
        self.est_stream_len = int(state.get("est_stream_len", state["stream_len"]))
        self.available_bytes = int(state["available_bytes"])
        if "slot_fifo" in state:
            fifo = [int(x) for x in state["slot_fifo"]]
        else:
            # pre-depth checkpoint: one buffered frame at most
            fifo = [int(state["prev_slot"]) if state.get("has_buffered") else 0]
        K = self.options.reservoir_depth
        # depth mismatch: keep the newest entries, zero-pad the (older) front
        self.slot_fifo = ([0] * K + fifo)[-K:]
        self.seq_prev_short = bool(state.get("seq_prev_short", False))
        self.seq_prev_want = bool(state.get("seq_prev_want", False))
        op2 = state.get("onset_prev2")
        self.onset_prev2 = (
            None if op2 is None else [np.asarray(e, np.float32) for e in op2]
        )

    def _encode_frame(
        self,
        samples: np.ndarray,
        is_final: bool,
        lookahead: Optional[np.ndarray] = None,
    ) -> FrameResult:
        opts = self.options
        channels = opts.channels
        sr = opts.sample_rate
        lsf = opts.lsf  # 0 MPEG-1, 1 MPEG-2, 2 MPEG-2.5 (ISO 13818-3)
        n_gr = opts.n_granules  # 2 (MPEG-1) or 1 (LSF)
        res_cap = opts.reservoir_cap  # 511 (9-bit mdb) or 255 (LSF, 8-bit)

        energy = ref.frame_energy(samples)
        if lsf:
            side_size = 9 if channels == 1 else 17
        else:
            side_size = 17 if channels == 1 else 32
        crc_size = 2 if opts.crc_protected else 0

        def _apply_bitrate(tgt):
            """Commit to a bitrate: index/value + Bresenham padding (the
            accumulator mutates exactly once per frame)."""
            if opts.free_format:
                # ISO 2.4.2.3 free format: header index 0, the exact
                # (possibly off-table) rate drives the constant frame size
                bi, bv = 0, tgt
            else:
                bi = bitrate_index(tgt, sr)
                bv = bitrate_value_lsf(bi) if lsf else bitrate_value(bi)
            # LSF frames carry ONE 576-sample granule: 72 slots per kbps
            numerator = (72 if lsf else 144) * bv * 1000
            base_size = numerator // sr
            self.padding_remainder += numerator % sr
            p = 0
            if self.padding_remainder >= sr:
                self.padding_remainder -= sr
                p = 1
            return bi, bv, base_size + p, p

        if opts.vbr and not opts.vbr_demand:
            target = self.vbr.choose_bitrate(opts.bitrate_kbps, energy, opts.quality)
        elif not opts.vbr:
            target = opts.bitrate_kbps
        else:
            target = None  # vbr_demand: chosen from priced demand below
        if target is not None:
            br_idx, br_val, frame_size, pad = _apply_bitrate(target)
            main_data_size = frame_size - 4 - crc_size - side_size

        aligned = opts.reservoir_mode == "aligned"
        res_bits = 0 if is_final else self.available_bytes * 8
        usable = (res_bits * 9) // 10
        strict = opts.spec_strict_entropy
        if aligned:
            # Depth-general expressibility cap: a frame's data can only be
            # placed in the sum of the still-buffered slots (the physical
            # reach of a K-frame emission delay), and never deeper than
            # main_data_begin's 9-bit field (511 bytes). At K=1 this is the
            # historical (prev_slot - leftover) cap — the extra min(.,511)
            # never binds there because the 90% draw rule already caps
            # usable at 0.9*511 bytes. Strict mode budgets in the priced
            # world (walk respec).
            budget_sl = self.est_stream_len if strict else self.stream_len
            gap_budget = sum(self.slot_fifo) - budget_sl
            usable = min(usable, max(min(gap_budget, res_cap), 0) * 8)
            mdb = None  # computed after the frame's byte count is known
        else:
            mdb = 0 if is_final else min(self.stream_len, res_cap)
        if target is not None:
            total_bits = main_data_size * 8 + usable
            bits_per_granule = total_bits // (n_gr * channels)

        frame_mode_ext = None  # per-frame header override (iso_mode_ext)
        # Deinterleave + per-frame stereo decision
        if channels == 1:
            chans = [np.asarray(samples, dtype=np.float32)]
        else:
            s = np.asarray(samples, dtype=np.float32)
            left, right = s[0::2].copy(), s[1::2].copy()
            use_ms, c0, c1 = ref.stereo_decide(
                opts.mode.value, left, right, iso_matrix=opts.iso_ms_matrix,
                symmetric=opts.ms_symmetric,
            )
            chans = [c0, c1]
            if opts.iso_mode_ext and opts.mode.value == "joint_stereo":
                # per-frame header mode_extension from the actual decision
                frame_mode_ext = 0b10 if use_ms else 0b00

        seq_blocks = None
        if opts.window_sequencing:
            # ISO window sequencing (one-granule lookahead provided by the
            # session's encoder delay): shared-across-channels detection on
            # the raw pre-matrix PCM; the granule before an attack becomes
            # a START window, the one after a STOP, restoring TDAC at both
            # junctions (direct long<->short jumps cost ~74 dB of
            # quantization-independent reconstruction ceiling — measured).
            raw = np.asarray(samples, dtype=np.float32)
            gsz = SAMPLES_PER_GRANULE * channels

            def _granule_channels(buf, j):
                seg = buf[j * gsz : (j + 1) * gsz]
                if channels == 1:
                    return [seg]
                return [seg[0::2], seg[1::2]]

            # onset chain context (round 4): each granule's onset detector
            # sees the PREVIOUS granule's last-two block energies, so an
            # attack landing in a granule's first blocks over a quiet
            # predecessor still fires (see reference._onset_fires).
            p2 = self.onset_prev2
            wants = []
            for j in range(n_gr):
                chs = _granule_channels(raw, j)
                wants.append(ref.wants_short(chs, p2))
                p2 = ref.onset_tail_energies(chs)
            if lookahead is None or is_final:
                # flush: trailing zeros never attack. The is_final arm
                # matters for the DROP criterion: the final frame's
                # lookahead row is the flush's zero pad, and a stream
                # ending on loud content would otherwise fire a drop into
                # synthetic silence and end on a pointless START (device
                # twin: want_la & ~final in models/pipeline.py).
                want_next = False
            else:
                la = np.asarray(lookahead, dtype=np.float32)
                want_next = ref.wants_short(_granule_channels(la, 0), p2)
            self.onset_prev2 = p2  # this frame's last granule's tails
            wants_all = wants + [want_next]
            # Post-transient hangover (part of the sequencing law): the
            # effective want is the raw want OR the PREVIOUS granule's raw
            # want, extending every short run one granule past the last
            # detected transient so the STOP window never straddles loud
            # content. A STOP granule's long-layout MDCT covers the
            # previous granule too; placing it right after the attack ties
            # its quantization noise floor to the LOUD half and spreads
            # that noise over the quiet half (post-echo) — the measured
            # dominant burst NMR source (tools/diag_err_sources.py: STOP
            # granules alone carried +10.6 of the +11.6 dB hq-vs-lame gap
            # at 128k; the hangover wins -5.8/-8.1/-7.7 dB NMR at
            # 64/128/256k through mpg123 and is a byte no-op on
            # non-transient content). Device twin: dsp.sequence_blocks_chunk.
            # n_gr-general recurrence (byte-identical to the historical
            # two-granule unroll at n_gr=2; LSF frames carry one granule).
            seq_blocks = []
            prev_short, prev_want = self.seq_prev_short, self.seq_prev_want
            for j in range(n_gr):
                w_cur = wants_all[j] or prev_want
                w_next = wants_all[j + 1] or wants_all[j]
                bt = ref.sequence_block_type(w_cur, prev_short, w_next)
                seq_blocks.append(bt)
                prev_short = bt == ref.BLOCK_SHORT
                prev_want = wants_all[j]
            self.seq_prev_short, self.seq_prev_want = prev_short, prev_want
            seq_blocks = tuple(seq_blocks)

        shared_blocks = None
        if (
            opts.shared_ms_blocks
            and channels == 2
            and seq_blocks is None
            and use_ms
        ):
            # M/S frames must carry ONE window layout across both channels
            # (options.shared_ms_blocks): detect on the raw pre-matrix L/R
            # (matrixing can cancel a one-channel transient out of mid) and
            # let the more-transient verdict win (LONG < MIXED < SHORT).
            shared_blocks = []
            for gr in range(n_gr):
                sl = slice(gr * SAMPLES_PER_GRANULE, (gr + 1) * SAMPLES_PER_GRANULE)
                bl, _ = ref.transient_detect(left[sl])
                br, _ = ref.transient_detect(right[sl])
                shared_blocks.append(max(bl, br))

        # Intensity-stereo frame gate (options.intensity_stereo): engage on
        # frames whose every granule is LONG-layout (LONG/START/STOP, the
        # long-band position law) or pure SHORT (the per-(band, window)
        # law — round 5; both surfaces and their mixed-layout frames are
        # mpg123-validated in tests/test_intensity.py). Only MIXED
        # granules force the discrete fallback (encode-side mixed IS
        # needs the head law — pinned, not hidden). Detection runs on the
        # raw pre-matrix L/R — the sequencing law already does, and the
        # gate must not depend on the matrix choice it overrides; on
        # transient IS frames both channels must share ONE window layout
        # (the decoder's short-IS contract), so the shared verdict wins.
        # Engaged frames code raw L/R with mode_extension 0b01; others
        # fall back to the iso_mode_ext law above.
        is_frame = False
        if opts.intensity_stereo_active and channels == 2:
            if seq_blocks is not None:
                frame_blocks = list(seq_blocks)
            else:
                frame_blocks = []
                for gr in range(n_gr):
                    sl = slice(
                        gr * SAMPLES_PER_GRANULE, (gr + 1) * SAMPLES_PER_GRANULE
                    )
                    b_l, _ = ref.transient_detect(left[sl])
                    b_r, _ = ref.transient_detect(right[sl])
                    frame_blocks.append(max(b_l, b_r))
            is_frame = all(b != ref.BLOCK_MIXED for b in frame_blocks)
            if is_frame and opts.ms_symmetric and use_ms:
                # Side-dominant frames belong to the symmetric M/S arm,
                # not intensity: anti-correlated content cancels in the
                # L+R sum (the IS correlation gate would reject every
                # band), so gating it into raw L/R only forfeits the
                # measured M/S win (antiphase@32k downmix 14.5 -> 1.5 dB
                # when pre-committed — tools/is_corpus.py). Mid-dominant
                # M/S frames still prefer IS below the rate gate (the
                # measured design). Scale-invariant time-domain test, so
                # the gate stays independent of the matrix it overrides.
                sc = ref.ISO_MS_SCALE if opts.iso_ms_matrix else np.float32(0.5)
                mid_t = ((left + right) * sc).astype(np.float32)
                side_t = ((left - right) * sc).astype(np.float32)
                if ref.frame_energy(mid_t) < ref.frame_energy(side_t) * np.float32(0.4):
                    is_frame = False
            if is_frame:
                chans = [left, right]
                frame_mode_ext = 0b01
                if seq_blocks is None:
                    # all-LONG: per-channel detection is identical to the
                    # shared verdict (max == LONG implies both LONG);
                    # transient frames share the layout across channels
                    shared_blocks = (
                        frame_blocks
                        if any(b != ref.BLOCK_LONG for b in frame_blocks)
                        else None
                    )

        granules = [[None] * channels for _ in range(n_gr)]
        quantized = np.zeros((n_gr * channels, SAMPLES_PER_GRANULE), dtype=np.int32)
        big_values = np.zeros(n_gr * channels, dtype=np.int32)
        total_part_bits = 0  # ACTUAL emitted bits (part2_3_length sum)
        total_priced_bits = 0  # walk-law priced bits (est reservoir world)
        strict_chunks: list = []
        strict_nbits: list = []
        gr0_sfd: dict = {}  # per-channel (sfd, block) of granule 0 for scfsi
        scfsi_bits = [[0, 0, 0, 0] for _ in range(channels)]

        # Stage 1: per-granule DSP + scalefactors + initial gain (advances
        # the sequential filterbank/overlap/scfsi state); walk INPUTS are
        # staged so the budget law can see every granule's demand before
        # the first walk runs (options.demand_budget).
        staged = []
        for gr in range(n_gr):
            for ch in range(channels):
                gsamples = chans[ch][gr * SAMPLES_PER_GRANULE : (gr + 1) * SAMPLES_PER_GRANULE]
                S, self.fb_buffers[ch] = ref.analyze_subbands(gsamples, self.fb_buffers[ch])
                if seq_blocks is not None:
                    # sequenced block types are shared across channels and
                    # window gains are not used (long-layout transitions
                    # carry none; short granules ride scalefactors)
                    block, sb_gain = seq_blocks[gr], [0, 0, 0]
                elif shared_blocks is not None:
                    block, sb_gain = shared_blocks[gr], [0, 0, 0]
                else:
                    block, sb_gain = ref.transient_detect(gsamples)
                if (
                    lsf and block == ref.BLOCK_MIXED
                    and not opts.iso_short_blocks
                ):
                    # LSF mixed blocks need the ISO layout machinery
                    # (6-band head reorder + ns (6,9,9,9) scalefactors,
                    # carried by iso_short_blocks); without it, demote to
                    # SHORT (lame never emits mixed at LSF either)
                    block = ref.BLOCK_SHORT
                if opts.iso_quantization:
                    # unit-gain law: the quantizer applies no per-window
                    # gains, so emit zeros (see pipeline twin)
                    sb_gain = [0, 0, 0]
                spectrum, self.overlap[ch] = ref.mdct_apply(
                    S, self.overlap[ch], block,
                    iso_mixed_alias=opts.iso_short_blocks,
                )
                if opts.lowpass_hz is not None:
                    # subband-granularity lowpass (options.lowpass_hz):
                    # the natural layout is subband-major in every block
                    # kind, so zeroing whole subbands is layout-invariant.
                    # adaptive_lowpass gates it per granule-channel on the
                    # negligible-or-noise-like decision (reference.ALP_*).
                    cut_sb = int(opts.lowpass_hz * 64 // opts.sample_rate)
                    # cut at/above Nyquist (possible at LSF rates under the
                    # hq preset's rate-derived default): nothing to zero.
                    # Non-LONG granules always engage: the sfm law is
                    # calibrated on long-window spectra (the short
                    # scrambled layout misreads it — round-4 regression
                    # when the onset/drop chain made early granules
                    # short), and a transient granule's high band is
                    # attack noise — cutting it IS the static behavior.
                    if cut_sb < 32 and (
                        not opts.adaptive_lowpass
                        or block != ref.BLOCK_LONG
                        or ref.adaptive_lowpass_engage(spectrum, cut_sb)
                    ):
                        spectrum[cut_sb * 18 :] = 0.0
                # Masking thresholds are computed-but-unused in the reference
                # (MP3Encoder.swift:961 vs :734-744); skipped here — no effect
                # on any output. See ops.reference.masking_thresholds.
                # iso_short_blocks: the entropy stream of a switching granule
                # is emitted in the ISO 2.4.3.4.8 reordered order; since
                # quantization is pointwise, the layout/pack operate on the
                # permuted quantized values (stream[j] = natural[perm[j]]).
                perm = None
                if opts.iso_short_blocks and block in (
                    ref.BLOCK_MIXED, ref.BLOCK_SHORT,
                ):
                    perm = (
                        mixed_reorder_src(sr)
                        if block == ref.BLOCK_MIXED
                        else short_reorder_src(sr)
                    )
                staged.append(dict(
                    gr=gr, ch=ch, spectrum=spectrum, block=block,
                    sb_gain=sb_gain, perm=perm,
                    energy=ref.frame_energy(gsamples),
                ))

        # Intensity transform (options.intensity_stereo, between the spectra
        # pass and the scalefactor pass: the left channel's scalefactors and
        # initial gain must see the combined L+R spectrum). The per-band
        # positions stash on the RIGHT channel's staged entry; the emitted
        # slots are written after the rate walk, where the right channel's
        # final zero extent is known (see stage 2).
        if is_frame:
            any_region = False
            for gr in range(n_gr):
                cl, cr2 = staged[gr * channels], staged[gr * channels + 1]
                if cr2["block"] == ref.BLOCK_SHORT:
                    # per-(band, window) law on the natural layout (the
                    # reorder perm applies downstream at the walk input)
                    new_l, new_r, pos_w, b0_w = ref.intensity_encode_short(
                        cl["spectrum"], cr2["spectrum"], sr
                    )
                    cr2["is_pos_w"] = pos_w
                    cr2["is_b0_w"] = b0_w  # [3], None = window unqualified
                    any_region = any_region or any(
                        b is not None for b in b0_w
                    )
                else:
                    # LONG/START/STOP: the long-band law (START/STOP carry
                    # the long scalefactor layout; the decoder applies the
                    # identical long position law to them — validated)
                    new_l, new_r, is_pos, is_b0 = ref.intensity_encode(
                        cl["spectrum"], cr2["spectrum"], sr
                    )
                    cr2["is_pos"] = is_pos
                    cr2["is_b0"] = is_b0  # None = no summed region
                    any_region = any_region or is_b0 is not None
                cl["spectrum"], cr2["spectrum"] = new_l, new_r
            if not any_region:
                # No granule qualified an IS region (decorrelated or
                # anti-phase upper spectrum): the frame gains nothing from
                # intensity signalling, and positions above the right
                # channel's natural zero part would only add decoder-
                # synthesized content the source never had. Emit a plain
                # discrete-stereo frame instead (the channels are already
                # raw L/R — exactly the right coding for decorrelated
                # content; mode_extension 0b00 per the iso_mode_ext law).
                is_frame = False
                frame_mode_ext = 0b00
                for gr in range(n_gr):
                    for key in ("is_pos", "is_b0", "is_pos_w", "is_b0_w"):
                        staged[gr * channels + 1].pop(key, None)

        # Scalefactor + initial-gain pass (staged order == the historical
        # interleaved order, so the VBR history and scfsi bookkeeping see
        # the exact same sequence).
        for c in staged:
            gr, ch, spectrum, block = c["gr"], c["ch"], c["spectrum"], c["block"]
            # START/STOP granules carry the LONG scalefactor/window
            # layout (only the MDCT window differs); the raw block
            # value still reaches the entropy layout, which needs the
            # window-switching 36/576 region split for them.
            sf_block = block if not ref.is_long_layout(block) else ref.BLOCK_LONG
            sfd = None
            sf_write = None
            if opts.real_scalefactors:
                sfd = ref.granule_scalefactors(
                    spectrum, sr, sf_block,
                    psy=opts.psy_scalefactors,
                    iso_short=opts.iso_short_blocks,
                    lsf=bool(lsf),
                )
                sf_write = np.ones(21, dtype=bool)
                if opts.scfsi:
                    if gr == 0:
                        gr0_sfd[ch] = (sfd, block)
                    else:
                        sfd0, block0 = gr0_sfd[ch]
                        scfsi_bits[ch], sf_write = ref.scfsi_decide(
                            sfd0["sf"], sfd["sf"],
                            ref.is_long_layout(block0),
                            ref.is_long_layout(block),
                        )
                gain0 = ref.compute_global_gain_scaled(
                    spectrum, sfd["mag_scale"],
                    target=ref.LINBITS_Q_TARGET if opts.linbits_tables else 15.0,
                )
            else:
                gain0 = ref.compute_global_gain(spectrum, iso=opts.iso_quantization)
            self.vbr.update(gain0, c["energy"])
            part2 = ref.scfsi_part2_bits(sfd, sf_write) if sfd else 0
            if sfd is not None and "is_pos" in c:
                # Price the intensity position slots UP FRONT: the emitted
                # scalefac_compress must cover max(scalefactor, position)
                # per slen group (the post-walk overwrite may grow slen,
                # and actual bits beyond the priced budget overflow the
                # real reservoir mirror — caught by the gap assert). The
                # pad is 7, not the real positions: un-summed bands above
                # the final extent emit the ILLEGAL marker 7 (decoders keep
                # the exact L/R reading there — splitting raw L by a
                # raw-energy position would attenuate genuine left
                # content), and which slots get 7 is only known after the
                # walk. The final compress covers per-slot values <=
                # max(sf, 7), so actual <= priced always.
                pad_sf = np.maximum(np.asarray(sfd["sf"], dtype=np.int64), 7)
                pad_bounds = np.concatenate(
                    [[0], np.cumsum(band_table(sr))]
                ).astype(int)
                part2 = ref.scfsi_part2_bits(
                    ref._long_sfd(pad_sf, pad_bounds), sf_write
                )
            elif sfd is not None and "is_pos_w" in c:
                # short-granule analogue of the max(sf, 7) pad: every
                # (band, window) slot may end up carrying a position or
                # the illegal marker 7 after the walk
                pad_slots = np.maximum(
                    np.asarray(sfd["sf_slots"], dtype=np.int64), 7
                )
                pad_slots[36:] = 0
                fin = ref._finish_slots(pad_slots, 18, 18)
                part2 = ref.scfsi_part2_bits(
                    {**sfd, **fin, "sf_slots": pad_slots}, sf_write
                )
            c.update(sfd=sfd, sf_write=sf_write, gain0=gain0, part2=part2)

        if target is None:
            # Demand-driven VBR (options.vbr_demand; device twin in
            # models/pipeline.py): the smallest bitrate in the reference's
            # quality band whose slot covers the frame's exact priced
            # demand at the quality-mapped walk candidate (k = quality on
            # the sweep's 4-gain grid). Staging is bitrate-independent, so
            # the demand is known before the bitrate commits; the
            # reservoir absorbs the slot-granularity remainder.
            demand = sum(
                ref.strict_demand(
                    c["spectrum"],
                    c["sfd"]["mag_scale"] if c["sfd"] is not None else None,
                    c["gain0"], sr, c["block"],
                    opts.count1_coding, opts.region_table_select,
                    c["part2"], c["perm"], opts.iso_quantization,
                    linbits=opts.linbits_tables, k=opts.quality,
                )
                for c in staged
            )
            # full downward freedom (the point of demand VBR is cheap
            # frames going cheap); the UPPER cap keeps the reference band
            # so main_data_cap and Xing contracts are unchanged
            table = ref.LSF_L3_BITRATES if lsf else ref.MPEG1_L3_BITRATES
            min_b = 8 if lsf else 32
            max_b = min(table[-1], opts.bitrate_kbps + 64 - opts.quality * 4)
            cands = [b for b in table if min_b <= b <= max_b]
            if not cands:  # band above the table top (base at top, high q)
                bi = bitrate_index(max_b, sr)
                cands = [bitrate_value_lsf(bi) if lsf else bitrate_value(bi)]
            target = cands[-1]  # nothing fits: the band's largest value
            for b in cands:
                slot_bits = (
                    ((72 if lsf else 144) * b * 1000) // sr
                    - 4 - crc_size - side_size
                ) * 8
                if slot_bits >= demand:
                    target = b
                    break
            br_idx, br_val, frame_size, pad = _apply_bitrate(target)
            main_data_size = frame_size - 4 - crc_size - side_size
            total_bits = main_data_size * 8 + usable
            bits_per_granule = total_bits // (n_gr * channels)

        # Budget per granule-channel: equal split (reference law), or the
        # demand-donation law (options.demand_budget — demand is the exact
        # priced bits at the K_DEMAND grid probe; device twin in
        # models/pipeline.py).
        budgets = [bits_per_granule] * len(staged)
        if strict and opts.demand_budget:
            demands = [
                ref.strict_demand(
                    c["spectrum"],
                    c["sfd"]["mag_scale"] if c["sfd"] is not None else None,
                    c["gain0"], sr, c["block"],
                    opts.count1_coding, opts.region_table_select,
                    c["part2"], c["perm"], opts.iso_quantization,
                    linbits=opts.linbits_tables,
                )
                for c in staged
            ]
            sum_d = sum(demands)
            if sum_d > 0:
                # Donation law (round 3, replacing the demand-PROPORTIONAL
                # blend tuned in the pre-sequencing era): granules whose
                # probe demand sits UNDER the equal share donate surplus;
                # granules over it split the donations by deficit. Exact
                # no-op when no (surplus, deficit) pair coexists -- steady
                # frames keep the equal split bit-for-bit, so no deadband
                # threshold is needed. Proportional skew measured -3.1 dB
                # at 128k once window_sequencing fixed transient coding
                # (it had been compensating for the TDAC break); donation
                # keeps the +1.2 dB at starving bitrates with zero cost
                # above. Clamped at the 4095-bit part2_3_length field
                # (clamp loss returns to the reservoir, not the frame).
                G = len(staged)
                share = total_bits // G
                sur = [max(share - d, 0) for d in demands]
                defi = [max(d - share, 0) for d in demands]
                pool, sdef = sum(sur), sum(defi)
                take = min(pool, sdef)
                budgets = [
                    min(
                        share
                        - (s * take) // max(pool, 1)
                        + (take * dd) // max(sdef, 1),
                        4095,
                    )
                    for s, dd in zip(sur, defi)
                ]

        # Stage 2: gain walks + entropy layout + side info, per granule.
        # distortion_control frame gate: engage only when EVERY granule in
        # the frame is pure LONG — a frame holding any short/transition
        # granule is in a transient neighborhood where the stationary
        # band-mask law misprices temporal noise (measured: per-granule
        # LONG-only still lost +0.8 dB nburst NMR at 128k from tone-bed
        # granules adjacent to bursts; the all-long gate is a no-op there).
        dc_frame = (
            opts.distortion_control_active
            and not is_frame  # IS positions overwrite bumped slots
            and all(c2["block"] == ref.BLOCK_LONG for c2 in staged)
        )
        for c, granule_budget in zip(staged, budgets):
            gr, ch = c["gr"], c["ch"]
            spectrum, block = c["spectrum"], c["block"]
            sb_gain, perm = c["sb_gain"], c["perm"]
            sfd, sf_write, gain0 = c["sfd"], c["sf_write"], c["gain0"]
            if True:  # (keeps the historical loop-body indentation)
                if strict:
                    # Exact-priced walk (spec: ref.quantize_to_fit_budget_
                    # strict; device twin: dsp.rate_loop_precompute_strict).
                    # `bits` is the PRICED value; the actual emitted bits
                    # come from the final layout below.
                    def _walk(budget_bits):
                        return ref.quantize_to_fit_budget_strict(
                            spectrum,
                            sfd["mag_scale"] if sfd is not None else None,
                            gain0,
                            budget_bits,
                            sr,
                            block,
                            opts.count1_coding,
                            opts.region_table_select,
                            c["part2"],
                            perm,
                            opts.iso_quantization,
                            linbits=opts.linbits_tables,
                        )

                    if dc_frame and sfd is not None:
                        # One-shot distortion control (ops/reference.
                        # distortion_bumps): a PROBE walk at the
                        # state-free equal-share budget (slot bits only —
                        # no reservoir draw, no donation; budget-
                        # independent, so the device twin computes it as
                        # a vectorized select over the already-priced
                        # candidate table before the budget scan runs)
                        # measures each band's actual error against the
                        # spread-mask target; violating bands' scale-
                        # factors bump once, and the REAL walk below runs
                        # with the bumped magnitudes at the normal budget.
                        # The single est-reservoir world then tracks the
                        # real walk's priced bits exactly as without the
                        # flag (an earlier selected-walk re-walk
                        # formulation either desynced the est world or,
                        # budget-capped, lost the measured win — see the
                        # flag's sweep history in options.py).
                        # STATIC probe budget (base-rate slot, no padding):
                        # under eVBR the per-frame bitrate is scan state on
                        # the device, so the probe must not depend on it.
                        base_main = (
                            ((72 if lsf else 144) * opts.bitrate_kbps * 1000)
                            // sr - 4 - crc_size - side_size
                        )
                        probe_budget = min(
                            (base_main * 8) // (n_gr * channels), 4095
                        )
                        # options.dc_passes probe->bump iterations (1 ==
                        # the historical one-shot) — each extra pass
                        # re-probes at the same static budget with the
                        # bumped magnitudes and bumps the still-violating
                        # bands again, then ONE real walk runs below.
                        for _dc_pass in range(opts.dc_passes):
                            g1, q1, _ = _walk(probe_budget)
                            bumps = ref.distortion_bumps(
                                spectrum, q1, g1, sfd["sf"], sr,
                                proportional=opts.dc_proportional,
                            )
                            if not bumps.any():
                                break
                            sf2 = np.minimum(
                                sfd["sf"] + bumps, ref._DC_SF_CAP
                            )
                            bounds = np.concatenate(
                                [[0], np.cumsum(band_table(sr))]
                            ).astype(int)
                            sfd = ref._long_sfd(sf2, bounds)
                            c["sfd"] = sfd
                            c["part2"] = ref.scfsi_part2_bits(sfd, sf_write)
                            gain0 = ref.compute_global_gain_scaled(
                                spectrum, sfd["mag_scale"],
                                target=ref.LINBITS_Q_TARGET,
                            )
                    gain, q, bits = _walk(granule_budget)
                    priced_bits = bits
                    if is_frame and ch == 1 and "is_pos_w" in c:
                        # Short-granule position slots (per-window twin of
                        # the long law below): window w's decoded IS
                        # region is everything at/above ITS OWN zero
                        # part, so every (band, window) slot at/above the
                        # window's final quantized extent carries a
                        # position — real on SUMMED windows' bands (>=
                        # b0_w), the illegal marker 7 elsewhere. The
                        # per-window tail (lines above sb[11]) rides band
                        # 11's position; an extent inside (sb[11], 192]
                        # can't express both band 11's scalefactor and
                        # the tail's position — zero the band-11
                        # remainder in that window. q is NATURAL order
                        # here (the perm applies at the entropy layout).
                        from .tables import short_band_bounds

                        sbb = short_band_bounds(sr)  # [0, b1..b12, 192]
                        q = q.copy()
                        sf_slots2 = np.asarray(
                            sfd["sf_slots"], dtype=np.int64
                        ).copy()
                        changed = False
                        for w in range(3):
                            qw = q[w::3]
                            nzw = np.nonzero(qw)[0]
                            rzw = int(nzw[-1]) + 1 if nzw.size else 0
                            if int(sbb[11]) < rzw <= 192:
                                qw = qw.copy()
                                qw[int(sbb[11]):] = 0
                                q[w::3] = qw
                                nzw = np.nonzero(qw)[0]
                                rzw = int(nzw[-1]) + 1 if nzw.size else 0
                            b_start = int(
                                np.searchsorted(
                                    sbb[:12], rzw, side="left"
                                )
                            )
                            if b_start >= 12:
                                continue
                            emit = np.full(12, 7, dtype=np.int64)
                            b0 = c["is_b0_w"][w]
                            if b0 is not None:
                                emit[b0:] = c["is_pos_w"][b0:, w]
                            for s in range(b_start, 12):
                                if sf_slots2[3 * s + w] != emit[s]:
                                    sf_slots2[3 * s + w] = emit[s]
                                    changed = True
                        if sfd is not None and changed:
                            fin = ref._finish_slots(sf_slots2, 18, 18)
                            sfd = {
                                **sfd,
                                **fin,
                                "sf_slots": sf_slots2,
                            }
                            c["sfd"] = sfd
                    elif is_frame and ch == 1:
                        # Intensity position slots (the decode-law
                        # invariant, see reference.intensity_encode):
                        # every band at/above the right channel's FINAL
                        # quantized extent carries a position — including
                        # bands the walk zeroed below the intended bound.
                        # Knife-edge extents inside (bounds[20],
                        # bounds[21]] would need slot 20 to be both band
                        # 20's real scalefactor and the sfb21 tail's
                        # position; zero the band-20 remainder there (the
                        # tail is already zero in that window).
                        is_bounds = np.concatenate(
                            [[0], np.cumsum(band_table(sr))]
                        ).astype(int)
                        nzq = np.nonzero(q)[0]
                        z_ext = int(nzq[-1]) + 1 if nzq.size else 0
                        if is_bounds[20] < z_ext <= is_bounds[21]:
                            q = q.copy()
                            q[is_bounds[20]:] = 0
                            nzq = np.nonzero(q)[0]
                            z_ext = int(nzq[-1]) + 1 if nzq.size else 0
                        b_start = int(
                            np.searchsorted(is_bounds[:21], z_ext, side="left")
                        )
                        if sfd is not None and b_start < 21:
                            # Bands the encoder actually SUMMED (>= the
                            # granule's is_b0) carry real positions; bands
                            # above the extent that were never summed — a
                            # no-region granule, or walk-zeroed bands below
                            # b0 — carry the ILLEGAL marker 7, keeping the
                            # decoder's exact L/R reading there (the left
                            # spectrum holds raw L, not L+R; a raw-energy
                            # position would split it spuriously).
                            sf_is = np.asarray(
                                sfd["sf"], dtype=np.int64
                            ).copy()
                            emit = np.full(21, 7, dtype=np.int64)
                            if c.get("is_b0") is not None:
                                emit[c["is_b0"]:] = c["is_pos"][c["is_b0"]:]
                            sf_is[b_start:] = emit[b_start:]
                            if not np.array_equal(sf_is, sfd["sf"]):
                                sfd = ref._long_sfd(sf_is, is_bounds)
                                c["sfd"] = sfd
                else:
                    gain, q, bits = ref.quantize_to_fit_budget(
                        spectrum,
                        gain0,
                        granule_budget,
                        iso=opts.iso_quantization,
                    )
                    priced_bits = bits
                if opts.iso_quantization:
                    # unit-gain law applies no pre-emphasis; emitting
                    # preflag=1 would make ISO decoders attenuate top bands
                    preflag = False
                else:
                    preflag = ref.pre_emphasis(spectrum, np.ones(576, dtype=np.float32))
                scfc = 0
                if strict:
                    layout = ref.strict_entropy_layout(
                        q if perm is None else q[perm],
                        sr, block, opts.count1_coding, opts.region_table_select,
                        linbits=opts.linbits_tables,
                    )
                    # walk respec: `bits` is the PRICED value (budget law);
                    # part2_3_length and the real reservoir use the ACTUAL
                    # layout bits of the selected quantization
                    part2_bits = ref.scfsi_part2_bits(sfd, sf_write) if sfd else 0
                    actual_bits = part2_bits + layout["part23_bits"]
                    bv = layout["big_values"]
                    r0, r1 = layout["region0"], layout["region1"]
                    tsel = layout["table_select"]
                    c1t = layout["count1table_select"]
                    if sfd is not None:
                        scfc = sfd["compress"]
                        sf_chunks, sf_nbits = ref.scalefactor_chunks_masked(
                            sfd, sf_write
                        )
                        strict_chunks.append(sf_chunks)
                        strict_nbits.append(sf_nbits)
                    strict_chunks.append(layout["chunks"])
                    strict_nbits.append(layout["nbits"])
                else:
                    bv = ref.big_values_of(q)
                    r0, r1 = ref.region_counts(bv, sr)
                    tsel = (15, 15, 15)
                    c1t = 0
                    actual_bits = bits  # compat: the walk law IS the bits

                g = gr * channels + ch
                quantized[g] = q
                big_values[g] = bv
                total_part_bits += actual_bits
                total_priced_bits += priced_bits
                granules[gr][ch] = GranuleInfo(
                    part23_length=actual_bits,
                    big_values=bv,
                    global_gain=gain,
                    scalefac_compress=scfc,
                    window_switching=0 if block == ref.BLOCK_LONG else 1,
                    # The reference emits its internal enum raw, so mixed
                    # granules signal block_type=1 — ISO "start", making
                    # conforming decoders run the long IMDCT over short
                    # subbands. iso_short_blocks emits the ISO encoding:
                    # block_type=2 + mixed_block_flag. window_sequencing's
                    # transition granules map to the ISO header values
                    # (START->1, STOP->3).
                    block_type=(
                        1
                        if block == ref.BLOCK_START
                        else 3
                        if block == ref.BLOCK_STOP
                        else 2
                        if (opts.iso_short_blocks and block == ref.BLOCK_MIXED)
                        else block
                    ),
                    mixed_block_flag=1 if block == ref.BLOCK_MIXED else 0,
                    table_select=tsel,
                    subblock_gain=tuple(sb_gain),
                    region0_count=r0,
                    region1_count=r1,
                    preflag=1 if preflag else 0,
                    # 1 iff real_scalefactors (see pipeline.fetch_outputs)
                    scalefac_scale=1 if opts.real_scalefactors else 0,
                    count1table_select=c1t,
                )

        huffman_bytes = (total_part_bits + 7) // 8
        est_hb = (total_priced_bits + 7) // 8  # == huffman_bytes in compat
        oldest = self.slot_fifo[0]  # slot spliced this frame (0 while filling)
        if aligned:
            # Depth-general placement law: the frame's data is tail-aligned
            # against its own header within the expressible gap (sum of
            # buffered slots minus the unslotted leftover), never deeper
            # than 511; the assembler prepends (gap - mdb) stuffing zeros
            # at APPEND time, so emission is a pure slot-sized pop. The
            # mirror update stream_len += stuffing + data - oldest_slot is
            # exactly the historical max(sl + hb - prev, hb - 511, 0) at
            # K=1 (stream_len' == hb - mdb there).
            gap_real = sum(self.slot_fifo) - self.stream_len
            gap_est = sum(self.slot_fifo) - self.est_stream_len
            assert gap_real >= 0 and gap_est >= 0, (gap_real, gap_est)
            if opts.reservoir_depth > 1:
                # FRONT-aligned placement (depth > 1): data starts at the
                # full expressible gap (contiguous after the previous
                # frame's data; stuffing only beyond the 511-byte mdb
                # horizon), so banked space SURVIVES within the buffered
                # window. Tail-alignment (the K=1 law below) re-stuffs the
                # gap every frame — measured: the reservoir counter grew
                # to 400+ bytes while the physical reach stayed pinned at
                # one slot, making depth a byte no-op. Unused space still
                # expires as end-padding when its slot emits (the floor).
                mdb = max(0, min(gap_real, res_cap))
                est_mdb = max(0, min(gap_est, res_cap))
            else:
                # tail-aligned (historical byte-exact K=1 law): data ends
                # flush against its own header
                mdb = max(0, min(gap_real, huffman_bytes, res_cap))
                est_mdb = max(0, min(gap_est, est_hb, res_cap))
            self.stream_len = max(
                self.stream_len + (gap_real - mdb) + huffman_bytes - oldest, 0
            )
            self.est_stream_len = max(
                self.est_stream_len + (gap_est - est_mdb) + est_hb - oldest, 0
            )
        else:
            self.stream_len = max(self.stream_len + huffman_bytes - oldest, 0)
            self.est_stream_len = max(self.est_stream_len + est_hb - oldest, 0)
        self.available_bytes = min(
            max(self.available_bytes + main_data_size - est_hb, 0), res_cap
        )
        self.slot_fifo = self.slot_fifo[1:] + [main_data_size]
        return FrameResult(
            bitrate_index=br_idx,
            padding=pad,
            main_data_begin=mdb,
            slot_size=main_data_size,
            granules=granules,
            quantized=quantized,
            big_values=big_values,
            chunks=np.concatenate(strict_chunks) if strict else None,
            nbits=np.concatenate(strict_nbits) if strict else None,
            scfsi=scfsi_bits if opts.scfsi else None,
            mode_ext=frame_mode_ext,
        )



class EncoderSession:
    """Mutable per-stream encoding state (MP3Encoder.swift:237-350)."""

    def __init__(self, options: MP3EncoderOptions, backend):
        self.options = options
        self.assembler = FrameAssembler(options)
        self.backend = backend
        # window_sequencing: one granule of encoder delay (the START
        # decision needs one granule of lookahead) — the stream starts
        # with 576 samples of silence, like every lookahead encoder.
        self._la_n = (
            SAMPLES_PER_GRANULE * options.channels
            if options.window_sequencing
            else 0
        )
        self._pcm = np.zeros(self._la_n, dtype=np.float32)
        self._fed = False  # any real PCM received (empty flush stays empty)
        self._fed_samples = 0  # interleaved samples received (gapless_info)

    @property
    def encoded_frame_count(self) -> int:
        return self.assembler.frame_count

    @property
    def encoded_byte_count(self) -> int:
        return self.assembler.total_bytes

    def encode(self, samples) -> bytes:
        """Buffer interleaved PCM and encode all complete frames (1152
        samples each for MPEG-1; 576 at LSF rates — one granule per frame).

        Accepts float PCM in [-1, 1] or int16 PCM (normalized by 1/32768).
        Non-finite samples are zeroed (the reference would trap on them;
        a deterministic stream is strictly more useful)."""
        arr = np.asarray(samples)
        if arr.dtype == np.int16:
            samples = arr.astype(np.float32).reshape(-1) / np.float32(32768.0)
        else:
            samples = arr.astype(np.float32).reshape(-1)
        if not np.isfinite(samples).all():
            samples = np.nan_to_num(samples, nan=0.0, posinf=0.0, neginf=0.0)
        if samples.size:
            self._fed = True
            self._fed_samples += int(samples.size)
        self._pcm = np.concatenate([self._pcm, samples]) if self._pcm.size else samples
        n = self.options.samples_per_frame * self.options.channels
        # with window_sequencing, a frame is emitted only once its
        # lookahead granule has arrived (encode_frames needs it)
        n_frames = max(len(self._pcm) - self._la_n, 0) // n
        if n_frames == 0:
            return b""
        frames = self._pcm[: n_frames * n].reshape(n_frames, n)
        lookahead = None
        if self._la_n:
            lookahead = np.stack(
                [
                    self._pcm[(i + 1) * n : (i + 1) * n + self._la_n]
                    for i in range(n_frames)
                ]
            )
        self._pcm = self._pcm[n_frames * n :]
        results = self.backend.encode_frames(
            frames, np.zeros(n_frames, dtype=bool), lookahead=lookahead
        )
        out = bytearray()
        for fr in results:
            out += self.assembler.push(fr)
        return bytes(out)

    def flush(self) -> bytes:
        """Encode any partial frame (zero-padded, reservoir borrowing off) and
        emit the delayed buffered frame."""
        out = bytearray()
        n = self.options.samples_per_frame * self.options.channels
        if self._la_n and not self._fed:
            # nothing was ever encoded; don't emit the delay preroll alone
            self._pcm = np.zeros(0, dtype=np.float32)
        if self._fed and self.options.gapless_info:
            # gapless_info: cover the tail. The pipeline's structural
            # 528-sample encoder delay means the last input samples live in
            # a frame flush would otherwise never emit; appending
            # delay + 529 zeros puts every real sample inside an emitted
            # frame AND leaves >= 529 samples of padding so gapless players
            # can trim the decoder's own synthesis delay at the end
            # (padding fields: generate_xing_header).
            tail = (GAPLESS_ENCODER_DELAY + GAPLESS_DECODER_DELAY) * self.options.channels
            self._pcm = np.concatenate(
                [self._pcm, np.zeros(tail, dtype=np.float32)]
            )
        if self._pcm.size:
            # with window_sequencing the held-back delay tail can span two
            # frames; the final frame's lookahead is silence
            k = (len(self._pcm) + n - 1) // n
            buf = np.zeros(k * n, dtype=np.float32)
            buf[: len(self._pcm)] = self._pcm
            self._pcm = np.zeros(0, dtype=np.float32)
            frames = buf.reshape(k, n)
            lookahead = None
            if self._la_n:
                lookahead = np.zeros((k, self._la_n), dtype=np.float32)
                for i in range(k - 1):
                    lookahead[i] = frames[i + 1][: self._la_n]
            is_final = np.zeros(k, dtype=bool)
            is_final[-1] = True
            results = self.backend.encode_frames(
                frames, is_final, lookahead=lookahead
            )
            for fr in results:
                out += self.assembler.push(fr)
        out += self.assembler.flush_buffered()
        self.backend.notify_flush()
        return bytes(out)

    # --- Checkpoint / resume -------------------------------------------------
    # The reference's closest analogue is that copying the session value type
    # snapshots all state (SURVEY.md §5). Here the state is explicit: the
    # backend's carry + the assembler's byte-level state. The layout is the
    # JAX session's, so checkpoints cross between the two packages.

    def state_dict(self) -> dict:
        """Snapshot all session state as plain numpy arrays / bytes."""
        a = self.assembler
        state = {
            "pcm": self._pcm.copy(),
            "fed": self._fed,
            "fed_samples": self._fed_samples,
            "reservoir_stream": bytes(a.reservoir.stream),
            "reservoir_avail": a.reservoir.available_bytes,
            "buffered_heads": [h for h, _ in a._buffered],
            "buffered_slots": [s for _, s in a._buffered],
            "frame_count": a.frame_count,
            "total_bytes": a.total_bytes,
            "frame_sizes": list(a.frame_sizes),
            "backend": self.backend.state_dict(),
        }
        return state

    def load_state_dict(self, state: dict) -> None:
        a = self.assembler
        self._pcm = np.asarray(state["pcm"], dtype=np.float32).copy()
        self._fed = bool(state.get("fed", True))
        self._fed_samples = int(state.get("fed_samples", 0))
        a.reservoir.stream = bytearray(state["reservoir_stream"])
        a.reservoir.available_bytes = int(state["reservoir_avail"])
        if "buffered_heads" in state:
            a._buffered = [
                (bytes(h), int(s))
                for h, s in zip(state["buffered_heads"], state["buffered_slots"])
            ]
        elif int(state.get("buffered_slot", -1)) >= 0:  # pre-depth checkpoint
            a._buffered = [
                (bytes(state["buffered_head"]), int(state["buffered_slot"]))
            ]
        else:
            a._buffered = []
        a.frame_count = int(state["frame_count"])
        a.total_bytes = int(state["total_bytes"])
        a.frame_sizes = list(state["frame_sizes"])
        self.backend.load_state_dict(state["backend"])

    def generate_id3_tag(self) -> bytes:
        if self.options.id3_tag is None:
            return b""
        return build_id3_tag(self.options.id3_tag)

    def generate_xing_header(self) -> bytes:
        gapless = None
        if self.options.gapless_info:
            delay = GAPLESS_ENCODER_DELAY + (
                SAMPLES_PER_GRANULE if self._la_n else 0
            )
            per_ch = self._fed_samples // self.options.channels
            padding = (
                self.assembler.frame_count * self.options.samples_per_frame
                - delay
                - per_ch
            )
            gapless = (delay, max(padding, 0))
        return build_xing_header(
            self.options,
            self.assembler.frame_count,
            self.assembler.total_bytes,
            self.assembler.frame_sizes,
            gapless=gapless,
        )

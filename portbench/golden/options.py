"""Public configuration types: MP3EncoderOptions, Mode, ID3Tag.

API parity with the reference public surface (MP3Encoder.swift:8-116):
same fields, same defaults, same clamping behavior (quality clamped to 0-9,
out-of-range bitrates/sample rates silently coerced downstream).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional


class Mode(str, enum.Enum):
    """Channel mode (MP3Encoder.swift:59-63)."""

    MONO = "mono"
    STEREO = "stereo"
    JOINT_STEREO = "joint_stereo"

    @property
    def channels(self) -> int:
        return 1 if self is Mode.MONO else 2


@dataclass(frozen=True)
class ID3Tag:
    """ID3v2.3 metadata (MP3Encoder.swift:8-54)."""

    title: Optional[str] = None
    artist: Optional[str] = None
    album: Optional[str] = None
    track: Optional[int] = None
    track_total: Optional[int] = None
    year: Optional[int] = None
    genre: Optional[str] = None
    comment: Optional[str] = None
    album_art: Optional[bytes] = None
    album_art_mime_type: str = "image/jpeg"


@dataclass(frozen=True)
class MP3EncoderOptions:
    """Encoder configuration (MP3Encoder.swift:57-116).

    Defaults match the reference: 44100 Hz, 128 kbps, CBR, stereo, quality 5,
    no CRC, original=True, copyright=False, no ID3 tag.
    """

    sample_rate: int = 44100
    bitrate_kbps: int = 128
    vbr: bool = False
    mode: Mode = Mode.STEREO
    quality: int = 5
    crc_protected: bool = False
    original: bool = True
    copyright: bool = False
    id3_tag: Optional[ID3Tag] = None
    # Bit-reservoir placement:
    #   "compat"  — byte-for-byte reference behavior. QUIRK: the reference's
    #     one-frame delay zero-pads underfull slots at the END and snapshots
    #     main_data_begin BEFORE appending the frame's data, so ISO decoders
    #     read each frame's side info against the NEXT frame's Huffman data
    #     whenever slots underfill (verified against the decoder oracle:
    #     sine SNR collapses from ~20 dB to ~4 dB).
    #   "aligned" — same budgets and bit counts, but slots pad at the FRONT
    #     and main_data_begin is snapshotted after append, which places
    #     main_data exactly where ISO 11172-3 decoders look for it.
    reservoir_mode: str = "compat"
    # reservoir_depth: frames of BITSTREAM emission delay (aligned mode).
    #   The default 1 is the reference's one-frame delay, which physically
    #   caps a frame's main_data back-reach at ONE slot (a frame's bytes
    #   can only be placed in slots not yet emitted when it is encoded) —
    #   at 64 kbps that is ~188 bytes of the 511-byte main_data_begin
    #   reach, so a transient frame can spend at most ~2x its slot no
    #   matter how much the reservoir banked. depth=K buffers K frames
    #   before emitting, extending the reach to min(511, K slots) — the
    #   full ISO reservoir at depth ceil(511/slot). Adds (K-1) frames of
    #   encoder OUTPUT latency (~26 ms each at 44.1 kHz); PCM timing,
    #   frame count, Xing, and gapless info are unaffected. Requires
    #   reservoir_mode="aligned" for K>1 (the compat quirk's placement is
    #   frozen reference behavior). The budget/mdb/stuffing law is the
    #   depth-general form (see ARCHITECTURE.md "Reservoir depth"); K=1
    #   streams are byte-identical to the historical one-frame law.
    reservoir_depth: int = 1
    # vbr_demand: demand-driven VBR (requires vbr=True + the strict
    #   entropy layout). The reference's VBR law wobbles the bitrate by a
    #   frame-energy ratio against a rolling average
    #   (MP3Encoder.swift:1144-1180) — energy is a poor proxy for coding
    #   cost (a loud pure tone is cheap, quiet broadband noise is
    #   expensive). This law instead picks, per frame, the SMALLEST
    #   bitrate whose slot covers the frame's exact priced demand at the
    #   quality-mapped walk candidate (k = quality on the sweep's 4-gain
    #   grid; 0 = finest = biggest frames), within [32, base+64-4q] —
    #   full downward freedom (the point of demand VBR is cheap frames
    #   going cheap) under the reference VBR law's upper cap, so the
    #   Xing/main_data_cap contracts are unchanged. The demand signal is
    #   the same priced grid the rate sweep already computes — free on
    #   device. The reference-law VBR stays byte-exact with the flag off.
    vbr_demand: bool = False
    # --- Spec-strict flags (all default OFF = byte-exact reference parity).
    # Each is independent, tested against the decoder oracle, and documented
    # in ARCHITECTURE.md "Parity model".
    #
    # iso_quantization: the reference quantizes q = round(|x|^0.75 / step)
    #   with step = 2^((g-210)/4), but ISO decoders reconstruct
    #   xr = q^(4/3) * step — so reference streams decode with a gain error
    #   of step^(1/3) (level depends on gain; quality.py had to
    #   gain-compensate). This flag uses q = round((|x|/step)^(3/4)), making
    #   decode unit-gain.
    iso_quantization: bool = False
    # iso_crc: CRC-16 over header bytes 3-4 + the side info, as ISO 2.4.3.1
    #   specifies; the reference covers only the 4 header bytes
    #   (MP3Encoder.swift:540-543), which real decoders reject as a CRC error.
    iso_crc: bool = False
    # count1_coding: end big_values at the last |v|>1 pair and code the
    #   remaining |v|<=1 tail as count1 quadruples (table A or B, whichever
    #   is smaller); the reference covers the whole spectrum with big_values
    #   pairs (MP3Encoder.swift:692-700), wasting bits on the sparse tail.
    count1_coding: bool = False
    # region_table_select: per-region smallest-table Huffman selection
    #   (0 -> 1 -> 2 -> 5 -> 7 -> 15; tables 10/13 are excluded because the
    #   reference's copies are corrupt — see decoder/tables.py) with
    #   table_select emitted per region; the reference hardcodes table 15
    #   everywhere (MP3Encoder.swift:717).
    region_table_select: bool = False
    # real_scalefactors: per-band peak-normalizing scalefactors with
    #   scalefac_compress emission — the reference's declared-but-dead
    #   ScaleFactorBands.scale/ScaleFactorCompression machinery made real
    #   (law in ops.reference.strict_scalefactors). Long-block granules
    #   only; requires iso_quantization (the amplification must cancel at
    #   unit gain on ISO decoders).
    real_scalefactors: bool = False
    # psy_scalefactors: masking-driven scalefactor allocation instead of
    #   real_scalefactors' peak-share law: band peak exponents are spread
    #   across scalefactor bands with a max-plus skirt (simplified
    #   psychoacoustic masking — the reference computes thresholds but never
    #   uses them, MP3Encoder.swift:961), and each band is amplified by half
    #   its gap to the spread mask. +0.5..+1.5 dB decoder-oracle SNR on
    #   tonal/speech-like signals over the peak-share law, neutral on noise.
    #   Requires real_scalefactors (same emission machinery).
    psy_scalefactors: bool = False
    # scfsi: share equal scalefactor band groups between a frame's two
    #   granules via the four per-channel scfsi side-info bits (ISO 2.4.2.7;
    #   the reference always writes 0s, MP3Encoder.swift:533). Shared groups
    #   retransmit nothing; the saved part2 bits return to the rate budget.
    #   Transparent sharing only (values must already agree). Requires
    #   real_scalefactors.
    scfsi: bool = False
    # iso_short_blocks: full ISO short-block conformance for switching
    #   granules (block_type=2, with or without mixed_block_flag):
    #   - the entropy stream is emitted in the ISO 2.4.3.4.8 reordered
    #     order (short-sfb-major, windows consecutive per band) instead of
    #     the encoder family's subband-major layout — conforming decoders
    #     un-reorder it back to exactly our natural layout;
    #   - real per-(sfb, window) short scalefactors with slen coding
    #     (mixed blocks: 8 long + 9x3 short scalefactors per ISO 2.4.2.7),
    #     using the same peak-exponent law as the long bands;
    #   - mixed granules get the forward aliasing butterfly on the
    #     long-head subband boundary (the one a conforming decoder
    #     inverts; the reference applies none for mixed).
    #   Without this flag, switching granules keep reference behavior
    #   (subband-major stream, scalefac_compress=0). Requires
    #   real_scalefactors (the emission machinery and the scalefac_scale=1
    #   cancellation). The decoder oracle reads reordered streams under
    #   decode_mp3(..., iso_conventions=True).
    iso_short_blocks: bool = False
    # iso_ms_matrix: use the ISO 2.4.3.4.9.2 M/S matrix convention
    #   mid = (L+R)/sqrt(2), side = (L-R)/sqrt(2) instead of the encoder
    #   family's /2 halves (MP3Encoder.swift:2146-2154). A conforming
    #   decoder reconstructs L = (M+S)/sqrt(2), R = (M-S)/sqrt(2), so
    #   reference-law M/S frames play 1/sqrt(2) (-3 dB) quiet — and under
    #   iso_mode_ext the per-frame decision flips would pump +-3 dB. The
    #   ISO matrices are energy-preserving (E[M]+E[S] == E[L]+E[R]), which
    #   the tests use as a spec cross-check that needs no external decoder.
    #   The M/S decision rule (side energy < 0.4 * mid energy) is invariant
    #   to the common scale, so decisions match the reference's.
    iso_ms_matrix: bool = False
    # iso_mode_ext: emit the joint-stereo header mode_extension PER FRAME
    #   from the actual M/S decision (0b10 when mid/side was encoded, 0b00
    #   when left/right won). The reference hardcodes 0b10 on every joint
    #   frame (MP3Encoder.swift:2547-2556), so conforming decoders apply
    #   mid/side reconstruction to frames that actually carry L/R —
    #   garbling the stereo image whenever the per-frame decision flips.
    iso_mode_ext: bool = False
    # ms_symmetric: extend the M/S decision with the symmetric arm — also
    #   choose mid/side when the MID energy is under 0.4 of the side's.
    #   The reference's one-sided test leaves anti-correlated stereo
    #   (side-dominant: out-of-phase mics, Karaoke-style tracks) in
    #   discrete coding, double-coding two near-inverted channels while
    #   the small downmix residual drowns: measured downmix SNR 1.8 dB at
    #   32k vs lame's 7.0. Energy compaction is direction-invariant (the
    #   decoder computes L,R = (M+-S)/sqrt(2) either way); with the
    #   symmetric arm the antiphase corpus class reads 14.7/15.8/16.8 dB
    #   at 32/48/64k through mpg123 — above lame (tools/is_corpus.py).
    #   Byte no-op on mid-dominant AND decorrelated content (E_mid ~
    #   E_side there). Requires iso_mode_ext: the extra M/S frames must
    #   signal per-frame (the compat hardcoded header would misread
    #   discrete frames, and this flag makes the flip direction matter).
    ms_symmetric: bool = False
    # lowpass_hz: zero all MDCT subbands whose band START is at or above
    #   this frequency before allocation (subband granularity, SR/64 per
    #   band — layout-invariant across long/short/mixed granules), so the
    #   whole bit budget concentrates below the cutoff. The standard
    #   low-bitrate encoder knob (libmp3lame lowpasses ~11-12 kHz at 64
    #   kbps; the reference has nothing): measured at 64k mono through
    #   libmpg123, a 10 kHz cutoff takes speech/noise masked-noise-ratio
    #   to lame parity (15.0->9.7 / 12.6->9.5 vs lame's 9.4) — but it
    #   REMOVES real content, so clean wideband material (tonal music,
    #   where full-band hq BEATS lame by ~13 dB NMR) should keep the
    #   default None (off). A knob, not a preset member.
    lowpass_hz: "int | None" = None
    # adaptive_lowpass: make lowpass_hz conditional PER GRANULE-CHANNEL on
    #   a content decision instead of unconditional. The cutoff engages
    #   only where the high band (subbands >= the lowpass_hz cut) is
    #   either negligible (energy fraction < reference.ALP_FRAC — zeroing
    #   discards nothing) or noise-like (spectral flatness >
    #   reference.ALP_SFM — the budget the band would eat at a low rate
    #   costs more masked noise below the cutoff than the band is worth,
    #   the measured reason static lowpass wins on speech/noise at 64k).
    #   Harmonic-rich wideband content (peaky high band: flatness low,
    #   fraction high) keeps the full band — the measured reason static
    #   lowpass must stay OFF on tonal music. Both statistics are
    #   permutation-invariant over the high-band coefficient set, so the
    #   decision is layout-invariant across long/short/mixed granules.
    #   Requires lowpass_hz (it selects WHERE the cutoff applies, not the
    #   cutoff itself).
    adaptive_lowpass: bool = False
    # distortion_control: one-shot per-band noise shaping INSIDE the
    #   exact-priced walk (the device-feasible form of lame's
    #   distortion-control loop; ops/reference.distortion_bumps has the
    #   law). Pass 1 walks as usual; in every all-LONG frame each
    #   granule's actual per-band error energy is measured against the
    #   spread-mask target, violating bands' scalefactors are bumped by
    #   DC_BUMP, and the granule re-walks ONCE at the same budget.
    #   Frames holding any short/transition granule are exact no-ops (the
    #   stationary band mask misprices temporal noise there — bumping
    #   tone-bed granules around a burst re-opened post-echo, measured
    #   +1.8 dB nburst NMR before the gate). Rate-gated at >= 112 kbps/
    #   channel (see distortion_control_active). Measured through mpg123
    #   at 128 kbps mono (16x1152, 6 classes): CBR speech 7.1 -> 5.3,
    #   noise 4.6 -> 3.3, VBR speech 9.5 -> 6.9; music/burst/nburst exact
    #   no-ops (the all-LONG gate), tonal gives back 2.3 dB of 31 dB
    #   below-mask headroom. The bump probe is a walk at the STATIC
    #   base-rate equal-share budget (state-free: the device twin selects
    #   it from the already-priced candidate table before the budget scan
    #   runs); the real walk then runs once with the bumped magnitudes at
    #   the normal budget — formulations that re-walked the SELECTED
    #   quantization either desynced the est-reservoir world (assembler
    #   stuffing underflow on 16-frame speech) or, budget-capped, lost
    #   the win (speech -0.5, noise +1.4). Off by default: it costs a
    #   second walk pass (~1.5x hq step time on device). Requires
    #   linbits_tables (amplified bands overflow the table-15 qcap) and
    #   real scalefactors; mutually exclusive with scfsi (sharing is
    #   decided on pre-bump scalefactors; hq(distortion_control=True)
    #   drops scfsi automatically).
    distortion_control: bool = False
    # dc_passes / dc_proportional: distortion-control DEPTH (round 5,
    #   requires distortion_control). dc_passes iterates the probe->bump
    #   stage (each pass re-probes at the same static budget with the
    #   bumped magnitudes and bumps the still-violating bands again; ONE
    #   real walk still runs at the end — the causal-budget analogue of
    #   lame's iterated loop). dc_proportional sizes each bump as
    #   ceil(log2(noise/mask)/2) capped at DC_BUMP_MAX instead of the
    #   flat +3 (one scalefactor step ~ -6 dB band error energy).
    #   Measured on the 12-seed speech distribution at 128 kbps mono
    #   (tools/probe_dc_depth.py, mpg123 NMR): shipped (1, flat) -1.08 dB
    #   mean; (2, flat) -1.50; (1, prop) -1.39; (3, prop) -1.95 with
    #   12/12 seeds improved and noise -1.87 — the plateau (4/6/8 passes
    #   measure -1.85/-1.82/-1.82). lame's remaining ~2 dB speech lead
    #   sits beyond the state-free static-share formulation (its loop
    #   re-allocates with live budget feedback). Each extra pass costs a
    #   full probe sweep on device (~+0.4x hq step); defaults keep the
    #   shipped one-shot. Device twin: the probe loop unrolls dc_passes
    #   times (a zero-bump pass is an exact fixpoint, matching the
    #   golden's early break). The proportional step count is a float
    #   log2 compare — ULP-flip contract, same as the bump decision.
    dc_passes: int = 1
    dc_proportional: bool = False
    # free_format: emit header bitrate_index 0 ("free format", ISO
    #   2.4.2.3) with the constant frame size derived from the EXACT
    #   bitrate_kbps — any integer rate 8..640 kbps, not just the table
    #   rows (lame --freeformat is the producing peer; this repo's decoder
    #   size-infers such streams, mpg123-validated in test_freeformat).
    #   Without the flag, off-table rates silently coerce to the nearest
    #   table entry (the reference's closest-match quirk). CBR only:
    #   free-format decoding relies on ONE constant frame size, so vbr /
    #   vbr_demand are rejected.
    free_format: bool = False
    # gapless_info: make streams gapless-playable. Two effects: (1) flush()
    #   appends enough trailing silence that every real input sample is
    #   inside an emitted frame AND the decoder's 529-sample tail margin is
    #   covered (the family pipeline has a structural 528-sample encoder
    #   delay — measured through libmpg123 — so the last samples otherwise
    #   fall into a frame that is never emitted and are silently truncated);
    #   (2) generate_xing_header() appends the de-facto-standard LAME info
    #   tag extension carrying (encoder_delay, padding), which gapless-aware
    #   players (mpg123, ffmpeg, iTunes, ...) use to trim the decode to
    #   sample-exact original length. Off by default: it adds a trailing
    #   frame and tag bytes (the reference truncates and writes no gapless
    #   info — MP3Encoder.swift:367-449 ends at the TOC).
    gapless_info: bool = False
    # shared_ms_blocks: share the window (block-type) decision across the
    #   two channels of any frame that actually encodes mid/side, computed
    #   on the raw pre-matrix L/R PCM (the more-transient channel wins:
    #   LONG < MIXED < SHORT). The reference family detects transients per
    #   channel on the POST-matrix mid/side signals (MP3Encoder.swift:
    #   1944-1968 runs inside the per-channel granule loop), so an M/S
    #   frame can carry DIFFERENT window layouts in its two channels; the
    #   matrixed spectra then live in different time-frequency layouts and
    #   ISO 2.4.3.4.9.2 defines no reading for the reconstruction
    #   (measured: the oracle and libmpg123 each "decode" such streams and
    #   disagree at ~40 dB on bursty decorrelated stereo vs ~133 dB
    #   otherwise — tools/external_matrix.py found it). L/R frames keep
    #   the per-channel decision. Requires iso_quantization (the shared
    #   decision emits subblock_gain=0, the unit-gain law). Subsumed by
    #   window_sequencing, which always shares the decision.
    shared_ms_blocks: bool = False
    # linbits_tables: code big-values regions whose max |q| exceeds 15 with
    #   the ISO B.7 24-family ESC tables (symbol 15 + linbits raw magnitude
    #   bits + sign) instead of capping |q| at 15. The reference's table-15
    #   cap makes decoded SNR saturate at a bitrate-INDEPENDENT ceiling
    #   (~21-27 dB: 320 kbps decodes identically to 128 kbps once the
    #   budget is loose); with linbits the initial gain targets a much
    #   finer quantization (peak |q| ~ 2048) and the gain walk coarsens
    #   only as far as the budget requires, so quality scales with bitrate
    #   like any modern encoder's. Requires the strict entropy layout
    #   (count1_coding + region_table_select) and real_scalefactors.
    linbits_tables: bool = False
    # window_sequencing: emit ISO transition windows around transients
    #   (long -> START(bt1) -> short -> STOP(bt3) -> long) instead of the
    #   reference family's direct long<->short jumps. Direct jumps break
    #   TDAC aliasing cancellation at both junctions: quantization-
    #   INDEPENDENT reconstruction error (~14 dB ceiling on transient
    #   content, measured; sequencing restores the lossless round trip to
    #   ~87 dB). Costs one granule (576 samples) of encoder delay — the
    #   START decision needs one granule of lookahead, exactly like every
    #   production encoder (lame's encoder delay). Under this flag the
    #   block-type decision is shared across channels and computed on the
    #   raw (pre-matrix) PCM, and MIXED demotes to SHORT (uniform
    #   transition windows can't face a mixed granule's split junction).
    #   Requires iso_short_blocks (conforming bt=2 short signaling; the
    #   family's bt=1 "mixed" header quirk collides with ISO bt=1 START).
    window_sequencing: bool = False
    # demand_budget: within each frame, granule-channels whose DEMAND
    #   (exact priced bits at the walk grid's K_DEMAND probe) sits under
    #   the equal share DONATE the surplus; granules over it split the
    #   donations by deficit. The reference's unconditional equal split
    #   starves attack granules at low bitrates (+1.2 dB measured at 64k
    #   on transient content); the donation law is an exact no-op when no
    #   (surplus, deficit) pair coexists, so steady frames keep the equal
    #   split bit-for-bit. Budgets clamp to the 4095-bit part2_3_length
    #   field. Requires the strict entropy layout (the demand signal is
    #   the strict sweep's priced grid).
    demand_budget: bool = False
    # intensity_stereo: intensity-stereo ENCODING (ISO 11172-3 2.4.3.4.9.3
    #   from the emit side; the decode surface was built and libmpg123-
    #   validated in round 3, tests/test_intensity.py). Frames whose
    #   granules are all LONG emit mode_extension 0b01; per granule, the
    #   upper spectrum (from the lowest band where the channels are panned
    #   or positively correlated — ops.reference.intensity_encode) is coded
    #   ONCE as the per-line L+R sum in the left channel, the right channel
    #   is zero there, and the right channel's scalefactor slots carry the
    #   per-band pan positions. Halves the coded lines in the IS region —
    #   the classic very-low-joint-rate tool, rate-gated at <= 24 kbps per
    #   channel (intensity_stereo_active; the measured window — 64 kbps
    #   stereo is already a wash-to-loss). lame dropped IS entirely, so the
    #   external referee is mpg123-decode downmix SNR/NMR vs the
    #   discrete-stereo encode at equal rate; the inherent trade is
    #   worst-channel SNR (7 pan positions quantize the image angle —
    #   audibly benign, SNR-expensive).
    #   Frames holding any short/transition granule fall back to the
    #   iso_mode_ext law (discrete or M/S). MPEG-1 only (the LSF position
    #   law differs; decode-side exists, encode is future work). Requires
    #   mode=joint_stereo, real_scalefactors (position slots ride the
    #   scalefactor machinery), iso_mode_ext (non-IS frames must signal
    #   their actual matrix); mutually exclusive with scfsi (positions are
    #   per-granule, written after the rate walk — sharing is decided on
    #   pre-position values). Golden backend only this round (use
    #   backend="numpy"); the device twin is a round-5 candidate.
    intensity_stereo: bool = False
    # (noise_demand — a noise-targeted donation demand — was built here in
    #   round 4 and REMOVED after measurement: wash on every class/rate,
    #   worse on noise-bursts at 128k at every margin. Record:
    #   tools/probe_noise_demand.py + ARCHITECTURE.md "Noise-priced
    #   demand"; implementation in git history, commit 266ac23.)

    def __post_init__(self):
        # Quality is clamped, not rejected (MP3Encoder.swift:110).
        object.__setattr__(self, "quality", max(0, min(int(self.quality), 9)))
        if isinstance(self.mode, str) and not isinstance(self.mode, Mode):
            object.__setattr__(self, "mode", Mode(self.mode))
        if self.reservoir_mode not in ("compat", "aligned"):
            raise ValueError(
                f"reservoir_mode must be 'compat' or 'aligned', got "
                f"{self.reservoir_mode!r}"
            )
        if self.real_scalefactors and not self.iso_quantization:
            raise ValueError(
                "real_scalefactors requires iso_quantization (the per-band "
                "amplification only cancels at unit gain under the ISO law)"
            )
        if self.psy_scalefactors and not self.real_scalefactors:
            raise ValueError(
                "psy_scalefactors requires real_scalefactors (it selects the "
                "scalefactor LAW; emission rides the same machinery)"
            )
        if self.scfsi and not self.real_scalefactors:
            raise ValueError(
                "scfsi requires real_scalefactors (there are no scalefactor "
                "bits to share otherwise)"
            )
        if self.iso_short_blocks and not self.real_scalefactors:
            raise ValueError(
                "iso_short_blocks requires real_scalefactors (short "
                "scalefactor emission rides the same machinery, and the "
                "2^sf amplification needs the scalefac_scale=1 unit-gain "
                "cancellation)"
            )
        if self.linbits_tables and not (
            self.count1_coding and self.region_table_select and self.real_scalefactors
        ):
            raise ValueError(
                "linbits_tables requires count1_coding + region_table_select "
                "+ real_scalefactors (ESC regions ride the strict per-region "
                "table selection and the scaled-magnitude gain law)"
            )
        if self.window_sequencing and not self.iso_short_blocks:
            raise ValueError(
                "window_sequencing requires iso_short_blocks (ISO bt=2 "
                "short signaling; the family's bt=1 mixed quirk collides "
                "with the ISO START block type)"
            )
        if self.shared_ms_blocks and not self.iso_quantization:
            raise ValueError(
                "shared_ms_blocks requires iso_quantization (the shared "
                "decision emits subblock_gain=0, which is only the decode "
                "law under unit-gain quantization)"
            )
        if not (1 <= int(self.reservoir_depth) <= 8):
            raise ValueError("reservoir_depth must be in 1..8")
        if self.reservoir_depth > 1 and self.reservoir_mode != "aligned":
            raise ValueError(
                "reservoir_depth > 1 requires reservoir_mode='aligned' (the "
                "compat mode's placement quirk is frozen reference behavior)"
            )
        if self.free_format:
            if self.vbr:
                raise ValueError(
                    "free_format is CBR-only: decoders infer the single "
                    "constant frame size from the stream"
                )
            if not (8 <= self.bitrate_kbps <= 640):
                raise ValueError("free_format bitrate must be 8..640 kbps")
        if self.vbr_demand and not (self.vbr and self.spec_strict_entropy):
            raise ValueError(
                "vbr_demand requires vbr=True and the strict entropy layout "
                "(its demand signal is the sweep's priced grid)"
            )
        if self.adaptive_lowpass and self.lowpass_hz is None:
            raise ValueError(
                "adaptive_lowpass requires lowpass_hz (it gates WHERE the "
                "cutoff applies; the cutoff frequency itself is lowpass_hz)"
            )
        if self.demand_budget and not self.spec_strict_entropy:
            raise ValueError(
                "demand_budget requires the strict entropy layout (the "
                "demand signal is the strict sweep's priced candidate grid)"
            )
        if self.distortion_control and not self.linbits_tables:
            raise ValueError(
                "distortion_control requires linbits_tables: amplified "
                "bands overflow the table-15 quantized cap (15), silently "
                "clipping peaks; the linbits target has 4x headroom"
            )
        if self.distortion_control and not self.real_scalefactors:
            raise ValueError(
                "distortion_control amplifies per-band scalefactors; it "
                "requires real_scalefactors (transmitted scalefactors)"
            )
        if self.distortion_control and self.scfsi:
            raise ValueError(
                "distortion_control and scfsi are mutually exclusive: "
                "scfsi sharing is decided on the pre-bump scalefactors "
                "(use MP3EncoderOptions.hq(distortion_control=True), "
                "which drops scfsi)"
            )
        if not (1 <= self.dc_passes <= 8):
            raise ValueError(
                "dc_passes must be in 1..8 (measured plateau at 3; each "
                "pass costs a full probe sweep on device)"
            )
        if (
            self.dc_passes != 1 or self.dc_proportional
        ) and not self.distortion_control:
            raise ValueError(
                "dc_passes/dc_proportional are distortion_control depth "
                "knobs; set distortion_control=True"
            )
        if self.intensity_stereo:
            if self.mode is not Mode.JOINT_STEREO:
                raise ValueError(
                    "intensity_stereo requires mode=joint_stereo (the "
                    "mode_extension intensity bit only exists there)"
                )
            if not self.real_scalefactors:
                raise ValueError(
                    "intensity_stereo requires real_scalefactors (intensity "
                    "positions ride the scalefactor slot machinery)"
                )
            if not self.iso_mode_ext:
                raise ValueError(
                    "intensity_stereo requires iso_mode_ext (non-IS frames "
                    "must signal their actual matrix per frame)"
                )
            if not self.iso_short_blocks:
                raise ValueError(
                    "intensity_stereo requires iso_short_blocks: transient "
                    "IS frames write per-(band, window) positions in the "
                    "short scalefactor slot layout (round 5)"
                )
            if self.scfsi:
                raise ValueError(
                    "intensity_stereo and scfsi are mutually exclusive: "
                    "positions are written per granule after the rate walk "
                    "(use MP3EncoderOptions.hq(intensity_stereo=True), "
                    "which drops scfsi)"
                )
            if self.lsf:
                raise ValueError(
                    "intensity_stereo encoding is MPEG-1 only (the LSF "
                    "2^(-pos/4) position law differs; decode support "
                    "exists, encoding is future work)"
                )
        if self.ms_symmetric and not self.iso_mode_ext:
            raise ValueError(
                "ms_symmetric requires iso_mode_ext: the symmetric arm's "
                "extra M/S frames must signal per frame (the compat "
                "hardcoded 0b10 header already misreads discrete frames, "
                "and this flag makes the flip direction matter)"
            )
        if self.lsf and not (
            self.iso_quantization and self.reservoir_mode == "aligned"
        ):
            raise ValueError(
                "LSF sample rates (8-24 kHz) require iso_quantization and "
                "reservoir_mode='aligned': low-rate encoding is a "
                "beyond-reference capability with no parity surface, so "
                "only conforming streams are emitted (use "
                "MP3EncoderOptions.spec_strict(sample_rate=...) or .hq())"
            )

    @property
    def channels(self) -> int:
        return self.mode.channels

    # --- MPEG-2/2.5 LSF (ISO 13818-3) derived structure -----------------------
    # Low-sample-rate encoding is a beyond-reference capability: the
    # reference's header writer is MPEG-1-only (MP3Encoder.swift:2533-2544
    # maps unknown rates to the 44.1 kHz index, mislabeling the stream), so
    # there is no parity surface at these rates — LSF streams are only
    # emitted CONFORMING (validation in __post_init__ requires the
    # unit-gain quantization law and the aligned reservoir).

    @property
    def lsf(self) -> int:
        """0 = MPEG-1, 1 = MPEG-2, 2 = MPEG-2.5 (from the sample rate)."""
        from .tables import lsf_version

        return lsf_version(self.sample_rate)

    @property
    def n_granules(self) -> int:
        """Granules per frame: 2 (MPEG-1) or 1 (LSF, ISO 13818-3 2.4.1.7)."""
        return 1 if self.lsf else 2

    @property
    def samples_per_frame(self) -> int:
        return SAMPLES_PER_GRANULE * self.n_granules

    @property
    def reservoir_cap(self) -> int:
        """main_data_begin field reach: 9 bits (511 bytes) in MPEG-1,
        8 bits (255) in LSF — caps the reservoir counter, the budget draw,
        and every mdb clamp."""
        return 255 if self.lsf else 511

    @property
    def intensity_stereo_active(self) -> bool:
        """intensity_stereo, rate-gated at <= 24 kbps per channel (the base
        bitrate under VBR). Above the gate the flag is a byte no-op: the
        3-class x {32,48,64}k sweep (ops.reference.IS_MIN_SFB note) measured
        IS positive at 32-48k stereo (downmix +0.7..+1.8 dB SNR, NMR up to
        +2.5 dB on correlated wide content) and a wash-to-loss at 64k
        stereo, where the budget affords discrete coding of both channels
        (wide chord downmix -3.7 dB).

        The per-frame vbr interaction (frames riding above 24 kbps/channel
        under vbr/vbr_demand while IS stays engaged) is MEASURED benign at
        the gated base rates (round 5, 32k stereo + vbr_demand, mpg123
        downmix SNR): panned q5 +0.7 dB, wide q0 -0.1, wide q5 -0.5 —
        the wash-to-loss window needs a 64k BASE's content/budget mix,
        which a 32k-base demand stream does not reproduce."""
        return bool(
            self.intensity_stereo
            and self.bitrate_kbps // self.channels <= 24
        )

    @property
    def distortion_control_active(self) -> bool:
        """distortion_control, rate-gated at >= 112 kbps per channel (the
        base bitrate under VBR). Below the gate the flag is a byte no-op:
        the full-matrix sweep (tools/probe_noise_shaping.py protocol,
        mpg123 NMR, 6 classes x 64/96/128k mono) measured the one-shot law
        positive only where spare precision exists — at 128 kbps/channel
        speech -1.7 and noise -1.0 dB with transient classes exact no-ops
        (the all-LONG frame gate); at 64-96 kbps/channel amplification's
        global-gain cost exceeds the band win (+0.2..+0.9 everywhere)."""
        return bool(
            self.distortion_control
            and not self.lsf
            and self.bitrate_kbps // self.channels >= 112
        )

    @property
    def spec_strict_entropy(self) -> bool:
        """True when the main_data layout differs from reference parity
        (affects bit counting, packing, and side-info fields); includes
        real_scalefactors, whose part2 bits ride in main_data."""
        return self.count1_coding or self.region_table_select or self.real_scalefactors

    @classmethod
    def spec_strict(cls, **kwargs) -> "MP3EncoderOptions":
        """Preset with every ISO-correctness flag on (and the aligned
        reservoir): streams a conforming ISO 11172-3 decoder reproduces at
        unit gain. kwargs override any field."""
        base = dict(
            reservoir_mode="aligned",
            iso_quantization=True,
            iso_crc=True,
            count1_coding=True,
            region_table_select=True,
            real_scalefactors=True,
            iso_short_blocks=True,
            iso_mode_ext=True,
            iso_ms_matrix=True,
            shared_ms_blocks=True,
            ms_symmetric=True,
        )
        base.update(kwargs)
        return cls(**base)

    @classmethod
    def hq(cls, **kwargs) -> "MP3EncoderOptions":
        """High-quality preset: spec_strict plus the quality extensions the
        reference never had — linbits ESC coding (quality scales with
        bitrate) and scfsi sharing. psy_scalefactors stays OFF here: its
        constants were tuned for the table-15 regime, where amplifying
        masked-away bands was nearly free (coarse steps round the amplified
        leakage to 0-1); under the linbits law's fine quantization the same
        amplification buys real bits of spectral leakage and measures -0.1
        to -2.9 dB on the corpus (-20 dB on adversarial two-tone content).
        Retune before re-enabling. kwargs override any field.

        Rate-derived lowpass (round 4): at starving rates the preset
        engages the ADAPTIVE lowpass by default — full-band hq loses the
        noise/speech classes to lame at 64-96k mono because the budget
        spreads over bands the rate cannot afford (measured: static
        10 kHz takes speech/noise NMR 15.0->9.7 / 12.6->9.5 at 64k =
        lame parity; tools/probe_adaptive_lowpass.py), while the
        adaptive gate keeps bright harmonic content byte-equal to
        lowpass-OFF past filterbank warm-up (static there loses 5.2 dB
        NMR at 96k). Engage rule matches the probe's measured region:
        mono <= 96 kbps, stereo <= 96 kbps total (48/channel — more
        starved than the measured mono points, same win direction);
        128 kbps+ streams are byte no-ops. Passing lowpass_hz or
        adaptive_lowpass explicitly (even None/False) disables the
        rule."""
        base = dict(
            linbits_tables=True,
            scfsi=not (
                kwargs.get("distortion_control", False)
                or kwargs.get("intensity_stereo", False)
            ),
            demand_budget=True,
            window_sequencing=True,
        )
        base.update(kwargs)
        opts = cls.spec_strict(**base)
        if "lowpass_hz" not in kwargs and "adaptive_lowpass" not in kwargs:
            if opts.bitrate_kbps <= 96:
                opts = replace(opts, lowpass_hz=10000, adaptive_lowpass=True)
        return opts

    def replace(self, **kwargs) -> "MP3EncoderOptions":
        return replace(self, **kwargs)


SAMPLES_PER_FRAME = 1152
SAMPLES_PER_GRANULE = 576
SUBBANDS = 32
GRANULES_PER_FRAME = 2
RESERVOIR_MAX_BYTES = 511

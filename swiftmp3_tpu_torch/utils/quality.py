"""Objective quality measurement: compare decoded output against source PCM.

The reference ships no quality evaluation at all; its round-trip tests only
assert loose energy thresholds. This module gives the framework a proper
evaluation story: time-aligned, gain-compensated SNR and per-band spectral
error between the original PCM and a decode of the encoded stream.

Gain compensation matters here: the encoder family's quantization law decodes
over-amplified on ISO decoders (see swiftmp3_tpu.decoder), so raw SNR would
measure that constant gain rather than coding distortion.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class QualityReport:
    snr_db: float  # gain-compensated, time-aligned SNR
    gain: float  # least-squares gain applied to the decoded signal
    delay_samples: int  # codec delay found by alignment
    band_snr_db: list  # SNR per octave-ish band (low -> high)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        bands = ", ".join(f"{b:.1f}" for b in self.band_snr_db)
        return (
            f"SNR {self.snr_db:.1f} dB (gain {self.gain:.3f}, "
            f"delay {self.delay_samples}); band SNR [{bands}] dB"
        )


def _align(
    ref: np.ndarray, dec: np.ndarray, max_delay: int = 4096, unit_gain: bool = False
) -> int:
    """Find the decoder delay minimizing the resulting error energy.

    The objective matches the SNR that will be measured AT THAT LAG over
    the FULL overlap n_d = min(len(ref), len(dec)-d) — not a fixed head
    window. A head-window objective can land a period multiple off on
    periodic content (interior error is identical there) and then charge
    the stream-end mismatch — trailing encoder-delay zeros compared
    against source content — to the SNR: measured as a phantom -15 dB on
    a delayed encode of a 16-frame tonal signal whose interior agreed to
    0.05 dB. With unit_gain the score is -err(d)/refE(n_d); with the
    least-squares gain, corr(d)^2/(decE(d)*refE(n_d)). Signed either way:
    a sign-inverting decode SHOULD score badly. Falls back to the head-
    window law when the full-overlap correlate would be too large (long
    streams — where end effects are a negligible fraction anyway)."""
    L = len(ref)
    D = len(dec)
    if L <= 0 or D <= 0:
        return 0
    if L * max_delay > 400_000_000:  # long streams: head-window law
        n = min(L, D - max_delay, 44100)
        if n <= 0:
            return 0
        r = ref[:n].astype(np.float64)
        seg = dec[: n + max_delay].astype(np.float64)
        corr = np.correlate(seg, r, mode="valid")
        e = np.concatenate([[0.0], np.cumsum(seg * seg)])
        energy = e[n:] - e[:-n]
        if unit_gain:
            score = 2.0 * corr - energy
        else:
            score = np.where(
                corr > 0, corr * corr / np.maximum(energy, 1e-30), -np.inf
            )
            if not np.isfinite(score).any():
                score = corr
        return int(np.argmax(score))

    max_d = int(min(max_delay, max(D - min(L, 1024), 0)))
    r = ref.astype(np.float64)
    pad = max(max_d + L - D, 0)
    seg = np.concatenate([dec.astype(np.float64), np.zeros(pad)])[: max_d + L]
    corr = np.correlate(seg, r, mode="valid")  # [max_d + 1], zero-pad exact
    e = np.concatenate([[0.0], np.cumsum(seg * seg)])
    d_idx = np.arange(max_d + 1)
    dece = e[d_idx + L] - e[d_idx]  # decode energy over the (padded) overlap
    re = np.concatenate([[0.0], np.cumsum(r * r)])
    n_d = np.minimum(L, D - d_idx)
    refe = re[np.maximum(n_d, 0)]
    if unit_gain:
        err = refe - 2.0 * corr + dece
        score = -err / np.maximum(refe, 1e-30)
    else:
        score = np.where(
            corr > 0,
            corr * corr / np.maximum(dece * refe, 1e-30),
            -np.inf,
        )
        if not np.isfinite(score).any():
            score = corr
    return int(np.argmax(score))


def measure_quality(
    original: np.ndarray,
    decoded: np.ndarray,
    sample_rate: int = 44100,
    n_bands: int = 6,
    compensate_gain: bool = True,
) -> QualityReport:
    """Gain-compensated SNR of `decoded` (mono 1-D) against `original`.

    compensate_gain=False measures RAW unit-gain SNR (gain forced to 1.0):
    the right metric for spec-strict streams, whose conforming decode is
    unit-gain by construction — a level error then counts as error instead
    of being absorbed by the least-squares gain."""
    original = np.asarray(original, dtype=np.float64).reshape(-1)
    decoded = np.asarray(decoded, dtype=np.float64).reshape(-1)
    d = _align(original, decoded, unit_gain=not compensate_gain)
    n = min(len(original), len(decoded) - d)
    ref = original[:n]
    dec = decoded[d : d + n]
    denom = float(ref @ ref)
    if denom <= 0:
        return QualityReport(np.inf, 0.0, d, [np.inf] * n_bands)
    if compensate_gain:
        gain = float(dec @ ref) / float(dec @ dec) if dec @ dec > 0 else 1.0
    else:
        gain = 1.0
    err = ref - gain * dec
    snr = 10 * np.log10(denom / max(float(err @ err), 1e-30))

    # per-band SNR via FFT magnitude bins split into octave-ish bands
    R = np.fft.rfft(ref)
    E = np.fft.rfft(err)
    edges = np.geomspace(40.0, sample_rate / 2, n_bands + 1)
    freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
    band_snr = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (freqs >= lo) & (freqs < hi)
        ps = float(np.sum(np.abs(R[m]) ** 2))
        pe = float(np.sum(np.abs(E[m]) ** 2))
        band_snr.append(10 * np.log10(max(ps, 1e-30) / max(pe, 1e-30)))
    return QualityReport(float(snr), gain, d, band_snr)


def decode_agreement_snr(a: np.ndarray, b: np.ndarray) -> float:
    """Raw SNR of decode `b` against decode `a` over their common prefix,
    with NO alignment search: two decoders reading the SAME byte stream
    start at the same sample by construction. (measure_quality's
    correlation alignment can lock onto an arbitrary period multiple on
    periodic content — a -130 dB agreement then reads as ~2 dB phantom
    disagreement; this is the correct tool for decoder-vs-decoder.)"""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    n = min(len(a), len(b))
    if n == 0:
        return np.inf
    ref, err = a[:n], a[:n] - b[:n]
    denom = float(ref @ ref)
    if denom <= 0:
        return np.inf if float(err @ err) == 0 else -np.inf
    return 10 * np.log10(denom / max(float(err @ err), 1e-300))


def encode_decode_quality(options, pcm: np.ndarray, backend: str = "numpy") -> QualityReport:
    """Convenience: encode `pcm` (mono) with `options`, decode with the
    oracle, and measure quality."""
    from ..decoder import decode_mp3
    from ..encoder import MP3Encoder

    s = MP3Encoder(options, backend=backend).new_session()
    data = s.encode(pcm) + s.flush()
    # streams using ISO-convention laws must be read with them (the laws no
    # header bit signals; see decode_mp3's docstring)
    dec = decode_mp3(data, iso_conventions=options.iso_ms_matrix)
    return measure_quality(pcm, dec.pcm[:, 0], options.sample_rate)


def masked_noise_ratio(
    original: np.ndarray,
    decoded: np.ndarray,
    sample_rate: int = 44100,
    frame: int = 1024,
    unit_gain: bool = True,
) -> float:
    """Mean noise-to-mask ratio in dB (lower = better; <= 0 dB means the
    coding noise sits at or below the masking threshold everywhere).

    A simplified PEAQ-style NMR: per Hann-windowed frame, the source power
    spectrum is grouped into ~bark-wide bands, spread with the classic
    two-slope (+25 dB/bark toward lower bands, -10 dB/bark toward higher)
    max-plus skirt, offset by -18 dB (between the tonal and noise masking
    offsets), and floored at the absolute threshold of hearing (Terhardt,
    with full-scale = 96 dB SPL). The error spectrum's band power is then
    measured against that threshold. This is NOT a calibrated PEAQ score —
    it is a RELATIVE perceptual referee: all contenders are judged by the
    same masking law, so deltas are meaningful where plain SNR is blind
    (SNR cannot reward moving noise under maskers — the documented reason
    psy-law tuning stalled on an SNR objective).
    """
    original = np.asarray(original, dtype=np.float64).reshape(-1)
    decoded = np.asarray(decoded, dtype=np.float64).reshape(-1)
    d = _align(original, decoded, unit_gain=unit_gain)
    n = min(len(original), len(decoded) - d)
    ref = original[:n]
    dec = decoded[d : d + n]
    if not unit_gain:
        g = float(dec @ ref) / float(dec @ dec) if dec @ dec > 0 else 1.0
        dec = dec * g
    err = ref - dec

    hop = frame // 2
    win = np.hanning(frame)
    freqs = np.fft.rfftfreq(frame, 1.0 / sample_rate)
    # bark index per bin (Zwicker/Traunmüller approximation)
    f = np.maximum(freqs, 1.0)
    bark = 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)
    n_bands = int(np.ceil(bark.max()))
    band_of = np.minimum(bark.astype(int), n_bands - 1)
    # absolute threshold of hearing, dB SPL (full-scale sine = 96 dB SPL)
    khz = f / 1000.0
    ath_db = (
        3.64 * khz**-0.8
        - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
        + 1e-3 * khz**4
    )
    # per-band minimum ATH, as linear power in the full-scale=96dB convention
    ath_band = np.full(n_bands, np.inf)
    np.minimum.at(ath_band, band_of, ath_db)
    ath_pow = 10.0 ** ((ath_band - 96.0) / 10.0)

    ratios = []
    for start in range(0, n - frame + 1, hop):
        R = np.fft.rfft(ref[start : start + frame] * win)
        E = np.fft.rfft(err[start : start + frame] * win)
        # normalize so a full-scale sine has band power ~1.0
        scale = 1.0 / (frame / 4) ** 2
        sp = np.zeros(n_bands)
        ep = np.zeros(n_bands)
        np.add.at(sp, band_of, np.abs(R) ** 2 * scale)
        np.add.at(ep, band_of, np.abs(E) ** 2 * scale)
        if sp.max() <= 0:
            continue
        # two-slope max-plus spreading in the dB domain
        sdb = 10.0 * np.log10(np.maximum(sp, 1e-30))
        spread = sdb.copy()
        for b in range(1, n_bands):  # upward spread (toward higher bands)
            spread[b] = max(spread[b], spread[b - 1] - 10.0)
        for b in range(n_bands - 2, -1, -1):  # downward spread
            spread[b] = max(spread[b], spread[b + 1] - 25.0)
        thr = np.maximum(10.0 ** ((spread - 18.0) / 10.0), ath_pow)
        ratios.append(float(np.mean(ep / thr)))
    if not ratios:
        return -np.inf
    return 10.0 * np.log10(max(float(np.mean(ratios)), 1e-30))

"""Batched granule DSP of the compat chunk program, in PyTorch.

Twin of `swiftmp3_tpu.ops.dsp` for the ops the compat preset runs. Same
shapes and layouts as the JAX functions (batch-leading, [..., 576] granule
rows), same float32 operation order where the JAX code fixes one.

The JAX module avoids TPU gathers with where-tree lookups, exact `ldexp`
step reconstruction and one-hot selects. Here the same values come the way a
GPU computes them: 256-entry tables indexed directly. The tables are built
from `swiftmp3_tpu.tables` in numpy float64 exactly as the JAX module builds
its constants (tests hold them equal bit for bit).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from swiftmp3_tpu.tables import (
    ALIASING_CA,
    ALIASING_CS,
    ANALYSIS_MATRIX,
    BITRATE_TABLE_V1,
    BITRATE_TABLE_V2,
    ISO_WINDOW,
    LONG_MDCT_MATRIX,
    LONG_WINDOW,
    SHORT_MDCT_MATRIX,
    SHORT_WINDOW,
    TABLE15_CODE,
    TABLE15_LEN,
    band_table,
)

from . import kernels

BLOCK_LONG = 0
BLOCK_MIXED = 1
BLOCK_SHORT = 2

N_GAIN_CANDIDATES = kernels.N_GAIN_CANDIDATES

_F32 = torch.float32
_I32 = torch.int32


# --- Constants (numpy, built as the JAX module builds them) ------------------


def build_polyphase_fold() -> np.ndarray:
    """Reversed window x cosine matrix folded into five [128, 128] matrices
    (twin of dsp._build_polyphase_fold): S4[r] = sum_d row[r+d] @ C3[d] over
    x packed in 128-sample rows, 4 window positions per output row."""
    Wrev = np.asarray(ISO_WINDOW[::-1], dtype=np.float64)  # [512]
    MrevT = np.asarray(ANALYSIS_MATRIX[:, ::-1].T, dtype=np.float64)  # [64, 32]
    C = Wrev[:, None] * MrevT[np.arange(512) % 64]  # [512, 32]
    mats = []
    for d in range(5):
        M = np.zeros((128, 128))
        for c in range(4):
            for l in range(128):
                u = 128 * d + l - 32 * c
                if 0 <= u < 512:
                    M[l, c * 32 : (c + 1) * 32] = C[u]
        mats.append(M.astype(np.float32))
    return np.stack(mats)  # [5, 128, 128]


def build_mdct_fold() -> tuple[np.ndarray, np.ndarray]:
    """Compat MDCT fold (twin of dsp._build_mdct_fold's "p"/"c"): window x
    MDCT matrix x norm (x aliasing) as [576, 1188] matrices over the flat
    (t*32 + sb) granule layout. Columns 0-575: aliased long law; 576-1151:
    short law; 1152-1187: the mixed granules' unaliased-long head."""
    W36 = np.asarray(LONG_WINDOW, dtype=np.float64)
    ML = np.asarray(LONG_MDCT_MATRIX, dtype=np.float64)
    SW = np.asarray(SHORT_WINDOW, dtype=np.float64)
    MS = np.asarray(SHORT_MDCT_MATRIX, dtype=np.float64)

    blk_p = np.einsum("t,mt->tm", W36[:18], ML[:, :18]) / 9.0
    blk_c = np.einsum("t,mt->tm", W36[18:], ML[:, 18:]) / 9.0
    Lp = np.zeros((576, 576))
    Lc = np.zeros((576, 576))
    for sb in range(32):
        rows = np.arange(18) * 32 + sb
        cols = sb * 18 + np.arange(18)
        Lp[np.ix_(rows, cols)] = blk_p
        Lc[np.ix_(rows, cols)] = blk_c

    A = np.eye(576)
    cs = np.asarray(ALIASING_CS, dtype=np.float64)
    ca = np.asarray(ALIASING_CA, dtype=np.float64)
    for b in range(31):
        for i in range(8):
            pu = b * 18 + (17 - i)
            pl = (b + 1) * 18 + i
            A[pu, pu] = cs[i]
            A[pl, pu] = ca[i]
            A[pl, pl] = cs[i]
            A[pu, pl] = -ca[i]

    Sp = np.zeros((576, 576))
    Sc = np.zeros((576, 576))
    for w in range(3):
        for j in range(12):
            u = 6 * w + 6 + j
            tgt = Sp if u < 18 else Sc
            t = u if u < 18 else u - 18
            for m in range(6):
                wgt = SW[j] * MS[m, j] / 3.0
                for sb in range(32):
                    tgt[t * 32 + sb, sb * 18 + 3 * m + w] += wgt

    MP = np.concatenate([Lp @ A, Sp, Lp[:, :36]], axis=1)
    MC = np.concatenate([Lc @ A, Sc, Lc[:, :36]], axis=1)
    return MP.astype(np.float32), MC.astype(np.float32)


def build_sign_flat() -> np.ndarray:
    """[576] frequency-inversion signs in (t*32 + sb) order: -1 where the
    within-granule time index and the subband are both odd."""
    t_odd = (np.arange(18) % 2 == 1)[:, None]
    sb_odd = (np.arange(32) % 2 == 1)[None, :]
    return np.where(t_odd & sb_odd, -1.0, 1.0).astype(np.float32).reshape(576)


def build_inv_step_tables() -> tuple[np.ndarray, np.ndarray]:
    """Per-gain float32 inverse quantizer steps, g = 0..255.

    Compat law: f32(1) / f32(max(2^((g-210)/4), 1e-4)) (dsp.py:87-99).
    ISO law: f32(max(2^((g-210)/4), 1e-4)^-0.75) (dsp.py:182-190)."""
    g = np.arange(256, dtype=np.float64)
    step = np.maximum(2.0 ** ((g - 210.0) / 4.0), 0.0001)
    inv = (np.float32(1.0) / step.astype(np.float32)).astype(np.float32)
    inv34 = (step ** -0.75).astype(np.float32)
    return inv, inv34


def build_region_bounds(sample_rate: int) -> np.ndarray:
    return np.cumsum(band_table(sample_rate)).astype(np.int32)  # [21]


POLY_FOLD = build_polyphase_fold()
MDCT_FOLD_P, MDCT_FOLD_C = build_mdct_fold()
SIGN_FLAT = build_sign_flat()
INV_STEP, INV_STEP34 = build_inv_step_tables()
T15_LEN = TABLE15_LEN.astype(np.int32)  # [256]
T15_CODE = TABLE15_CODE.astype(np.int32)  # [256]
BITRATE_VALUES = np.asarray(BITRATE_TABLE_V1, dtype=np.int32)
BITRATE_VALUES_V2 = np.asarray(BITRATE_TABLE_V2, dtype=np.int32)

_CONSTANTS = {
    "poly_fold": POLY_FOLD,
    "mdct_p": MDCT_FOLD_P,
    "mdct_c": MDCT_FOLD_C,
    "sign_flat": SIGN_FLAT,
    "inv_step": INV_STEP,
    "inv_step34": INV_STEP34,
    "t15_len": T15_LEN,
    "t15_code": T15_CODE,
    "bitrates_v1": BITRATE_VALUES,
    "bitrates_v2": BITRATE_VALUES_V2,
}


@functools.lru_cache(maxsize=None)
def constant(name: str, device: torch.device) -> torch.Tensor:
    """A module constant as a tensor on `device` (made once per device)."""
    return torch.from_numpy(_CONSTANTS[name]).to(device)


@functools.lru_cache(maxsize=None)
def region_bounds(sample_rate: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(build_region_bounds(sample_rate)).to(device)


def inv_step_table(iso: bool, device: torch.device) -> torch.Tensor:
    return constant("inv_step34" if iso else "inv_step", device)


# --- Ingest and stereo --------------------------------------------------------


def ingest(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM x 1/32768 (exact in float32), else float32 with non-finite
    samples zeroed (pipeline.py:195-205)."""
    if pcm.dtype == torch.int16:
        return pcm.to(_F32) * (1.0 / 32768.0)
    return torch.nan_to_num(pcm.to(_F32), nan=0.0, posinf=0.0, neginf=0.0)


def stereo_decide(
    left: torch.Tensor, right: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint-stereo M/S decision per frame with the compat /2 matrix
    (dsp.py:1196-1221): M/S when side energy < 0.4 x mid energy.
    left/right: [..., 1152]. Returns (use_ms [...] bool, ch0, ch1)."""
    mid = (left + right) * 0.5
    side = (left - right) * 0.5
    n = float(left.shape[-1])
    mid_e = torch.sum(mid * mid, dim=-1) / n
    side_e = torch.sum(side * side, dim=-1) / n
    use_ms = side_e < mid_e * 0.4
    ch0 = torch.where(use_ms[..., None], mid, left)
    ch1 = torch.where(use_ms[..., None], side, right)
    return use_ms, ch0, ch1


# --- Polyphase analysis filterbank ---------------------------------------------


def polyphase_chunk_matmul(
    hist: torch.Tensor, pcm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ISO analysis filterbank over a whole chunk as five folded
    [128, 128] fp32 matmuls (dsp.py:311-348, MPEG-1 chunks: 36T is a
    multiple of 4). hist: [..., 480]; pcm: [..., T*1152]. Returns
    (S [..., 36T, 32], full signal x [..., 480 + T*1152])."""
    x_full = torch.cat([hist, pcm], dim=-1)
    L = x_full.shape[-1]
    T36 = (L - 480) // 32
    if T36 % 4:
        raise NotImplementedError(
            "odd-T LSF chunks (18 windows per frame) arrive with the LSF "
            "slice (ROADMAP Queue 1 item 11)"
        )
    R_out = T36 // 4
    x = torch.nn.functional.pad(x_full, (0, 32))
    A = x.reshape(*x.shape[:-1], (L + 32) // 128, 128)
    fold = constant("poly_fold", x.device)
    S4 = None
    for d in range(5):
        term = torch.matmul(A[..., d : d + R_out, :], fold[d])
        S4 = term if S4 is None else S4 + term
    S = S4.reshape(*S4.shape[:-2], T36, 32)
    return S, x_full


# --- Transient detection and MDCT ---------------------------------------------


def transient_frame(
    granule_pcm: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-type decision per granule (dsp.py:624-645).

    granule_pcm: [..., 576]. Returns (block_type [...] int32, subblock_gain
    [..., 3] int32); the first loudest sub-block wins ties, as the reference.
    """
    sub = granule_pcm.reshape(*granule_pcm.shape[:-1], 3, 192)
    energies = torch.sum(sub * sub, dim=-1) / 192.0  # [..., 3]
    emax = torch.amax(energies, dim=-1)
    emin = torch.amin(energies, dim=-1)
    ratio = emax / torch.clamp(emin, min=1e-4)
    first_loudest = torch.argmax(energies, dim=-1) == 0
    block = torch.where(
        ratio > 6.0,
        torch.where(first_loudest, BLOCK_MIXED, BLOCK_SHORT),
        BLOCK_LONG,
    ).to(_I32)
    normalized = torch.clamp(
        energies / torch.clamp(emax[..., None], min=1e-4), 0.0, 1.0
    )
    gain = torch.trunc((1.0 - normalized) * 7.0).to(_I32)
    return block, gain


def mdct_chunk(
    S: torch.Tensor, overlap: torch.Tensor, block_type: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """MDCT for all 2T granules of a chunk, compat law (dsp.py:556-618 with
    iso_mixed_alias=False, window_seq=False).

    S: [..., 36T, 32]; overlap: [..., 576] previous granule's inverted
    subband samples (flat t*32 + sb); block_type: [..., 2T]. Returns
    (spectra [..., 2T, 576], signed [..., 2T, 576])."""
    lead = S.shape[:-2]
    n_gran = S.shape[-2] // 18
    flat = S.reshape(*lead, n_gran, 576)
    signed = flat * constant("sign_flat", S.device)
    ext = torch.cat([overlap[..., None, :], signed], dim=-2)
    prev = ext[..., :n_gran, :]
    cur = ext[..., 1:, :]
    all_laws = torch.matmul(prev, constant("mdct_p", S.device)) + torch.matmul(
        cur, constant("mdct_c", S.device)
    )
    long_aliased = all_laws[..., :576]
    short = all_laws[..., 576:1152]
    head36 = all_laws[..., 1152:]
    bt = block_type[..., None]
    out = torch.where(bt == BLOCK_LONG, long_aliased, short)
    mixed = torch.cat([head36, short[..., 36:]], dim=-1)
    out = torch.where(bt == BLOCK_MIXED, mixed, out)
    return out, signed


# --- Gains and the rate loop ---------------------------------------------------


def initial_gain(spectrum: torch.Tensor, iso: bool = False) -> torch.Tensor:
    """210 + trunc(mult*log2(peak^0.75/15)), clamped 0-255; 210 for silent
    granules (dsp.py:775-787). mult = 4, or 16/3 under the ISO law."""
    peak = torch.amax(torch.abs(spectrum), dim=-1)
    ratio = torch.pow(peak, 0.75) / 15.0
    safe_ratio = torch.clamp(ratio, min=1e-30)
    mult = float(np.float32(16.0 / 3.0)) if iso else 4.0
    gain = 210 + torch.trunc(mult * torch.log2(safe_ratio)).to(_I32)
    gain = torch.clamp(gain, 0, 255)
    return torch.where(peak > 0, gain, 210).to(_I32)


def mean_square(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1) / float(x.shape[-1])


def quantize_at_gains(
    mag: torch.Tensor, sign_neg: torch.Tensor, gains: torch.Tensor, iso: bool = False
) -> torch.Tensor:
    """Quantize |x|^0.75 magnitudes at several gains (dsp.py:816-843, table-15
    cap). mag, sign_neg: [..., 576]; gains: [..., K] int32. Returns signed
    q [..., K, 576] int32: min(floor(mag*inv + 0.5), 15), rounded after the
    product and after the sum, as the reference."""
    inv = inv_step_table(iso, mag.device)[torch.clamp(gains, 0, 255).long()]
    scaled = mag[..., None, :] * inv[..., :, None]
    q = torch.clamp(torch.floor(scaled + 0.5), max=15.0).to(_I32)
    return torch.where(sign_neg[..., None, :], -q, q)


def rate_loop_precompute(
    spectrum: torch.Tensor, init_gain: torch.Tensor, iso: bool = False
) -> dict:
    """Budget-independent half of the gain walk (dsp.py:874-914): the
    20-candidate table-15 bit counts, through the rate-sweep kernel."""
    absx = torch.clamp(torch.abs(spectrum), min=1e-10)
    mag = torch.pow(absx, 0.75)
    sign_neg = spectrum < 0

    g0 = torch.clamp(init_gain, 0, 255)
    q0 = quantize_at_gains(mag, sign_neg, g0[..., None], iso=iso)[..., 0, :]
    allzero0 = ~torch.any(q0 != 0, dim=-1)

    gstart = torch.where(allzero0, torch.clamp(g0 - 40, min=0), g0).to(_I32)
    k_budget = torch.where(allzero0, N_GAIN_CANDIDATES - 1, N_GAIN_CANDIDATES)

    k = torch.arange(N_GAIN_CANDIDATES, dtype=_I32, device=spectrum.device)
    gains = gstart[..., None] + 4 * k
    bits, bv = kernels.rate_sweep(mag.contiguous(), gstart.contiguous(), iso=iso)
    evaluated = (k == 0) | (gains < 255)
    return {
        "mag": mag,
        "sign_neg": sign_neg,
        "gstart": gstart,
        "k_budget": k_budget.to(_I32),
        "bits": bits,
        "bv": bv,
        "evaluated": evaluated,
        "iso": iso,
    }


def rate_loop_select(
    bits: torch.Tensor,
    evaluated: torch.Tensor,
    k_budget: torch.Tensor,
    max_bits: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Budget-dependent selection (dsp.py:917-939): the first evaluated
    in-budget candidate that fits wins, else the last evaluated one.
    Returns (k_sel, has_fit, bits_sel)."""
    k = torch.arange(N_GAIN_CANDIDATES, dtype=_I32, device=bits.device)
    in_budget = k < k_budget[..., None]
    fits = evaluated & in_budget & (bits <= max_bits[..., None])
    has_fit = torch.any(fits, dim=-1)
    k_fit = torch.argmax(fits.to(_I32), dim=-1)
    k_eval = torch.where(evaluated & in_budget, k, -1)
    k_last = torch.amax(k_eval, dim=-1)
    k_sel = torch.where(has_fit, k_fit, k_last).to(_I32)
    bits_sel = torch.gather(bits, -1, k_sel[..., None].long())[..., 0]
    return k_sel, has_fit, bits_sel


def rate_loop_finalize(
    pre: dict, k_sel: torch.Tensor, has_fit: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-quantize at the selected gains (dsp.py:942-957). Returns
    (gain_reported, quantized, big_values); on overflow (no fit) the
    reported gain is stepped once past the gain used, capped at 255."""
    gains_sel = pre["gstart"] + 4 * k_sel
    q_sel = quantize_at_gains(
        pre["mag"], pre["sign_neg"], gains_sel[..., None], iso=pre["iso"]
    )[..., 0, :]
    bv_sel = torch.gather(pre["bv"], -1, k_sel[..., None].long())[..., 0]
    gain_out = torch.where(has_fit, gains_sel, torch.clamp(gains_sel + 4, max=255))
    return gain_out.to(_I32), q_sel, bv_sel


# --- VBR and bitrate tables ----------------------------------------------------


def vbr_choose_bitrate(
    energy: torch.Tensor,
    ehist: torch.Tensor,
    ecount: torch.Tensor,
    base: int,
    quality: int,
) -> torch.Tensor:
    """The reference's energy VBR law (dsp.py:1231-1254). ehist: [..., 10]
    with zeros in unused slots; ecount: [...] valid count."""
    have = ecount > 0
    avg = torch.where(
        have, torch.sum(ehist, dim=-1) / torch.clamp(ecount, min=1).to(_F32), energy
    )
    ratio = torch.clamp(energy / torch.clamp(avg, min=1e-4), 0.5, 2.0)
    quality_factor = np.float32(9 - quality) / np.float32(9.0)
    max_adjustment = int(np.float32(32.0) + np.float32(32.0) * quality_factor)
    adjustment = torch.trunc((ratio - 1.0) * float(max_adjustment)).to(_I32)
    min_bitrate = max(32, base - 64 + quality * 8)
    max_bitrate = min(320, base + 64 - quality * 4)
    # max-of-min, not clip: the reference's max() wins when min > max
    return torch.clamp(torch.clamp(base + adjustment, max=max_bitrate), min=min_bitrate)


def bitrate_index_device(bitrate: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Closest-match bitrate index, earliest on ties (dsp.py:1257-1262)."""
    name = "bitrates_v1" if sample_rate >= 32000 else "bitrates_v2"
    t = constant(name, bitrate.device)
    return torch.argmin(torch.abs(t - bitrate[..., None]), dim=-1).to(_I32)


def bitrate_value_device(index: torch.Tensor) -> torch.Tensor:
    return constant("bitrates_v1", index.device)[index.long()]


# --- Emission: regions, preflag, table-15 chunks --------------------------------


def region_counts(
    big_values: torch.Tensor, sample_rate: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """region0/region1 from the band boundaries (dsp.py:1134-1152)."""
    bounds = region_bounds(sample_rate, big_values.device)
    n_bounds = bounds.shape[0]
    c_all = torch.sum((bounds <= (big_values * 2)[..., None]).to(_I32), dim=-1)
    region0 = torch.clamp(torch.clamp(c_all, max=15) - 1, min=0)
    start = region0 + 1
    n_sat = torch.clamp(
        torch.clamp(torch.minimum(c_all, start + 7), max=n_bounds) - start, min=0
    )
    region1 = torch.clamp(n_sat - 1, min=0)
    return region0.to(_I32), torch.clamp(region1, max=7).to(_I32)


def preflag(spectrum: torch.Tensor) -> torch.Tensor:
    """Top-quarter energy > 1.5x the rest (dsp.py:1185-1190)."""
    hi = spectrum[..., 432:]
    lo = spectrum[..., :432]
    return (torch.sum(hi * hi, dim=-1) > torch.sum(lo * lo, dim=-1) * 1.5).to(_I32)


def pair_chunks_device(
    q: torch.Tensor, big_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pair table-15 (chunk, nbits), masked beyond big_values
    (dsp.py:1032-1056): codeword, then the sign of x if |x| > 0, then the
    sign of y. q: [..., 576] int32. Returns two [..., 288] int32."""
    x = q[..., 0::2]
    y = q[..., 1::2]
    ax = torch.clamp(torch.abs(x), max=15)
    ay = torch.clamp(torch.abs(y), max=15)
    idx = (ax * 16 + ay).long()
    code = constant("t15_code", q.device)[idx]
    nbits = constant("t15_len", q.device)[idx]
    has_x = ax != 0
    chunk = torch.where(has_x, (code << 1) | (x < 0).to(_I32), code)
    nbits = nbits + has_x.to(_I32)
    has_y = ay != 0
    chunk = torch.where(has_y, (chunk << 1) | (y < 0).to(_I32), chunk)
    nbits = nbits + has_y.to(_I32)
    pair_idx = torch.arange(288, dtype=_I32, device=q.device)
    mask = pair_idx < big_values[..., None]
    return torch.where(mask, chunk, 0), torch.where(mask, nbits, 0)

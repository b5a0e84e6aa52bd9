"""Batched granule DSP of the compat, spec_strict and hq chunk programs
(distortion control and intensity stereo included), at MPEG-1 and LSF
rates, in PyTorch.

Twin of `swiftmp3_tpu.ops.dsp` for the ops those presets run. Same shapes and
layouts as the JAX functions (batch-leading, [..., 576] granule rows), same
float32 operation order where the JAX code fixes one.

The JAX module avoids TPU gathers with where-tree lookups, exact `ldexp`
step reconstruction, one-hot selects and static slice/transpose reorders.
Here the same values come the way a GPU computes them: small tables indexed
directly and index gathers. The tables are built from the port's own copy of
the ISO tables (`swiftmp3_tpu_torch.tables`) in numpy float64 exactly as the
JAX module builds its constants (tests hold them equal bit for bit).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import (
    ALIASING_CA,
    ALIASING_CS,
    ANALYSIS_MATRIX,
    BITRATE_TABLE_V1,
    BITRATE_TABLE_V2,
    COUNT1A_CODE,
    COUNT1A_LEN,
    HUFFMAN_TABLES,
    ISO_WINDOW,
    LINBITS_24,
    LONG_MDCT_MATRIX,
    LONG_WINDOW,
    QCAP_LINBITS,
    SHORT_MDCT_MATRIX,
    SHORT_WINDOW,
    START_WINDOW,
    STOP_WINDOW,
    TABLE15_CODE,
    TABLE15_LEN,
    band_table,
    mixed_reorder_src,
    short_band_bounds,
    short_reorder_src,
    table_for_max,
)

from . import kernels

BLOCK_LONG = 0
BLOCK_MIXED = 1
BLOCK_SHORT = 2
# window_sequencing's transition windows: long layout, except for the
# switching 36/576 entropy regions
BLOCK_START = 3
BLOCK_STOP = 4

# window_sequencing's want detector: a block fires on a rise past ONSET_RATIO
# x the quieter of the two before it, or a drop past OFFSET_RATIO x the
# quieter of the two after it (copies of swiftmp3_tpu/ops/reference.py
# ONSET_RATIO / OFFSET_RATIO; tests hold them equal)
ONSET_RATIO = 4.0
OFFSET_RATIO = 4.5

N_GAIN_CANDIDATES = kernels.N_GAIN_CANDIDATES
PART23_MAX_BITS = 4095  # part2_3_length is a 12-bit field

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


def build_mdct_fold(iso_mixed_alias: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """MDCT fold (twin of dsp._build_mdct_fold's "p"/"c", or "p_iso"/"c_iso"
    with iso_mixed_alias): window x MDCT matrix x norm (x aliasing) as
    [576, 1188] matrices over the flat (t*32 + sb) granule layout. Columns
    0-575: aliased long law; 576-1151: short law; 1152-1187: the mixed
    granules' long head, unaliased (compat) or with the subband 0/1
    butterfly folded in (iso_mixed_alias, the one boundary an ISO decoder
    inverts for mixed blocks)."""
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

    if iso_mixed_alias:
        A1 = np.eye(576)
        for i in range(8):
            pu, pl = 17 - i, 18 + i  # subband 0 top / subband 1 bottom
            A1[pu, pu] = cs[i]
            A1[pl, pu] = ca[i]
            A1[pl, pl] = cs[i]
            A1[pu, pl] = -ca[i]
        head_p, head_c = (Lp @ A1)[:, :36], (Lc @ A1)[:, :36]
    else:
        head_p, head_c = Lp[:, :36], Lc[:, :36]
    MP = np.concatenate([Lp @ A, Sp, head_p], axis=1)
    MC = np.concatenate([Lc @ A, Sc, head_c], axis=1)
    return MP.astype(np.float32), MC.astype(np.float32)


def build_mdct_transition_ratios() -> tuple[np.ndarray, np.ndarray]:
    """The START and STOP windows as input ratios over the flat (t*32 + sb)
    layout, [576] each (twin of the r_start / r_stop of
    dsp._build_mdct_fold): each transition window differs from the long one
    on one half only (START: the current half, STOP: the overlap half), so
    scaling that half's input samples by START/LONG (STOP/LONG) makes the
    aliased long columns of the fold compute the transition law."""
    W36 = np.asarray(LONG_WINDOW, dtype=np.float64)
    r_start = np.repeat(np.asarray(START_WINDOW, dtype=np.float64)[18:] / W36[18:], 32)
    r_stop = np.repeat(np.asarray(STOP_WINDOW, dtype=np.float64)[:18] / W36[:18], 32)
    return r_start.astype(np.float32), r_stop.astype(np.float32)


def build_sign_flat() -> np.ndarray:
    """[576] frequency-inversion signs in (t*32 + sb) order: -1 where the
    within-granule time index and the subband are both odd."""
    t_odd = (np.arange(18) % 2 == 1)[:, None]
    sb_odd = (np.arange(32) % 2 == 1)[None, :]
    return np.where(t_odd & sb_odd, -1.0, 1.0).astype(np.float32).reshape(576)


def build_inv_step_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-gain float32 inverse quantizer steps, g = 0..255.

    Compat law: f32(1) / f32(max(2^((g-210)/4), 1e-4)) (dsp.py:87-99).
    ISO law: f32(max(2^((g-210)/4), 1e-4)^-0.75) (dsp.py:182-190).
    ISO law without the 1e-4 step floor, which the linbits law quantizes
    with: f32((2^((g-210)/4))^-0.75) (reference.ISO_INV_STEP34_NOFLOOR)."""
    g = np.arange(256, dtype=np.float64)
    pure = 2.0 ** ((g - 210.0) / 4.0)
    step = np.maximum(pure, 0.0001)
    inv = (np.float32(1.0) / step.astype(np.float32)).astype(np.float32)
    inv34 = (step ** -0.75).astype(np.float32)
    return inv, inv34, (pure ** -0.75).astype(np.float32)


def build_region_bounds(sample_rate: int) -> np.ndarray:
    return np.cumsum(band_table(sample_rate)).astype(np.int32)  # [21]


# The reference reverses the 512 buffer before windowing; the constants fold
# the reversal in (twins of dsp._WINDOW_REV and dsp._MATRIX_REV_T).
WINDOW_REV = np.ascontiguousarray(ISO_WINDOW[::-1], dtype=np.float32)  # [512]
MATRIX_REV_T = np.ascontiguousarray(ANALYSIS_MATRIX[:, ::-1].T, dtype=np.float32)  # [64, 32]
POLY_FOLD = build_polyphase_fold()
MDCT_FOLD_P, MDCT_FOLD_C = build_mdct_fold()
MDCT_FOLD_P_ISO, MDCT_FOLD_C_ISO = build_mdct_fold(iso_mixed_alias=True)
MDCT_R_START, MDCT_R_STOP = build_mdct_transition_ratios()
SIGN_FLAT = build_sign_flat()
INV_STEP, INV_STEP34, INV_STEP34_NOFLOOR = build_inv_step_tables()
T15_LEN = TABLE15_LEN.astype(np.int32)  # [256]
T15_CODE = TABLE15_CODE.astype(np.int32)  # [256]
BITRATE_VALUES = np.asarray(BITRATE_TABLE_V1, dtype=np.int32)
BITRATE_VALUES_V2 = np.asarray(BITRATE_TABLE_V2, dtype=np.int32)

_CONSTANTS = {
    "window_rev": WINDOW_REV,
    "matrix_rev_t": MATRIX_REV_T,
    "poly_fold": POLY_FOLD,
    "mdct_p": MDCT_FOLD_P,
    "mdct_c": MDCT_FOLD_C,
    "mdct_p_iso": MDCT_FOLD_P_ISO,
    "mdct_c_iso": MDCT_FOLD_C_ISO,
    "mdct_r_start": MDCT_R_START,
    "mdct_r_stop": MDCT_R_STOP,
    "sign_flat": SIGN_FLAT,
    "inv_step": INV_STEP,
    "inv_step34": INV_STEP34,
    "inv_step34_nofloor": INV_STEP34_NOFLOOR,
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


def inv_step_table(iso: bool, device: torch.device, floor: bool = True) -> torch.Tensor:
    """The inverse steps by gain: compat law, or the ISO law with or
    without (floor=False, the linbits law) the 1e-4 step floor."""
    if not iso:
        return constant("inv_step", device)
    return constant("inv_step34" if floor else "inv_step34_nofloor", device)


# --- Ingest and stereo --------------------------------------------------------


def ingest(pcm: torch.Tensor) -> torch.Tensor:
    """int16 PCM x 1/32768 (exact in float32), else float32 with non-finite
    samples zeroed (pipeline.py:195-205)."""
    if pcm.dtype == torch.int16:
        return pcm.to(_F32) * (1.0 / 32768.0)
    return torch.nan_to_num(pcm.to(_F32), nan=0.0, posinf=0.0, neginf=0.0)


def ms_energies(
    left: torch.Tensor, right: torch.Tensor, iso_matrix: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mid, side, mid energy, side energy) of a frame pair [..., 1152]:
    (L +- R)/2, or (L +- R)/sqrt(2) under iso_matrix."""
    half = float(np.float32(1.0 / np.sqrt(2.0))) if iso_matrix else 0.5
    mid = (left + right) * half
    side = (left - right) * half
    n = float(left.shape[-1])
    return mid, side, torch.sum(mid * mid, dim=-1) / n, torch.sum(side * side, dim=-1) / n


def stereo_decide(
    left: torch.Tensor,
    right: torch.Tensor,
    iso_matrix: bool = False,
    symmetric: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint-stereo M/S decision per frame (dsp.py:1196-1221): M/S when side
    energy < 0.4 x mid energy. iso_matrix: (L +- R)/sqrt(2) in place of the
    compat /2 (the decision is scale-invariant); symmetric
    (options.ms_symmetric): also M/S when mid energy < 0.4 x side energy.
    left/right: [..., 1152]. Returns (use_ms [...] bool, ch0, ch1)."""
    mid, side, mid_e, side_e = ms_energies(left, right, iso_matrix)
    use_ms = side_e < mid_e * 0.4
    if symmetric:
        use_ms = use_ms | (mid_e < side_e * 0.4)
    ch0 = torch.where(use_ms[..., None], mid, left)
    ch1 = torch.where(use_ms[..., None], side, right)
    return use_ms, ch0, ch1


# --- Polyphase analysis filterbank ---------------------------------------------


def polyphase_chunk_matmul(
    hist: torch.Tensor, pcm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ISO analysis filterbank over a whole chunk as five folded
    [128, 128] fp32 matmuls (dsp.py:311-348). hist: [..., 480]; pcm:
    [..., n*32] for n windows (36 a frame at MPEG-1, 18 at LSF rates).
    Returns (S [..., n, 32], full signal x [..., 480 + n*32]). The folded
    form packs 4 windows a row: an LSF chunk of an odd number of frames
    (n % 4 == 2) is padded with zero windows whose rows are sliced off
    before they reach anything."""
    x_full = torch.cat([hist, pcm], dim=-1)
    L = x_full.shape[-1]
    n_win = (L - 480) // 32
    n_pad = (-n_win) % 4
    x = torch.nn.functional.pad(x_full, (0, 32 * (n_pad + 1)))
    R_out = (n_win + n_pad) // 4
    A = x.reshape(*x.shape[:-1], (L + 32 * (n_pad + 1)) // 128, 128)
    fold = constant("poly_fold", x.device)
    S4 = None
    for d in range(5):
        term = torch.matmul(A[..., d : d + R_out, :], fold[d])
        S4 = term if S4 is None else S4 + term
    S = S4.reshape(*S4.shape[:-2], n_win + n_pad, 32)
    return S[..., :n_win, :], x_full


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
    S: torch.Tensor,
    overlap: torch.Tensor,
    block_type: torch.Tensor,
    iso_mixed_alias: bool = False,
    window_seq: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MDCT for all 2T granules of a chunk (dsp.py:556-618): long, short and
    mixed laws from one fold; iso_mixed_alias (options.iso_short_blocks)
    folds the subband 0/1 butterfly into the mixed granules' long head.
    window_seq (options.window_sequencing): START and STOP granules scale
    the current (START) or overlap (STOP) half of their input by the
    transition window's ratio to the long one and take the aliased long
    law.

    S: [..., 36T, 32]; overlap: [..., 576] previous granule's inverted
    subband samples (flat t*32 + sb); block_type: [..., 2T]. Returns
    (spectra [..., 2T, 576], signed [..., 2T, 576], the unscaled input)."""
    lead = S.shape[:-2]
    n_gran = S.shape[-2] // 18
    flat = S.reshape(*lead, n_gran, 576)
    signed = flat * constant("sign_flat", S.device)
    ext = torch.cat([overlap[..., None, :], signed], dim=-2)
    prev = ext[..., :n_gran, :]
    cur = ext[..., 1:, :]
    if window_seq:
        bt_in = block_type[..., None]
        prev = prev * torch.where(bt_in == BLOCK_STOP, constant("mdct_r_stop", S.device), 1.0)
        cur = cur * torch.where(bt_in == BLOCK_START, constant("mdct_r_start", S.device), 1.0)
    sfx = "_iso" if iso_mixed_alias else ""
    all_laws = torch.matmul(prev, constant("mdct_p" + sfx, S.device)) + torch.matmul(
        cur, constant("mdct_c" + sfx, S.device)
    )
    long_aliased = all_laws[..., :576]
    short = all_laws[..., 576:1152]
    head36 = all_laws[..., 1152:]
    bt = block_type[..., None]
    out = torch.where(bt == BLOCK_LONG, long_aliased, short)
    mixed = torch.cat([head36, short[..., 36:]], dim=-1)
    out = torch.where(bt == BLOCK_MIXED, mixed, out)
    if window_seq:
        out = torch.where((bt == BLOCK_START) | (bt == BLOCK_STOP), long_aliased, out)
    return out, signed


# --- ISO window sequencing (twin of dsp.py:648-773) ------------------------------


def onset_wants_chunk(
    granules: torch.Tensor, prev2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Onset/drop short wants over a chain of 96-sample block energies that
    runs across granules and chunks (dsp.py:648-700). granules: [..., G,
    576] raw PCM; prev2: [..., 2] the two block energies before the first
    granule, +inf where the past is unknown. A block fires its granule when
    its energy passes ONSET_RATIO x the quieter of the two blocks before it;
    a loud block fires the granule holding its quiet aftermath when it
    passes OFFSET_RATIO x the quieter of the two blocks after it. The +inf
    sentinel only meets comparisons and max/min, never a product: no rise
    over an unknown past, no drop from it, none into the unknown future.
    Returns (wants [..., G] bool, tails [..., G, 2]: each granule's last two
    block energies, the next granule's prev2)."""
    lead = granules.shape[:-2]
    G = granules.shape[-2]
    sub = granules.reshape(*lead, G * 6, 96)
    e = torch.sum(sub * sub, dim=-1) / 96.0
    chain = torch.cat([prev2.to(_F32), e], dim=-1)  # e[b] at chain index b + 2
    base = torch.minimum(chain[..., :-2], chain[..., 1:-1])
    rise = e > ONSET_RATIO * torch.clamp(base, min=1e-4)
    wants = torch.any(rise.reshape(*lead, G, 6), dim=-1)
    inf_pad = torch.full((*lead, 2), float("inf"), dtype=_F32, device=e.device)
    ext = torch.cat([chain, inf_pad], dim=-1)
    loud = ext[..., :-2]  # chain index l fires granule l // 6
    quiet = torch.minimum(ext[..., 1:-1], ext[..., 2:])
    drop = torch.isfinite(loud) & (loud > OFFSET_RATIO * torch.clamp(quiet, min=1e-4))
    wants = wants | torch.any(drop[..., : G * 6].reshape(*lead, G, 6), dim=-1)
    return wants, e.reshape(*lead, G, 6)[..., 4:6]


def sequence_blocks_chunk(
    want: torch.Tensor,
    want_next: torch.Tensor,
    valid_g: torch.Tensor,
    prev_short: torch.Tensor,
    prev_want: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ISO window sequencing over a chunk's granules (dsp.py:726-773).

    want, want_next, valid_g: [B, G] bool, the granule's and the next
    granule's raw short wants and the valid mask (a prefix per stream, as
    the chunk program's contract has it); prev_short, prev_want: [B], the
    previous granule's emitted-short state and raw want. A granule's want
    is its raw want or the previous granule's (a one-granule hangover); it
    is SHORT when it wants or when the previous granule was short and the
    next wants; else START before a wanting granule, STOP after a short one,
    LONG otherwise. Invalid granules read the state of the last valid one
    and leave it unchanged. Returns (block [B, G] int32, prev_short,
    prev_want at the last valid granule).

    The reference scans the granules one by one. Here the recurrence
    s[g] = w[g] | (wn[g] & s[g-1]) is solved in closed form over the valid
    prefix: s[g] holds when the last granule j <= g with w[j] has no
    granule in (j, g] without wn, or when prev_short does and no granule in
    [0, g] is without wn; two running maxima of indices find both."""
    B, G = want.shape
    dev = want.device
    pos = torch.arange(G, device=dev).expand(B, G)
    n = torch.sum(valid_g, dim=1)  # the valid prefix's length
    last = torch.clamp(n - 1, min=0)[:, None]
    has = n > 0
    # the raw want before each granule: the carry, then the previous
    # granule's; past the prefix, the last valid granule's
    last_want = torch.where(has, torch.gather(want, 1, last)[:, 0], prev_want)
    pw = torch.cat([prev_want[:, None], want[:, :-1]], dim=1)
    invalid = pos >= n[:, None]
    pw = torch.where(invalid, last_want[:, None], pw)
    w = want | pw
    wn = want_next | want
    last_w = torch.cummax(torch.where(w, pos, -1), dim=1).values
    last_no_wn = torch.cummax(torch.where(wn, -1, pos), dim=1).values
    s = ((last_w >= 0) & (last_w >= last_no_wn)) | (prev_short[:, None] & (last_no_wn < 0))
    last_short = torch.where(has, torch.gather(s, 1, last)[:, 0], prev_short)
    ps = torch.cat([prev_short[:, None], s[:, :-1]], dim=1)
    ps = torch.where(invalid, last_short[:, None], ps)
    s = torch.where(invalid, w | (last_short[:, None] & wn), s)
    block = torch.where(
        s,
        BLOCK_SHORT,
        torch.where(wn, BLOCK_START, torch.where(ps, BLOCK_STOP, BLOCK_LONG)),
    ).to(_I32)
    return block, last_short, last_want


# --- Lowpass --------------------------------------------------------------------


def adaptive_lowpass_engage(spectra: torch.Tensor, cut_sb: int) -> torch.Tensor:
    """The adaptive lowpass decision per granule (dsp.py:702-725): engage the
    cut where the high band (coefficients from cut_sb * 18 up) is negligible
    (energy fraction < 1e-3) or noise-like (spectral flatness > 0.15); a
    peaky harmonic high band keeps the full band. Both statistics ignore
    the coefficients' order, so the decision holds for every block layout.
    spectra: [..., 576] float32. Returns bool [...]."""
    spec = spectra.to(_F32)
    hb2 = spec[..., cut_sb * 18 :] ** 2
    m_hb = torch.mean(hb2, dim=-1)
    m_tot = torch.mean(spec * spec, dim=-1)
    frac = m_hb * float(hb2.shape[-1]) / torch.clamp(m_tot * float(spec.shape[-1]), min=1e-30)
    sfm = torch.exp(torch.mean(torch.log(hb2 + 1e-20), dim=-1)) / (m_hb + 1e-20)
    # the thresholds as float32, as the reference compares them
    return (frac < float(np.float32(1e-3))) | (sfm > float(np.float32(0.15)))


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
    mag: torch.Tensor,
    sign_neg: torch.Tensor,
    gains: torch.Tensor,
    iso: bool = False,
    qcap: int = 15,
    floor: bool = True,
) -> torch.Tensor:
    """Quantize |x|^0.75 magnitudes at several gains (dsp.py:816-843). mag,
    sign_neg: [..., 576]; gains: [..., K] int32. Returns signed q [..., K,
    576] int32: min(floor(mag*inv + 0.5), qcap), rounded after the product
    and after the sum, as the reference. The linbits law passes
    qcap=QCAP_LINBITS and floor=False (the ISO step without its 1e-4
    floor). The cap applies before the conversion to int32, so no product
    past the int32 range reaches it."""
    inv = inv_step_table(iso, mag.device, floor)[torch.clamp(gains, 0, 255).long()]
    scaled = mag[..., None, :] * inv[..., :, None]
    q = torch.clamp(torch.floor(scaled + 0.5), max=float(qcap)).to(_I32)
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
    max_adjustment, min_bitrate, max_bitrate = vbr_law(base, quality)
    adjustment = torch.trunc((ratio - 1.0) * float(max_adjustment)).to(_I32)
    # max-of-min, not clip: the reference's max() wins when min > max
    return torch.clamp(torch.clamp(base + adjustment, max=max_bitrate), min=min_bitrate)


def vbr_law(base: int, quality: int) -> tuple[int, int, int]:
    """The energy VBR law's constants at base kbps and quality: (the largest
    adjustment in kbps, the lowest and the highest bitrate)."""
    quality_factor = np.float32(9 - quality) / np.float32(9.0)
    max_adjustment = int(np.float32(32.0) + np.float32(32.0) * quality_factor)
    return max_adjustment, max(32, base - 64 + quality * 8), min(320, base + 64 - quality * 4)


def demand_vbr_bitrate(
    demand: torch.Tensor, slot_bits: torch.Tensor, cands: torch.Tensor
) -> torch.Tensor:
    """Each frame's demand-VBR bitrate: the smallest candidate whose slot
    covers the frame's priced demand [B], the band's top when none does."""
    fits = demand[:, None] <= slot_bits
    first = torch.argmax(fits.to(torch.int32), dim=1)
    return torch.where(torch.any(fits, dim=1), cands[first], cands[-1])


def demand_budget_bits(
    demand: torch.Tensor, total: torch.Tensor, equal: torch.Tensor
) -> torch.Tensor:
    """The donation law of demand_budget (pipeline.py:804-827): a frame's
    granules whose demand sits under the equal share donate their surplus,
    and granules over it split the donations by deficit, each budget capped
    at the 12-bit part2_3_length. An exact no-op on frames without both a
    surplus and a deficit. demand: [B, G] int32 priced bits at K_DEMAND;
    total: [B] the frame's bits (slot + usable reservoir); equal: [B] the
    equal split the frame keeps when no granule has demand. Returns the
    per-granule budgets [B, G] int32."""
    n_gran = demand.shape[-1]
    i32 = torch.int32
    share = (total // n_gran)[:, None]
    surplus = torch.clamp(share - demand, min=0)
    deficit = torch.clamp(demand - share, min=0)
    pool = torch.sum(surplus, dim=-1, keepdim=True, dtype=i32)
    need = torch.sum(deficit, dim=-1, keepdim=True, dtype=i32)
    take = torch.minimum(pool, need)
    prop = (
        share
        - (surplus * take) // torch.clamp(pool, min=1)
        + (take * deficit) // torch.clamp(need, min=1)
    )
    prop = torch.clamp(prop, max=PART23_MAX_BITS)
    has_demand = torch.sum(demand, dim=-1, keepdim=True, dtype=i32) > 0
    return torch.where(has_demand, prop, equal[:, None]).to(i32)


def bitrate_index_device(bitrate: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Closest-match bitrate index, earliest on ties (dsp.py:1257-1262)."""
    name = "bitrates_v1" if sample_rate >= 32000 else "bitrates_v2"
    t = constant(name, bitrate.device)
    return torch.argmin(torch.abs(t - bitrate[..., None]), dim=-1).to(_I32)


def bitrate_value_device(index: torch.Tensor, lsf: bool = False) -> torch.Tensor:
    """The bitrate (kbps) of each index, from the MPEG-1 table or at LSF
    rates the MPEG-2 one (dsp.py:1269-1270)."""
    return constant("bitrates_v2" if lsf else "bitrates_v1", index.device)[index.long()]


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


# --- Spec-strict entropy layout (twin of dsp.py:1273-1880) ------------------------
# The JAX module reads the strict tables through nibble/halfword where-trees
# (no TPU gathers). Here each is a small table indexed directly; the tests hold
# every entry equal to the JAX lookup over its whole index range.

_STRICT_TIDS = (1, 2, 5, 7, 15)  # the ids table_for_max selects (0: nothing coded)
_ESC_TIDS = tuple(range(24, 32))  # the linbits family: table 24's codes, own widths
N_TIDS = 32


def build_pair_tables() -> tuple[np.ndarray, np.ndarray]:
    """Pair code lengths and codes by table id, [32, 256] int32: row tid,
    column min(x, 15)*16 + min(y, 15) in the 16x16 layout, zeros outside
    each table's (max_value + 1)^2 corner and in the rows of ids never
    selected (0 included). Ids 24-31 share table 24's rows."""
    lens = np.zeros((N_TIDS, 16, 16), np.int32)
    codes = np.zeros((N_TIDS, 16, 16), np.int32)
    for tid in _STRICT_TIDS + _ESC_TIDS:
        t = HUFFMAN_TABLES[min(tid, 24)]
        n = t.max_value + 1
        lens[tid, :n, :n] = t.lengths
        codes[tid, :n, :n] = t.codes
    return lens.reshape(N_TIDS, 256), codes.reshape(N_TIDS, 256)


PAIR_LEN, PAIR_CODE = build_pair_tables()
# linbits width by table id (ISO B.7 headers of the 24 family; 0 elsewhere)
LINBITS_OF_TID = np.zeros(N_TIDS, dtype=np.int32)
LINBITS_OF_TID[24:] = LINBITS_24
_Q16 = (np.arange(16) != 0).astype(np.int32)
_E16 = (np.arange(16) == 15).astype(np.int32)  # an escaped coordinate (|v| >= 15)
# a coded pair's bits under table tid: code length + one sign bit per nonzero
# coordinate + the id's linbits width per escaped coordinate
PAIR_COST = (
    PAIR_LEN
    + (_Q16[:, None] + _Q16[None, :]).reshape(1, 256)
    + LINBITS_OF_TID[:, None] * (_E16[:, None] + _E16[None, :]).reshape(1, 256)
)
PAIR_COST[0] = 0
TABLE_FOR_MAX = np.array([table_for_max(m) for m in range(16)], dtype=np.int32)
# a region maximum m > 15 takes the first 24-family id whose width holds
# m - 15: id 24 + the number of these bounds below m - 15
ESC_BOUNDS = np.array([(1 << lb) - 1 for lb in LINBITS_24[:-1]], dtype=np.int32)
COUNT1A_LEN_T = COUNT1A_LEN.astype(np.int32)
COUNT1A_CODE_T = COUNT1A_CODE.astype(np.int32)

# scalefac_compress -> (slen1, slen2), ISO 2.4.2.7 (a copy of
# swiftmp3_tpu/ops/reference.py:SLEN_TABLE; tests hold it equal)
SLEN_TABLE = (
    (0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
    (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3),
)
SLEN1 = np.array([a for a, _ in SLEN_TABLE], dtype=np.int32)
SLEN2 = np.array([b for _, b in SLEN_TABLE], dtype=np.int32)
# bits to hold a scalefactor value 0..15
SF_BITLEN = np.array([0, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4], dtype=np.int32)


def build_compress_for_need() -> np.ndarray:
    """[5 * 5] int32: the smallest scalefac_compress whose (slen1, slen2)
    hold (need1, need2) bits, 15 when none does (twin of the descending
    where-chain of dsp._sf_finish_device), index need1 * 5 + need2."""
    out = np.full((5, 5), 15, dtype=np.int32)
    for n1 in range(5):
        for n2 in range(5):
            for c in range(15, -1, -1):
                s1, s2 = SLEN_TABLE[c]
                if n1 <= s1 and n2 <= s2:
                    out[n1, n2] = c
    return out.reshape(25)


COMPRESS_FOR_NEED = build_compress_for_need()
SF_MULT34 = (2.0 ** (0.75 * np.arange(16, dtype=np.float64))).astype(np.float32)
SF_SLOTS = 36  # scalefactor transmission slots per granule (reference.SF_SLOTS)
# scfsi band groups, ISO 2.4.2.7 (reference.SCFSI_GROUPS)
SCFSI_GROUPS = ((0, 6), (6, 11), (11, 16), (16, 21))
# LSF (ISO 13818-3 2.4.3.2) case-0 scalefactor groups, slots a group: long,
# short, and mixed (the 6-band long head, then short bands 3-11). Copies of
# swiftmp3_tpu/ops/reference.py LSF_NSF_LONG / _SHORT / _MIXED (tests hold
# them equal).
LSF_NSF_LONG = (6, 5, 5, 5)
LSF_NSF_SHORT = (9, 9, 9, 9)
LSF_NSF_MIXED = (6, 9, 9, 9)
# masking-driven scalefactors: spreading slope per band, share of the gap
# (reference.PSY_SLOPE, PSY_ALPHA_NUM / PSY_ALPHA_DEN)
PSY_SLOPE = 4
PSY_ALPHA_NUM, PSY_ALPHA_DEN = 1, 2

_CONSTANTS.update(
    {
        "pair_len": PAIR_LEN.reshape(-1),
        "pair_code": PAIR_CODE.reshape(-1),
        "pair_cost": PAIR_COST.reshape(-1),
        "table_for_max": TABLE_FOR_MAX,
        "linbits_of_tid": LINBITS_OF_TID,
        "esc_bounds": ESC_BOUNDS,
        "count1a_len": COUNT1A_LEN_T,
        "count1a_code": COUNT1A_CODE_T,
        "slen1": SLEN1,
        "slen2": SLEN2,
        "sf_bitlen": SF_BITLEN,
        "compress_for_need": COMPRESS_FOR_NEED,
        "sf_mult34": SF_MULT34,
    }
)


def _long_bounds(sample_rate: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(band_table(sample_rate))]).astype(np.int64)


def build_slot_maps(sample_rate: int, n_head: int = 8) -> np.ndarray:
    """[3, 576] int64: the scalefactor slot each natural coefficient takes
    its 2^(0.75 sf) amplification from, for the long, mixed and short slot
    layouts (rows in block-type order); SF_SLOTS marks coefficients with no
    scalefactor (amplification 1). Long: band b -> slot b. Short: short band
    s, window w (coefficient 3 * line + w) -> slot 3s + w. Mixed: the long
    head's n_head bands (8 at MPEG-1, 6 at LSF; they cover the first three
    short bands' lines either way) -> slots 0..n_head-1, short bands 3-11 ->
    slot n_head + 3(s - 3) + w."""
    lb = _long_bounds(sample_rate)
    sb = short_band_bounds(sample_rate)
    coef = np.arange(576)
    band = np.searchsorted(lb, coef, side="right") - 1  # 21 past the last band
    long_map = np.where(band < 21, band, SF_SLOTS)
    line, w = coef // 3, coef % 3
    sband = np.searchsorted(sb, line, side="right") - 1  # 12 = the uncoded tail
    short_map = np.where(sband < 12, 3 * sband + w, SF_SLOTS)
    head = 3 * int(sb[3])  # natural coefficients under the mixed long head
    mixed_map = np.where(
        coef < head, band, np.where(sband < 12, n_head + 3 * (sband - 3) + w, SF_SLOTS)
    )
    return np.stack([long_map, mixed_map, short_map]).astype(np.int64)


def build_reorder_perms(sample_rate: int) -> np.ndarray:
    """[3, 576] int64 source permutations natural -> ISO 2.4.3.4.8 stream
    order (stream[j] = natural[src[j]]) by block type: identity for long
    granules, tables.mixed_reorder_src, tables.short_reorder_src."""
    return np.stack(
        [np.arange(576), mixed_reorder_src(sample_rate), short_reorder_src(sample_rate)]
    ).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _rate_table(name: str, sample_rate: int, device: torch.device) -> torch.Tensor:
    if name == "slot_maps":
        arr = build_slot_maps(sample_rate)
    elif name == "slot_maps_lsf":
        arr = build_slot_maps(sample_rate, n_head=6)
    elif name == "reorder":
        arr = build_reorder_perms(sample_rate)
    elif name == "unreorder":
        arr = np.argsort(build_reorder_perms(sample_rate), axis=-1)
    else:  # region bounds with 576 past the last band (k = r0 + 1 + r1 <= 22)
        arr = np.concatenate([build_region_bounds(sample_rate), [576, 576]]).astype(np.int32)
    return torch.from_numpy(arr).to(device)


def reorder_natural_to_stream(x: torch.Tensor, sample_rate: int, mixed: bool) -> torch.Tensor:
    """x [..., 576] natural (subband-major) -> ISO stream order (short-sfb
    major, a band's three windows consecutive); mixed keeps the long head in
    place (dsp.py:2609-2632). One index gather."""
    return x[..., _rate_table("reorder", sample_rate, x.device)[1 if mixed else 2]]


def reorder_stream_to_natural(x: torch.Tensor, sample_rate: int, mixed: bool) -> torch.Tensor:
    """Inverse of reorder_natural_to_stream (dsp.py:2635-2658)."""
    return x[..., _rate_table("unreorder", sample_rate, x.device)[1 if mixed else 2]]


def _last_nonzero_count(q: torch.Tensor) -> torch.Tensor:
    """Count through the last nonzero coefficient, 0 if all zero."""
    idx = torch.arange(1, q.shape[-1] + 1, dtype=_I32, device=q.device)
    return torch.amax(torch.where(q != 0, idx, 0), dim=-1)


def _region_bounds(
    r0: torch.Tensor, r1: torch.Tensor, sample_rate: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b0, b1) value-index region boundaries as decoders read them
    (dsp.py:1454-1462): bounds[r0] and bounds[r0 + 1 + r1], 576 past the
    last band."""
    ext = _rate_table("bounds", sample_rate, r0.device)
    return ext[r0.long()], ext[(r0 + 1 + r1).long()]


def _count1_quads(flags: torch.Tensor, use2: torch.Tensor) -> torch.Tensor:
    """[..., 144, 4] quads of a [..., 576] int32 array at positions 0 + 4j,
    or (use2 [...]) 2 + 4j with the last quad zero."""
    q0 = flags.reshape(*flags.shape[:-1], 144, 4)
    q2 = torch.nn.functional.pad(flags[..., 2:574].reshape(*flags.shape[:-1], 143, 4), (0, 0, 0, 1))
    return torch.where(use2[..., None, None], q2, q0)


def _pair_regions(b0: torch.Tensor, b1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pair positions [288], each pair's region 0/1/2 [..., 288] int64) by
    the value-index boundaries b0 <= b1."""
    pairpos = torch.arange(0, 576, 2, dtype=_I32, device=b0.device)
    region = torch.where(
        pairpos < b0[..., None], 0, torch.where(pairpos < b1[..., None], 1, 2)
    )
    return pairpos, region


def _pair_tids(tids: list, region: torch.Tensor) -> torch.Tensor:
    """Each pair's table id from its region's [..., 288]."""
    return torch.gather(torch.stack(tids, dim=-1), -1, region)


def table_for_max_device(m: torch.Tensor, linbits: bool = False) -> torch.Tensor:
    """The smallest table for a region maximum m (dsp.py:1352-1381): 0, 1,
    2, 5, 7 or 15; with linbits, maxima above 15 take the smallest 24-family
    id whose linbits width holds m - 15 (tables.linbits_table_for_max)."""
    base = constant("table_for_max", m.device)[torch.clamp(m, max=15).long()]
    if not linbits:
        return base
    esc = 24 + torch.bucketize(m - 15, constant("esc_bounds", m.device), out_int32=True)
    return torch.where(m <= 15, base, esc)


def linbits_of_tid(tid: torch.Tensor) -> torch.Tensor:
    """The linbits width of each table id (dsp.py:1384-1391): 0 for the
    classic tables, the ISO B.7 width for ids 24-31."""
    return constant("linbits_of_tid", tid.device)[tid.long()]


def _pair_index(x: torch.Tensor, y: torch.Tensor, linbits: bool) -> torch.Tensor:
    """A pair's column in the [32, 256] tables: min(x, 15)*16 + min(y, 15)
    (escaped coordinates code as 15)."""
    if linbits:
        x, y = torch.clamp(x, max=15), torch.clamp(y, max=15)
    return x * 16 + y


def strict_layout_device(
    q: torch.Tensor,
    sample_rate: int,
    is_long: torch.Tensor,
    count1_coding: bool,
    region_table_select: bool,
    assume_abs: bool = False,
    linbits: bool = False,
    b0_switch: torch.Tensor | None = None,
) -> dict:
    """Layout integers of quantized spectra q [..., 576] int32 (dsp.py:
    1481-1601): big_values with the count1 region, region counts, per-region
    table ids, the count1 table and the bits of the pairs plus the quads.
    is_long [...] bool broadcasts against q's leading dims. assume_abs: q is
    already nonnegative and capped (the sweep). linbits: magnitudes up to
    QCAP_LINBITS, regions whose maximum passes 15 take a 24-family id and
    each escaped coordinate costs the id's linbits width. b0_switch [...]
    is the switching granules' region-0 line boundary at LSF rates
    (band-derived: 36 to 108 by rate and block type); None keeps the MPEG-1
    36."""
    dev = q.device
    cap = QCAP_LINBITS if linbits else 15
    av = q if assume_abs else torch.clamp(torch.abs(q), max=cap)
    pos = torch.arange(1, 577, dtype=_I32, device=dev)
    l0c = torch.amax(torch.where(av > 0, pos, 0), dim=-1)
    if count1_coding:
        c1c = torch.amax(torch.where(av > 1, pos, 0), dim=-1)
        bv2 = torch.clamp((c1c + 1) & ~1, max=576)
        n1 = (torch.clamp(l0c - bv2, min=0) + 3) // 4
        bv2 = torch.where(bv2 + 4 * n1 > 576, bv2 + 2, bv2)
        n1 = (torch.clamp(l0c - bv2, min=0) + 3) // 4
    else:
        bv2 = torch.clamp((l0c + 1) & ~1, max=576)
        n1 = torch.zeros_like(bv2)
    bv = bv2 >> 1

    r0, r1 = region_counts(bv, sample_rate)
    b0l, b1l = _region_bounds(r0, r1, sample_rate)
    b0 = torch.where(is_long, b0l, 36 if b0_switch is None else b0_switch)
    b1 = torch.where(is_long, b1l, 576)

    x = av[..., 0::2]
    y = av[..., 1::2]
    pairpos, region = _pair_regions(b0, b1)
    valid = pairpos < bv2[..., None]
    if region_table_select:
        m_pair = torch.maximum(x, y)
        tids = [
            table_for_max_device(
                torch.amax(torch.where((region == r) & valid, m_pair, 0), dim=-1), linbits
            )
            for r in range(3)
        ]
        tids[2] = torch.where(is_long, tids[2], 0)
    else:
        tids = [torch.full_like(bv, 15) for _ in range(3)]
    tid_pair = _pair_tids(tids, region)
    cost = constant("pair_cost", dev)[(tid_pair * 256 + _pair_index(x, y, linbits)).long()]
    pair_bits = torch.sum(torch.where(valid, cost, 0), dim=-1, dtype=_I32)

    if count1_coding:
        use2 = (bv2 & 2) == 2
        quads = _count1_quads((av > 0).to(_I32), use2)
        patt = quads[..., 0] * 8 + quads[..., 1] * 4 + quads[..., 2] * 2 + quads[..., 3]
        nsign = torch.sum(quads, dim=-1, dtype=_I32)
        qpos = torch.arange(0, 576, 4, dtype=_I32, device=dev)
        start = qpos + torch.where(use2, 2, 0)[..., None]
        vq = (start >= bv2[..., None]) & (start < (bv2 + 4 * n1)[..., None])
        len_a = constant("count1a_len", dev)[patt.long()]
        bits_a = torch.sum(torch.where(vq, len_a + nsign, 0), dim=-1, dtype=_I32)
        bits_b = torch.sum(torch.where(vq, 4 + nsign, 0), dim=-1, dtype=_I32)
        c1t = (bits_b < bits_a).to(_I32)
        c1_bits = torch.minimum(bits_a, bits_b)
    else:
        c1t = torch.zeros_like(bv)
        c1_bits = torch.zeros_like(bv)

    return {
        "bv": bv.to(_I32),
        "n1": n1.to(_I32),
        "c1t": c1t,
        "tid0": tids[0].to(_I32),
        "tid1": tids[1].to(_I32),
        "tid2": tids[2].to(_I32),
        "r0": r0,
        "r1": r1,
        "b0": b0.to(_I32),
        "b1": b1.to(_I32),
        "bits": (pair_bits + c1_bits).to(_I32),
    }


def rate_loop_precompute_strict(
    spectrum: torch.Tensor,
    init_gain: torch.Tensor,
    sample_rate: int,
    is_long: torch.Tensor,
    iso: bool,
    count1_coding: bool,
    region_table_select: bool,
    mag_scale: torch.Tensor | None = None,
    part2: torch.Tensor | None = None,
    block: torch.Tensor | None = None,
    iso_short: bool = False,
    linbits: bool = False,
    b0_switch: torch.Tensor | None = None,
) -> dict:
    """The strict-entropy sweep (dsp.py:1604-1736): every one of the 20
    grid gains priced exactly by strict_layout_device (the reference's
    STRICT_ANCHORS are all 20, so its interpolation is the identity), all
    20 in one call of kernels.strict_sweep (K5 on a card; on the CPU its
    plain version, one gain at a time). mag_scale/part2
    (real_scalefactors): the 2^(0.75 sf) amplification and the scalefactor
    bits added to every candidate.
    iso_short: switching granules' magnitudes and signs go to the ISO
    2.4.3.4.8 stream order first (quantization is pointwise), the sign
    riding on the magnitude's sign bit through one gather; START and STOP
    granules keep the natural (long) order. linbits: the grid quantizes up
    to QCAP_LINBITS with the unfloored ISO step and prices the ESC tables;
    the all-zero test at the initial gain keeps the floored table-15 law,
    as the reference's does."""
    absx = torch.clamp(torch.abs(spectrum), min=1e-10)
    mag = torch.pow(absx, 0.75)
    if mag_scale is not None:
        mag = mag * mag_scale
    sign_neg = spectrum < 0
    if iso_short:
        # mag >= 1e-10^0.75 > 0, so the sign round-trips exactly
        layout = torch.where(block > BLOCK_SHORT, BLOCK_LONG, block)
        perm = _rate_table("reorder", sample_rate, spectrum.device)[layout.long()]
        signed = torch.gather(torch.where(sign_neg, -mag, mag), -1, perm)
        mag = torch.abs(signed)
        sign_neg = signed < 0

    g0 = torch.clamp(init_gain, 0, 255)
    q0 = quantize_at_gains(mag, sign_neg, g0[..., None], iso=iso)[..., 0, :]
    allzero0 = _last_nonzero_count(q0) == 0
    gstart = torch.where(allzero0, torch.clamp(g0 - 40, min=0), g0).to(_I32)
    k_budget = torch.where(allzero0, N_GAIN_CANDIDATES - 1, N_GAIN_CANDIDATES).to(_I32)

    k = torch.arange(N_GAIN_CANDIDATES, dtype=_I32, device=spectrum.device)
    bits = kernels.strict_sweep(
        mag.contiguous(), gstart, inv_step_table(iso, spectrum.device, floor=not linbits),
        is_long, b0_switch, part2, sample_rate=sample_rate, count1_coding=count1_coding,
        region_table_select=region_table_select, linbits=linbits,
    )
    return {
        "mag": mag,
        "sign_neg": sign_neg,
        "gstart": gstart,
        "k_budget": k_budget,
        "bits": bits,
        "evaluated": (k == 0) | (gstart[..., None] + 4 * k < 255),
        "iso": iso,
        "strict": (sample_rate, count1_coding, region_table_select),
        "is_long": is_long,
        "linbits": linbits,
        "b0_switch": b0_switch,
    }


def strict_finalize(
    pre: dict, k_sel: torch.Tensor, has_fit: torch.Tensor, q_fixup=None
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Re-quantize at the selected gains and lay them out (dsp.py:1739-1762).
    Returns (gain_reported, quantized, layout). q_fixup: a callable applied
    to the selected quantization before the layout (intensity stereo's
    knife-edge zeroing, ROADMAP Queue 1 item 10). The linbits law (the
    sweep's "linbits") quantizes up to QCAP_LINBITS with the unfloored
    step."""
    sample_rate, count1_coding, region_table_select = pre["strict"]
    linbits = pre.get("linbits", False)
    gains_sel = pre["gstart"] + 4 * k_sel
    q_sel = quantize_at_gains(
        pre["mag"], pre["sign_neg"], gains_sel[..., None], iso=pre["iso"],
        qcap=QCAP_LINBITS if linbits else 15, floor=not linbits,
    )[..., 0, :]
    if q_fixup is not None:
        q_sel = q_fixup(q_sel)
    lay = strict_layout_device(
        q_sel, sample_rate, pre["is_long"], count1_coding, region_table_select,
        linbits=linbits, b0_switch=pre.get("b0_switch"),
    )
    gain_out = torch.where(has_fit, gains_sel, torch.clamp(gains_sel + 4, max=255))
    return gain_out.to(_I32), q_sel, lay


def strict_chunks_device(
    q: torch.Tensor, lay: dict, linbits: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (chunk, nbits) of the strict layout (dsp.py:1765-1879):
    288 pair slots (code, then the signs of nonzero x and y) and 144 count1
    quad slots, [..., 432] each, in write order; nbits 0 outside the coded
    pairs and the count1 range. linbits: each pair takes three slots (code
    | x's ESC bits and sign | y's ESC bits and sign), [..., 864 + 144], so
    that no slot passes 14 bits (the pack kernel takes at most 15)."""
    dev = q.device
    av = torch.clamp(torch.abs(q), max=QCAP_LINBITS if linbits else 15)
    x = av[..., 0::2]
    y = av[..., 1::2]
    sx = (q[..., 0::2] < 0).to(_I32)
    sy = (q[..., 1::2] < 0).to(_I32)
    bv2 = lay["bv"] * 2
    pairpos, region = _pair_regions(lay["b0"], lay["b1"])
    tid_pair = _pair_tids([lay["tid0"], lay["tid1"], lay["tid2"]], region)
    valid = (pairpos < bv2[..., None]) & (tid_pair != 0)
    flat = (tid_pair * 256 + _pair_index(x, y, linbits)).long()
    chunk = constant("pair_code", dev)[flat]
    nbits = constant("pair_len", dev)[flat]
    has_x = (x != 0).to(_I32)
    has_y = (y != 0).to(_I32)
    if linbits:
        lb = linbits_of_tid(tid_pair)
        esc_x = (x >= 15) & (lb > 0)
        esc_y = (y >= 15) & (lb > 0)
        # an escaped coordinate's x - 15 in lb bits, then its sign
        chunk_x = torch.where(esc_x, ((x - 15) << has_x) | (sx * has_x), sx * has_x)
        nbits_x = esc_x.to(_I32) * lb + has_x
        chunk_y = torch.where(esc_y, ((y - 15) << has_y) | (sy * has_y), sy * has_y)
        nbits_y = esc_y.to(_I32) * lb + has_y
        lead = chunk.shape[:-1]
        pair_chunks = torch.where(
            valid[..., None], torch.stack([chunk, chunk_x, chunk_y], dim=-1), 0
        ).reshape(*lead, 864)
        pair_nbits = torch.where(
            valid[..., None], torch.stack([nbits, nbits_x, nbits_y], dim=-1), 0
        ).reshape(*lead, 864)
    else:
        chunk = torch.where(has_x == 1, (chunk << 1) | sx, chunk)
        nbits = nbits + has_x
        chunk = torch.where(has_y == 1, (chunk << 1) | sy, chunk)
        nbits = nbits + has_y
        pair_chunks = torch.where(valid, chunk, 0)
        pair_nbits = torch.where(valid, nbits, 0)

    use2 = (bv2 & 2) == 2
    quads = _count1_quads((av > 0).to(_I32), use2)
    signs = _count1_quads((q < 0).to(_I32), use2)
    patt = quads[..., 0] * 8 + quads[..., 1] * 4 + quads[..., 2] * 2 + quads[..., 3]
    use_b = lay["c1t"][..., None] == 1
    qchunk = torch.where(use_b, 15 - patt, constant("count1a_code", dev)[patt.long()])
    qnbits = torch.where(use_b, 4, constant("count1a_len", dev)[patt.long()])
    for p in range(4):
        has = quads[..., p] == 1
        qchunk = torch.where(has, (qchunk << 1) | signs[..., p], qchunk)
        qnbits = qnbits + quads[..., p]
    qpos = torch.arange(0, 576, 4, dtype=_I32, device=dev)
    start = qpos + torch.where(use2, 2, 0)[..., None]
    vq = (start >= bv2[..., None]) & (start < (bv2 + 4 * lay["n1"])[..., None])
    return (
        torch.cat([pair_chunks, torch.where(vq, qchunk, 0)], dim=-1).to(_I32),
        torch.cat([pair_nbits, torch.where(vq, qnbits, 0)], dim=-1).to(_I32),
    )


# --- Real scalefactors (twin of dsp.py:1882-2042 and 2527-2903) ------------------


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """frexp's exponent, int32 (x = m * 2^e with 0.5 <= m < 1; 0 at 0)."""
    return torch.frexp(x)[1].to(_I32)


def _finish(sf_slots: torch.Tensor, n1_slots: int, n2_slots: int) -> dict:
    """compress/slen/slot_nbits/part2 from slot values (dsp.py:2661-2695):
    group 1 = the first n1_slots slots (slen1), group 2 the next n2_slots."""
    dev = sf_slots.device
    bitlen = constant("sf_bitlen", dev)
    need1 = bitlen[torch.amax(sf_slots[..., :n1_slots], dim=-1).long()]
    need2 = bitlen[torch.amax(sf_slots[..., n1_slots : n1_slots + n2_slots], dim=-1).long()]
    compress = constant("compress_for_need", dev)[(need1 * 5 + need2).long()]
    slen1 = constant("slen1", dev)[compress.long()]
    slen2 = constant("slen2", dev)[compress.long()]
    w = torch.zeros((2, SF_SLOTS), dtype=_I32, device=dev)
    w[0, :n1_slots] = 1
    w[1, n1_slots : n1_slots + n2_slots] = 1
    return {
        "compress": compress,
        "slen1": slen1,
        "slen2": slen2,
        "slot_nbits": slen1[..., None] * w[0] + slen2[..., None] * w[1],
        "part2": (n1_slots * slen1 + n2_slots * slen2).to(_I32),
    }


def _finish_slots_lsf_device(sf_slots: torch.Tensor, ns: tuple) -> dict:
    """The LSF case-0 finisher (dsp.py:2698-2733): 4 slot groups of ns[k]
    slots, slen_k the bit length of the group's maximum, compress =
    ((s1*5 + s2)*4 + s3)*4 + s4, the 9-bit scalefac_compress. The slot caps
    (15, 15, 7, 7 at the group positions) bound the slens at (4, 4, 3, 3),
    so compress < 400 (case 0). slen1/slen2 carry the first two groups'."""
    dev = sf_slots.device
    bitlen = constant("sf_bitlen", dev)
    bounds = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
    slens = [
        bitlen[torch.clamp(torch.amax(sf_slots[..., bounds[k] : bounds[k + 1]], dim=-1), max=15).long()]
        for k in range(4)
    ]
    group = torch.zeros((4, SF_SLOTS), dtype=_I32, device=dev)
    for k in range(4):
        group[k, bounds[k] : bounds[k + 1]] = 1
    slot_nbits = sum(slens[k][..., None] * group[k] for k in range(4))
    return {
        "compress": ((slens[0] * 5 + slens[1]) * 4 + slens[2]) * 4 + slens[3],
        "slen1": slens[0],
        "slen2": slens[1],
        "slot_nbits": slot_nbits,
        "part2": sum(int(ns[k]) * slens[k] for k in range(4)).to(_I32),
    }


def _mag_scale(sf_slots: torch.Tensor, slot_map: torch.Tensor) -> torch.Tensor:
    """Per-coefficient 2^(0.75 sf) from slot values [..., 36] through a
    [576] coefficient -> slot map (SF_SLOTS = no scalefactor, 1.0)."""
    mult = constant("sf_mult34", sf_slots.device)[sf_slots.long()]
    ext = torch.cat([mult, torch.ones_like(mult[..., :1])], dim=-1)
    return ext[..., slot_map]


def _pad_slots(sf: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(sf, (0, SF_SLOTS - sf.shape[-1]))


def _long_finish(sf: torch.Tensor, sample_rate: int) -> dict:
    """The long layout from its 21 band scalefactors (dsp.py:1951-1997 and
    2857-2882): sf, the bands in slots 0-20 of sf_slots, slot_nbits,
    compress, slen1, slen2, part2 and mag_scale."""
    sf_slots = _pad_slots(sf)
    slot_map = _rate_table("slot_maps", sample_rate, sf.device)[0]
    return {
        "sf": sf,
        "sf_slots": sf_slots,
        **_finish(sf_slots, 11, 10),
        "mag_scale": _mag_scale(sf_slots, slot_map),
    }


def strict_scalefactors_device(
    spectrum: torch.Tensor, sample_rate: int, is_long: torch.Tensor
) -> dict:
    """Long-block scalefactors by the exponent-difference law (dsp.py:
    1918-1948): sf_b = clip((e(global peak) - e(band peak)) // 3, 0, cap),
    cap 15 for bands 0-10 and 7 above, zero where not long. Returns the
    long layout of _long_finish (sf [..., 21], mag_scale [..., 576], ...)."""
    lb = _long_bounds(sample_rate)
    absx = torch.abs(spectrum)
    gp = torch.amax(absx, dim=-1)
    ge = _exponent(gp)
    pb = torch.stack(
        [torch.amax(absx[..., int(lb[b]) : int(lb[b + 1])], dim=-1) for b in range(21)], dim=-1
    )
    caps = torch.tensor([15] * 11 + [7] * 10, dtype=_I32, device=spectrum.device)
    sf = torch.minimum(torch.clamp((ge[..., None] - _exponent(pb)) // 3, min=0), caps)
    keep = (pb > 0) & ((gp > 0) & is_long)[..., None]
    return _long_finish(torch.where(keep, sf, 0).to(_I32), sample_rate)


def psy_scalefactors_device(
    spectrum: torch.Tensor, sample_rate: int, is_long: torch.Tensor
) -> dict:
    """Masking-driven scalefactors (options.psy_scalefactors, dsp.py:
    2007-2042): band peak exponents spread by max-plus scans PSY_SLOPE per
    band, half the gap to the loudest mask turned into amplification. All
    integer arithmetic on frexp exponents."""
    lb = _long_bounds(sample_rate)
    absx = torch.abs(spectrum)
    gp = torch.amax(absx, dim=-1)
    ge = _exponent(gp)
    EMPTY = -(1 << 14)
    pes = []
    for b in range(21):
        pb = torch.amax(absx[..., int(lb[b]) : int(lb[b + 1])], dim=-1)
        pes.append(torch.where(pb > 0, _exponent(pb), EMPTY))
    Ms = list(pes)
    for b in range(1, 21):
        Ms[b] = torch.maximum(Ms[b], Ms[b - 1] - PSY_SLOPE)
    for b in range(19, -1, -1):
        Ms[b] = torch.maximum(Ms[b], Ms[b + 1] - PSY_SLOPE)
    M = torch.stack(Ms, dim=-1)
    pe = torch.stack(pes, dim=-1)
    gap = torch.amax(M, dim=-1, keepdim=True) - M
    v = (PSY_ALPHA_NUM * gap) // PSY_ALPHA_DEN
    v = torch.minimum(v, torch.clamp(ge[..., None] - pe, min=0))
    caps = torch.tensor([15] * 11 + [7] * 10, dtype=_I32, device=spectrum.device)
    sf = torch.minimum(torch.clamp(v, min=0), caps)
    sf = torch.where(pe == EMPTY, 0, sf)
    sf = torch.where(((gp > 0) & is_long)[..., None], sf, 0).to(_I32)
    return _long_finish(sf, sample_rate)


def masking_thresholds(spectrum: torch.Tensor, sample_rate: int, quality: int) -> torch.Tensor:
    """Per-band mean energy x the quality scale, floor 1e-4, spread back to
    the band's coefficients; 1e-4 past the last band (dsp.py:1155-1182).
    The reference computes it and never reads it; no chunk program calls it."""
    lb = _long_bounds(sample_rate)
    scale = float(np.float32(max(0.1, (10 - quality) / 10.0)))
    e = spectrum * spectrum
    parts = []
    for b in range(21):
        lo, hi = int(lb[b]), int(lb[b + 1])
        avg = torch.sum(e[..., lo:hi], dim=-1, keepdim=True) / float(hi - lo)
        parts.append(torch.clamp(avg * scale, min=1e-4).expand(*e.shape[:-1], hi - lo))
    tail = (*e.shape[:-1], 576 - int(lb[21]))
    parts.append(torch.full(tail, 1e-4, dtype=e.dtype, device=e.device))
    return torch.cat(parts, dim=-1)


def _switching_sfd_device(
    spectrum: torch.Tensor, sample_rate: int, mixed: bool, lsf: bool = False
) -> dict:
    """Short or mixed scalefactors for every granule (dsp.py:2736-2830): per
    (short band, window) slot sf = clip((ge - pe) // 3, 0, cap), cap 15 for
    short bands 0-5 and 7 above; mixed granules carry the long head's band
    scalefactors (cap 15) in the first slots and short bands 3-11 after
    them. The head is 8 bands at MPEG-1 and, with the case-0 finisher, the
    ISO 13818-3 6-band head at LSF rates (lsf)."""
    sb = [int(v) for v in short_band_bounds(sample_rate)]
    lead = spectrum.shape[:-1]
    absx = torch.abs(spectrum)
    gp = torch.amax(absx, dim=-1)
    ge = _exponent(gp)
    live = gp > 0
    X3 = absx.reshape(*lead, 192, 3)
    parts = []
    n_head = 6 if lsf else 8
    if mixed:
        lb = _long_bounds(sample_rate)
        pb = torch.stack(
            [torch.amax(absx[..., int(lb[b]) : int(lb[b + 1])], dim=-1) for b in range(n_head)],
            dim=-1,
        )
        sf = torch.clamp((ge[..., None] - _exponent(pb)) // 3, 0, 15)
        parts.append(torch.where((pb > 0) & live[..., None], sf, 0))
    for s in range(3 if mixed else 0, 12):
        pb = torch.amax(X3[..., sb[s] : sb[s + 1], :], dim=-2)  # [..., 3] by window
        sf = torch.clamp((ge[..., None] - _exponent(pb)) // 3, 0, 15 if s < 6 else 7)
        parts.append(torch.where((pb > 0) & live[..., None], sf, 0))
    sf_slots = _pad_slots(torch.cat(parts, dim=-1).to(_I32))
    if lsf:
        fin = _finish_slots_lsf_device(sf_slots, LSF_NSF_MIXED if mixed else LSF_NSF_SHORT)
    else:
        fin = _finish(sf_slots, 17 if mixed else 18, 18)
    maps = _rate_table("slot_maps_lsf" if lsf else "slot_maps", sample_rate, spectrum.device)
    slot_map = maps[1 if mixed else 2]
    return {"sf_slots": sf_slots, "mag_scale": _mag_scale(sf_slots, slot_map), **fin}


def granule_scalefactors_device(
    spectrum: torch.Tensor,
    sample_rate: int,
    block: torch.Tensor,
    psy: bool = False,
    iso_short: bool = False,
    lsf: bool = False,
) -> dict:
    """Per-granule scalefactors by block type (dsp.py:2833-2903). spectrum
    [..., 576] natural order; block [...] int32. Returns sf [..., 21] (long
    bands; zeros for switching granules, the scfsi input), sf_slots and
    slot_nbits [..., 36], compress/slen1/slen2/part2 [...] and mag_scale
    [..., 576]. Without iso_short, switching granules carry no scalefactors.
    lsf: the 9-bit case-0 finisher in place of the MPEG-1 4-bit one (the
    scalefactor laws are unchanged: the LSF group caps are the MPEG-1 band
    caps at every slot)."""
    is_long = block == BLOCK_LONG
    law = psy_scalefactors_device if psy else strict_scalefactors_device
    out = law(spectrum, sample_rate, is_long)
    if lsf:
        out.update(_finish_slots_lsf_device(out["sf_slots"], LSF_NSF_LONG))
    if not iso_short:
        return out
    ssfd = _switching_sfd_device(spectrum, sample_rate, mixed=False, lsf=lsf)
    msfd = _switching_sfd_device(spectrum, sample_rate, mixed=True, lsf=lsf)
    is_mixed = block == BLOCK_MIXED
    for name in ("sf_slots", "slot_nbits", "compress", "slen1", "slen2", "part2", "mag_scale"):
        extra = ssfd[name].dim() - is_long.dim()
        il = is_long.reshape(is_long.shape + (1,) * extra)
        im = is_mixed.reshape(is_mixed.shape + (1,) * extra)
        out[name] = torch.where(il, out[name], torch.where(im, msfd[name], ssfd[name]))
    return out


def initial_gain_scaled(
    spectrum: torch.Tensor, mag_scale: torch.Tensor, target: float = 15.0
) -> torch.Tensor:
    """ISO-law initial gain from scalefactor-amplified magnitudes
    (dsp.py:2527-2541)."""
    mag = torch.pow(torch.clamp(torch.abs(spectrum), min=1e-10), 0.75) * mag_scale
    ratio = torch.amax(mag, dim=-1) / float(np.float32(target))
    safe_ratio = torch.clamp(ratio, min=1e-30)
    mult = float(np.float32(16.0 / 3.0))
    gain = torch.clamp(210 + torch.trunc(mult * torch.log2(safe_ratio)).to(_I32), 0, 255)
    raw_peak = torch.amax(torch.abs(spectrum), dim=-1)
    return torch.where(raw_peak > 0, gain, 210).to(_I32)


def _write_slots_device(write: torch.Tensor) -> torch.Tensor:
    """A [..., 21] long-band write mask extended to the 36 slots (dsp.py:
    2547-2552); switching granules never share."""
    return torch.nn.functional.pad(write, (0, SF_SLOTS - write.shape[-1]), value=True)


def scalefactor_chunks_device(
    sfd: dict, write: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(chunks, nbits) of the 36 scalefactor slots a granule, ISO 2.4.2.7
    transmission order (dsp.py:2555-2564); `write` [..., 21] masks the
    scfsi-shared long bands to zero width."""
    nbits = sfd["slot_nbits"]
    if write is not None:
        nbits = torch.where(_write_slots_device(write), nbits, 0)
    return sfd["sf_slots"], nbits.to(_I32)


def scfsi_device(sf: torch.Tensor, is_long: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """scfsi over a frame's granule pair (dsp.py:2571-2588). sf [..., 2, 21]
    (granule axis second to last), is_long [..., 2]. Returns (the four
    side-info bits packed MSB first [...] int32, write [..., 2, 21]: granule
    1's shared bands False)."""
    sf0, sf1 = sf[..., 0, :], sf[..., 1, :]
    both_long = is_long[..., 0] & is_long[..., 1]
    write1 = torch.ones(sf1.shape, dtype=torch.bool, device=sf.device)
    nibble = torch.zeros(both_long.shape, dtype=_I32, device=sf.device)
    for g, (lo, hi) in enumerate(SCFSI_GROUPS):
        shared = torch.all(sf0[..., lo:hi] == sf1[..., lo:hi], dim=-1) & both_long
        nibble = nibble + (shared.to(_I32) << (3 - g))
        write1[..., lo:hi] &= ~shared[..., None]
    return nibble, torch.stack([torch.ones_like(write1), write1], dim=-2)


def scfsi_part2_device(sfd: dict, write: torch.Tensor) -> torch.Tensor:
    """part2 bits a granule when only the `write` bands are emitted
    (dsp.py:2591-2595)."""
    nbits = torch.where(_write_slots_device(write), sfd["slot_nbits"], 0)
    return torch.sum(nbits, dim=-1, dtype=_I32)


# --- Distortion control (twin of dsp.py:2045-2189) ------------------------------

# Copies of swiftmp3_tpu/ops/dsp.py _DC_RATIO, _DC_BUMP, _DC_MASK_OFFSET,
# _DC_CAPS and _QUARTER_POS, and of swiftmp3_tpu/ops/reference.py DC_BUMP_MAX
# (tests hold them equal): bump bands whose error energy passes DC_RATIO x the
# spread-mask target by DC_BUMP scalefactor steps (proportional law: by
# ceil(log4(noise / mask)), 1..DC_BUMP_MAX), the mask DC_MASK_OFFSET binary
# exponents under the spread band peak; the slen1/slen2 field caps.
DC_RATIO = 2.0
DC_BUMP = 3
DC_MASK_OFFSET = 6
DC_CAPS = np.asarray([15] * 11 + [7] * 10, dtype=np.int32)
DC_BUMP_MAX = 6
QUARTER_POS = (2.0 ** (np.arange(4) / 4.0)).astype(np.float32)  # 2^(r/4)


def build_dc_steps() -> np.ndarray:
    """[256] float32 2^((g - 210)/4) by gain: 2^(r/4) as float32 scaled by
    the exact power of two 2^((g - 210) >> 2) (the correctly rounded step
    dsp.py:2069-2076 reconstructs with ldexp)."""
    e = np.arange(256) - 210
    return np.ldexp(QUARTER_POS[e & 3], e >> 2).astype(np.float32)


def _band_members(sample_rate: int) -> np.ndarray:
    """[21, 576] float32 long band membership (twin of dsp._band_members)."""
    bounds = _long_bounds(sample_rate)
    coef = np.arange(576)
    return np.stack(
        [(coef >= bounds[b]) & (coef < bounds[b + 1]) for b in range(21)]
    ).astype(np.float32)


def _pow2_exact(e: torch.Tensor) -> torch.Tensor:
    """float64 2^e for int e, built from its exponent bits (exact; e clamped
    to the normal range, far past where a float32 product underflows)."""
    e = torch.clamp(e.to(torch.int64), -1022, 1023)
    return ((e + 1023) << 52).view(torch.float64)


def _ldexp_exact(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """float32 x * 2^e, correctly rounded (through float64, where the product
    is exact), as numpy's ldexp."""
    return (x.to(torch.float64) * _pow2_exact(e)).to(_F32)


def _spread_max(pe: torch.Tensor, slope: int) -> torch.Tensor:
    """The two max-plus scans of the masking spread (dsp.py:2097-2101) over
    the last axis: forward M[b] = max(pe[b], M[b-1] - slope), then backward
    M[b] = max(M[b], M[b+1] - slope), as two running maxima (integers,
    exact)."""
    ramp = slope * torch.arange(pe.shape[-1], dtype=pe.dtype, device=pe.device)
    fwd = torch.cummax(pe + ramp, dim=-1).values - ramp
    back = torch.flip(torch.cummax(torch.flip(fwd - ramp, [-1]), dim=-1).values, [-1])
    return back + ramp


def distortion_bumps_device(
    spectrum: torch.Tensor,
    q: torch.Tensor,
    gain: torch.Tensor,
    sf: torch.Tensor,
    sample_rate: int,
    proportional: bool = False,
) -> torch.Tensor:
    """Per-band bumps [..., 21] int32 (dsp.py:2057-2125): the probe
    quantization q [..., 576] at `gain` [...] reconstructed by the ISO decode
    law at scalefac_scale 1 (sign |q|^(4/3) 2^((gain-210)/4) 2^(-sf_b)), each
    band's error energy against the spread-mask target n_lines 2^(2 thr_exp);
    violating bands bump by DC_BUMP, or under the proportional law by 1 plus
    the number of k in 1..DC_BUMP_MAX-1 with e2 > thr2n 4^k (no log2). The
    band energies are float sums (a matmul with the band membership), so a
    band on the threshold may decide otherwise than XLA's sum order."""
    dev = spectrum.device
    step = _dc_table("steps", sample_rate, dev)[torch.clamp(gain, 0, 255).long()]
    mag = torch.pow(torch.abs(q).to(_F32), float(np.float32(4.0 / 3.0))) * step[..., None]
    xr = torch.where(q < 0, -mag, mag)
    # 2^(-sf_b) on each band's lines, 1.0 past the last band
    pow2 = torch.nn.functional.pad(_dc_table("neg_pow2", sample_rate, dev)[sf.long()], (0, 16), value=1.0)
    scale = pow2[..., _rate_table("slot_maps", sample_rate, dev)[0]]
    err = xr * scale - spectrum
    e2 = torch.matmul(err * err, _dc_table("members_t", sample_rate, dev))  # [..., 21]

    EMPTY = -(1 << 14)
    lb = _long_bounds(sample_rate)
    absx = torch.abs(spectrum)
    pb = torch.stack(
        [torch.amax(absx[..., int(lb[b]) : int(lb[b + 1])], dim=-1) for b in range(21)], dim=-1
    )
    pe = torch.where(pb > 0, _exponent(pb), EMPTY)
    thr_exp = _spread_max(pe, PSY_SLOPE) - DC_MASK_OFFSET
    thr2n = _ldexp_exact(_dc_table("n_lines", sample_rate, dev), 2 * thr_exp)
    violated = e2 > DC_RATIO * thr2n
    if not proportional:
        return torch.where(violated, DC_BUMP, 0).to(_I32)
    steps = torch.ones(e2.shape, dtype=_I32, device=dev)
    for k in range(1, DC_BUMP_MAX):
        steps = steps + (e2 > _ldexp_exact(thr2n, torch.full_like(thr_exp, 2 * k))).to(_I32)
    return torch.where(violated, steps, 0).to(_I32)


def _rebuild_long_sfd_device(
    sfd: dict, sf2: torch.Tensor, engaged: torch.Tensor, sample_rate: int
) -> dict:
    """The long layout rebuilt from a replacement sf [..., 21] on `engaged`
    granules [...]; every other granule keeps the original fields exactly
    (dsp.py:2140-2178, shared by distortion control and intensity stereo)."""
    new = _long_finish(sf2, sample_rate)
    out = {}
    for name, v in new.items():
        e = engaged.reshape(engaged.shape + (1,) * (v.dim() - engaged.dim()))
        out[name] = torch.where(e, v, sfd[name])
    return out


def distortion_sfd_device(
    sfd: dict, bumps: torch.Tensor, engaged: torch.Tensor, sample_rate: int
) -> dict:
    """The scalefactor dict after the bumps (dsp.py:2127-2137): engaged
    granules (all-LONG frames) take sf + bumps within the slen caps and the
    rebuilt long layout; the others keep every field."""
    caps = _dc_table("caps", sample_rate, sfd["sf"].device)
    sf2 = torch.where(engaged[..., None], torch.minimum(sfd["sf"] + bumps, caps), sfd["sf"])
    return _rebuild_long_sfd_device(sfd, sf2.to(_I32), engaged, sample_rate)


# --- Intensity stereo (twin of dsp.py:2181-2526; MPEG-1 only) ---------------------

# Copies of swiftmp3_tpu/ops/reference.py IS_MIN_SFB, IS_CORR, IS_NEG, IS_SFM
# and IS_MIN_SFB_SHORT (tests hold them equal): a band is coded as intensity
# when it is effectively panned (the quieter channel under IS_NEG of the
# louder) or correlated (>= IS_CORR), in a contiguous region from the top no
# lower than band IS_MIN_SFB (short: IS_MIN_SFB_SHORT), unless the would-be
# carrier is noise-flat (spectral flatness above IS_SFM).
IS_MIN_SFB = 8
IS_CORR = 0.5
IS_NEG = 0.02
IS_SFM = 0.15
IS_MIN_SFB_SHORT = 4
_IS_RATES = (44100, 48000, 32000)  # intensity encoding is MPEG-1 only


def _is_members_ext(sample_rate: int) -> np.ndarray:
    """[21, 576] float32 band membership with band 20 extended to line 576
    (the sfb21 tail rides band 20's position; dsp.py:2210-2221)."""
    bounds = _long_bounds(sample_rate)
    coef = np.arange(576)
    return np.stack(
        [(coef >= bounds[b]) & (coef < (bounds[b + 1] if b < 20 else 576)) for b in range(21)]
    ).astype(np.float32)


def _sb_bounds_for(sample_rate: int) -> np.ndarray:
    """The short bands' 13 per-window line bounds (dsp.py:2368-2371)."""
    return np.asarray(short_band_bounds(sample_rate)[:13], dtype=np.int32)


def _is_members_short(sample_rate: int) -> np.ndarray:
    """[36, 576] float32 per-(band, window) membership of the NATURAL layout,
    row 3 s + w, band 11 folding the per-window tail to line 192
    (dsp.py:2351-2365)."""
    bounds = short_band_bounds(sample_rate)
    line = np.arange(576) // 3
    w_of = np.arange(576) % 3
    rows = []
    for s in range(12):
        hi = int(bounds[s + 1]) if s < 11 else 192
        for w in range(3):
            rows.append((line >= int(bounds[s])) & (line < hi) & (w_of == w))
    return np.stack(rows).astype(np.float32)


def _is_bounds(sample_rate: int) -> np.ndarray:
    """dsp._IS_BOUNDS[sample_rate]: [0] + the long band ends, 22 entries."""
    return _long_bounds(sample_rate).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _dc_table(name: str, sample_rate: int, device: torch.device) -> torch.Tensor:
    """The constants of distortion control and intensity stereo on a device:
    the band membership matrices transposed for band sums by matmul, each
    coefficient's band (long, extended to 576) and (band, window) slot
    (short), the steps and the small tables."""
    if name == "steps":
        arr = build_dc_steps()
    elif name == "neg_pow2":
        arr = (2.0 ** -np.arange(16)).astype(np.float32)
    elif name == "caps":
        arr = DC_CAPS
    elif name == "n_lines":
        arr = np.diff(_long_bounds(sample_rate)).astype(np.float32)
    elif name == "members_t":
        arr = np.ascontiguousarray(_band_members(sample_rate).T)
    elif name == "is_members_t":
        arr = np.ascontiguousarray(_is_members_ext(sample_rate).T)
    elif name == "is_short_members_t":
        arr = np.ascontiguousarray(_is_members_short(sample_rate).T)
    elif name == "is_band_of":  # long band of each coefficient, band 20 to 576
        arr = np.argmax(_is_members_ext(sample_rate), axis=0).astype(np.int64)
    else:  # "is_slot_of": the (band, window) slot 3 s + w of each coefficient
        arr = np.argmax(_is_members_short(sample_rate), axis=0).astype(np.int64)
    return torch.from_numpy(arr).to(device)


def _carrier_noise_flat_device(c: torch.Tensor) -> torch.Tensor:
    """Spectral flatness of the would-be carrier c [..., W] over its live
    (nonzero) lines above IS_SFM, or no live line (dsp.py:2191-2207; the
    adaptive lowpass zero-fills the tail). Returns bool [...]."""
    hb2 = c * c
    live = hb2 > 0
    n_live = torch.sum(live, dim=-1)
    denom = torch.clamp(n_live, min=1).to(_F32)
    m = torch.sum(hb2, dim=-1) / denom
    logs = torch.where(live, torch.log(torch.where(live, hb2, 1.0)), 0.0)
    g = torch.exp(torch.sum(logs, dim=-1) / denom)
    return (n_live == 0) | (g / (m + 1e-20) > float(np.float32(IS_SFM)))


def _is_laws(el, er, num, min_band: int, band_axis: int):
    """The per-band laws shared by the long and short analyses: positions,
    and the bands that qualify (panned or correlated, at or above
    min_band) in a contiguous region from the top along band_axis."""
    pos = torch.clamp(
        torch.round(torch.atan2(torch.sqrt(el), torch.sqrt(er)) * float(np.float32(12.0 / np.pi))),
        0,
        6,
    ).to(_I32)
    panned = torch.minimum(el, er) <= float(np.float32(IS_NEG)) * torch.maximum(el, er)
    # NaN where a band energy is zero, which `panned` covers (NaN >= x is False)
    corr = num / torch.sqrt(el * er)
    n_bands = el.shape[band_axis]
    band = torch.arange(n_bands, device=el.device).reshape((n_bands,) + (1,) * (-1 - band_axis))
    ok = (panned | (corr >= IS_CORR)) & (band >= min_band)
    # band b is in the region iff every band from b to the top qualifies
    region = torch.flip(torch.cumprod(torch.flip(ok.to(_I32), [band_axis]), band_axis), [band_axis])
    return pos, region.bool()


def intensity_analyze_device(
    spec_l: torch.Tensor, spec_r: torch.Tensor, sample_rate: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-granule intensity analysis of long-layout spectrum pairs [..., 576]
    (dsp.py:2232-2279). Returns (pos [..., 21] int32 pan positions, region
    [..., 21] bool, has_region [...] bool, line_mask [..., 576] float32 1.0
    on region lines). The band energies and correlations are sums (a matmul
    with the band membership), so a band on a threshold may decide otherwise
    than XLA's sum order."""
    dev = spec_l.device
    M = _dc_table("is_members_t", sample_rate, dev)
    el = torch.matmul(spec_l * spec_l, M)
    er = torch.matmul(spec_r * spec_r, M)
    num = torch.matmul(spec_l * spec_r, M)
    pos, region = _is_laws(el, er, num, IS_MIN_SFB, -1)
    er_region = torch.sum(torch.where(region, er, 0.0), dim=-1)
    er_total = torch.sum(er, dim=-1)
    cut0 = int(_is_bounds(sample_rate)[IS_MIN_SFB])
    noise_flat = _carrier_noise_flat_device(spec_l[..., cut0:] + spec_r[..., cut0:])
    has_region = (
        region[..., 20]
        & (er_region > float(np.float32(IS_NEG)) * (er_total + 1e-30))
        & ~noise_flat
    )
    line_mask = region[..., _dc_table("is_band_of", sample_rate, dev)].to(_F32)
    return pos, region, has_region, line_mask


def intensity_q_fixup(q: torch.Tensor, engaged: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """The knife-edge zeroing on the selected quantization (dsp.py:2282-2297):
    an engaged granule whose quantized extent ends inside band 20 cannot
    carry both band 20's scalefactor and the tail's position in slot 20, so
    its band-20 remainder is zeroed. Runs before the entropy layout."""
    bounds = _is_bounds(sample_rate)
    z = _last_nonzero_count(q)
    knife = engaged & (z > int(bounds[20])) & (z <= int(bounds[21]))
    tail = torch.arange(576, device=q.device) >= int(bounds[20])
    return torch.where(knife[..., None] & tail, 0, q)


def intensity_sfd_device(
    sfd: dict,
    quantized: torch.Tensor,
    pos: torch.Tensor,
    summed: torch.Tensor,
    engaged: torch.Tensor,
    sample_rate: int,
) -> dict:
    """The post-walk position slots of engaged long-layout granules (the
    right channel of emitted frames; dsp.py:2300-2330): every band from the
    one holding the final quantized extent up takes its position if summed,
    else the illegal marker 7; the long layout is rebuilt. `quantized`
    carries intensity_q_fixup."""
    bounds = torch.from_numpy(_is_bounds(sample_rate)[:21]).to(quantized.device)
    z = _last_nonzero_count(quantized)
    b_start = torch.sum(bounds < z[..., None], dim=-1)  # searchsorted, left
    write = torch.arange(21, device=quantized.device) >= b_start[..., None]
    sf2 = torch.where(write & engaged[..., None], torch.where(summed, pos, 7), sfd["sf"])
    return _rebuild_long_sfd_device(sfd, sf2.to(_I32), engaged, sample_rate)


def intensity_padded_part2_device(sfd: dict) -> torch.Tensor:
    """Priced part2 bits with every long slot at least 7 (dsp.py:2333-2342):
    the post-walk overwrite may grow any slot to the marker, and the emitted
    bits must never pass the priced ones."""
    return _finish(_pad_slots(torch.clamp(sfd["sf"], min=7)), 11, 10)["part2"]


def intensity_analyze_short_device(
    spec_l: torch.Tensor, spec_r: torch.Tensor, sample_rate: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(band, window) intensity analysis of NATURAL-layout pure-short
    spectrum pairs [..., 576] (dsp.py:2378-2440). Returns (pos [..., 12, 3]
    int32, region [..., 12, 3] bool, has_region [..., 3] bool per window,
    line_mask [..., 576] float32, per-window has_region folded in)."""
    dev = spec_l.device
    lead = spec_l.shape[:-1]
    M = _dc_table("is_short_members_t", sample_rate, dev)
    el = torch.matmul(spec_l * spec_l, M).reshape(*lead, 12, 3)
    er = torch.matmul(spec_r * spec_r, M).reshape(*lead, 12, 3)
    num = torch.matmul(spec_l * spec_r, M).reshape(*lead, 12, 3)
    pos, region = _is_laws(el, er, num, IS_MIN_SFB_SHORT, -2)
    er_region = torch.sum(torch.where(region, er, 0.0), dim=-2)  # [..., 3]
    er_total = torch.sum(er, dim=-2)
    # flatness per window: a granule-level one would be blind on transients
    cut0 = int(_sb_bounds_for(sample_rate)[IS_MIN_SFB_SHORT])
    c3 = (spec_l + spec_r)[..., 3 * cut0 :].reshape(*lead, 192 - cut0, 3)
    noise_flat = _carrier_noise_flat_device(c3.transpose(-1, -2))
    has_region = (
        region[..., 11, :]
        & (er_region > float(np.float32(IS_NEG)) * (er_total + 1e-30))
        & ~noise_flat
    )
    live = (region & has_region[..., None, :]).reshape(*lead, 36)
    line_mask = live[..., _dc_table("is_slot_of", sample_rate, dev)].to(_F32)
    return pos, region, has_region, line_mask


def _window_extents(q: torch.Tensor) -> torch.Tensor:
    """Per-window line extents [..., 3] of a NATURAL short quantization."""
    return _last_nonzero_count(q.reshape(*q.shape[:-1], 192, 3).transpose(-1, -2))


def intensity_q_fixup_short(q: torch.Tensor, engaged: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """The per-window knife-edge zeroing of engaged pure-short granules
    (dsp.py:2443-2465): a window whose extent ends inside band 11 or its
    tail gets band 11 on zeroed. NATURAL layout."""
    sbb11 = int(_sb_bounds_for(sample_rate)[11])
    knife = engaged[..., None] & (_window_extents(q) > sbb11)  # [..., 3]
    line = torch.arange(192, device=q.device)[:, None] >= sbb11
    zero = (knife[..., None, :] & line).reshape(*q.shape[:-1], 576)
    return torch.where(zero, 0, q)


def intensity_sfd_short_device(
    sfd: dict,
    quantized: torch.Tensor,
    pos: torch.Tensor,
    summed: torch.Tensor,
    engaged: torch.Tensor,
    sample_rate: int,
) -> dict:
    """The per-window post-walk position slots of engaged pure-short granules
    (dsp.py:2468-2516): in each window every band from the one holding the
    window's final extent up takes its position if summed, else 7; the
    short grouping (18, 18) is rebuilt. `quantized` is NATURAL and carries
    intensity_q_fixup_short. Other granules keep every field."""
    dev = quantized.device
    lead = quantized.shape[:-1]
    sbb = torch.from_numpy(_sb_bounds_for(sample_rate)[:12]).to(dev)
    b_start = torch.sum(sbb[:, None] < _window_extents(quantized)[..., None, :], dim=-2)  # [..., 3]
    write = torch.arange(12, device=dev)[:, None] >= b_start[..., None, :]
    old = sfd["sf_slots"][..., :36].reshape(*lead, 12, 3)
    slots = torch.where(write & engaged[..., None, None], torch.where(summed, pos, 7), old)
    sf_slots = _pad_slots(slots.reshape(*lead, 36).to(_I32))
    new = {"sf_slots": sf_slots, **_finish(sf_slots, 18, 18)}
    out = dict(sfd)
    for name, v in new.items():
        e = engaged.reshape(engaged.shape + (1,) * (v.dim() - engaged.dim()))
        out[name] = torch.where(e, v, sfd[name])
    return out


def intensity_padded_part2_short_device(sfd: dict) -> torch.Tensor:
    """Priced part2 with every short (band, window) slot at least 7
    (dsp.py:2519-2524)."""
    return _finish(torch.clamp(sfd["sf_slots"][..., :36], min=7), 18, 18)["part2"]

"""Inputs shared by the port's tests and `chip_smoke.py` (numpy only, made
from seeds; `strict_pack_input` and `AssemblerRender` run the port,
imported inside them).

Besides the kernel inputs, this module holds numpy-only copies of the
reference tests' signal makers and option rows, so that code which must not
import the JAX package (`chip_smoke.py`, `tools/torch_profile_step.py`)
builds the same inputs: `make_signal` and the 8 compat and 4 strict rows of
`tests/fixture_lib.py`, `corpus_stereo` (`tests/test_ulp_telemetry.py`), and
the bench audio of the main path. `tests/test_torch_fixtures.py` holds each
copy equal to its original. Option keyword arguments name the channel mode
as a string, so each package's `MP3EncoderOptions(**kw)` builds from the
same row.
"""

from __future__ import annotations

import os

import numpy as np

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TORCH_FIXTURE_DIR = os.path.join(FIXTURE_DIR, "torch")

# The main path's configuration and step shape (chip_smoke.py phase 4):
# default options, 128 kbps CBR stereo 44.1 kHz, 256 streams x 128 frames.
MAIN_OPTIONS = dict(mode="stereo", bitrate_kbps=128, sample_rate=44100)
B_MAIN, T_MAIN = 256, 128
# The strict main path: MP3EncoderOptions.spec_strict(**STRICT_OPTIONS), the
# configuration tests/test_ulp_telemetry.py pins for the preset.
STRICT_OPTIONS = dict(mode="joint_stereo", bitrate_kbps=128, sample_rate=44100)
# The hq paths: MP3EncoderOptions.hq(**HQ_OPTIONS[preset]), joint stereo (the
# configuration tests/test_ulp_telemetry.py pins for the preset) and stereo
# (bench.py's hq cell), both 128 kbps at 44.1 kHz.
HQ_OPTIONS = {
    "hq_joint": dict(mode="joint_stereo", bitrate_kbps=128, sample_rate=44100),
    "hq_stereo": dict(mode="stereo", bitrate_kbps=128, sample_rate=44100),
}


def sweep_input(n: int = 37, seed: int = 7):
    """The tests/test_pallas.py rate-sweep input: granule levels over 5.5
    decades, one silent granule. Returns (mag [n, 576] f32, gstart [n] i32)."""
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((n, 576)) * 10 ** rng.uniform(-5, 0.5, (n, 1))).astype(
        np.float32
    )
    spec[3] = 0.0
    mag = (np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32)
    return mag, rng.integers(0, 256, n).astype(np.int32)


def pack_input(F: int, P: int, cap: int, seed: int = 7, overflow: bool = False):
    """The tests/test_pallas.py pack input: (chunks, nbits) [F, P] int32 with
    every frame under the cap, or (overflow=True) every frame past it."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(5 if overflow else 0, 16, size=(F, P)).astype(np.int32)
    scale = (cap * 8 - 64) / max(nb.sum(axis=1).max(), 1)
    if scale < 1 and not overflow:
        nb = np.where(rng.random((F, P)) < scale, nb, 0)
    ch = (rng.integers(0, 1 << 15, size=(F, P)) & ((1 << nb) - 1)).astype(np.int32)
    return ch, nb


# K4's configurations: compat CBR, energy VBR (with CRC), spec_strict, hq
# joint stereo (linbits and demand_budget), reservoir depth 3, demand VBR,
# an LSF and a free-format preset ((preset factory, keyword arguments))
SCAN_OPTIONS = {
    "compat": (None, dict(mode="stereo", bitrate_kbps=128, sample_rate=44100)),
    "energy_vbr": (None, dict(mode="joint_stereo", bitrate_kbps=128, sample_rate=44100,
                              vbr=True, quality=3, crc_protected=True)),
    "strict": ("spec_strict", dict(mode="joint_stereo", bitrate_kbps=128, sample_rate=44100)),
    "hq_joint": ("hq", dict(mode="joint_stereo", bitrate_kbps=128, sample_rate=44100)),
    "depth3": ("hq", dict(mode="mono", bitrate_kbps=96, sample_rate=44100, reservoir_depth=3)),
    "demand_vbr": ("hq", dict(mode="mono", bitrate_kbps=128, sample_rate=44100, vbr=True,
                              vbr_demand=True, quality=5)),
    "lsf_strict": ("spec_strict", dict(mode="joint_stereo", bitrate_kbps=64, sample_rate=22050)),
    "free_format": ("spec_strict", dict(mode="mono", bitrate_kbps=150, sample_rate=44100,
                                        free_format=True, linbits_tables=True)),
}


def scan_options(preset: str):
    """The port's MP3EncoderOptions of SCAN_OPTIONS[preset]."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions

    factory, kwargs = SCAN_OPTIONS[preset]
    return (getattr(MP3EncoderOptions, factory) if factory else MP3EncoderOptions)(**kwargs)


def scan_input(options, B: int, T: int, seed: int = 0, device="cpu"):
    """K4's inputs for B streams of T frames under `options`, made from a
    seed on `device`: each granule's 20 candidate bit counts falling with
    the gain (a few granules silent), evaluated up to a seeded start gain,
    budgets of 19 or 20, energies over seven decades (some zero), the
    priced demands near the candidates'; most rows valid throughout, some
    ending early with `final` on their last valid frame, some with invalid
    frames mid-chunk; a carry that is not fresh. Returns (config, carry,
    the selection scan's keyword inputs, the placement scan's carry and its
    frame bytes hb [T, B])."""
    import torch

    from swiftmp3_tpu_torch.models import pipeline

    cfg = pipeline.rate_loop_config(options)
    G, K = cfg.n_gran, options.reservoir_depth
    rng = np.random.default_rng(seed)
    start = rng.integers(100, 9000, (T, B, G, 1))
    steps = rng.integers(0, 3, (T, B, G, 20)).cumsum(-1)
    bits = np.maximum(start * 0.88 ** steps + rng.integers(-20, 20, (T, B, G, 20)), 0).astype(int)
    bits[rng.random((T, B, G)) < 0.05] = 0
    gstart = rng.integers(120, 256, (T, B, G, 1))
    evaluated = (np.arange(20) == 0) | (gstart + 4 * np.arange(20) < 255)
    k_budget = np.where(rng.random((T, B, G)) < 0.1, 19, 20)

    def energy(shape):
        e = 10 ** rng.uniform(-9, -2, shape)
        return np.where(rng.random(shape) < 0.05, 0, e).astype(np.float32)

    n_valid = np.where(rng.random(B) < 0.7, T, rng.integers(0, T + 1, B))
    valid = np.arange(T)[:, None] < n_valid[None, :]
    final = (np.arange(T)[:, None] == n_valid[None, :] - 1) & (rng.random(B) < 0.6)
    holes = (rng.random((T, B)) < 0.1) & (rng.random(B) < 0.2)
    valid = valid & ~holes
    sr = options.sample_rate
    slots = rng.integers(100, 1500, (B, K))
    carry = {
        "stream_len": rng.integers(0, 4000, B),
        "avail": rng.integers(0, options.reservoir_cap + 1, B),
        "pad_rem": rng.integers(0, sr, B),
        "slot_fifo": slots,
        "vbr_ehist": energy((B, 10)),
        "vbr_count": rng.integers(0, 11, B),
    }
    demand = np.maximum(bits[..., 10] + rng.integers(-200, 200, (T, B, G)), 0)
    frame_demand = bits[..., min(options.quality, 19)].sum(-1)
    ins = {
        "bits": bits, "evaluated": evaluated, "k_budget": k_budget,
        "granule_e": energy((T, B, G)), "final": final, "valid": valid,
        "frame_e": energy((T, B)) if cfg.rate_law == "energy" else None,
        "demand": demand if cfg.demand_budget else None,
        "frame_demand": frame_demand if cfg.rate_law == "demand" else None,
    }
    placement_carry = {"stream_len": rng.integers(0, 4000, B), "slot_fifo": slots[::-1].copy()}
    hb = rng.integers(0, 1200, (T, B))

    def tensor(x):
        if x is None:
            return None
        x = np.array(x)
        if x.dtype.kind == "f":
            dtype = torch.float32
        else:
            dtype = torch.bool if x.dtype == bool else torch.int32
        return torch.from_numpy(x).to(dtype).to(device)

    def tensors(d):
        return {k: tensor(v) for k, v in d.items()}

    return cfg, tensors(carry), tensors(ins), tensors(placement_carry), tensor(hb)


def card_sum_of_ten(x: np.ndarray) -> np.ndarray:
    """float32 sums of rows of ten in the order torch.sum takes on the card
    (torch 2.11, H100): entries i and i + 8 on lanes 0 and 1, then the eight
    lanes by shuffles down by 4, 2 and 1."""
    a = x[..., :8].astype(np.float32).copy()
    a[..., :2] += x[..., 8:10]
    return ((a[..., 0] + a[..., 4]) + (a[..., 2] + a[..., 6])) + (
        (a[..., 1] + a[..., 5]) + (a[..., 3] + a[..., 7])
    )


def _energy_law_index(total, count, energy, base, quality, table):
    """dsp.vbr_choose_bitrate then bitrate_index_device in float32 numpy, on
    the sum of the history `total`."""
    from swiftmp3_tpu_torch.ops.dsp import vbr_law

    max_adj, lo, hi = vbr_law(base, quality)
    f32 = np.float32
    avg = np.where(count > 0, total / np.maximum(count, 1).astype(f32), energy).astype(f32)
    ratio = np.clip(energy / np.maximum(avg, f32(1e-4)), f32(0.5), f32(2.0)).astype(f32)
    adj = np.trunc(((ratio - f32(1.0)) * f32(max_adj)).astype(f32)).astype(np.int64)
    target = np.maximum(np.minimum(base + adj, hi), lo)
    return np.argmin(np.abs(table - target[..., None]), axis=-1)


def energy_knife_edge_scan_input(B: int, T: int, seed: int = 0, device="cpu"):
    """scan_input of SCAN_OPTIONS["energy_vbr"] whose first frame sits, in
    every row, on a knife edge of the energy law: the frame's energy is
    chosen so that its bitrate index differs between the sum of the ten-entry
    history in the card's order (card_sum_of_ten) and in the order of
    shuffles down by 1, 2 and 4. Returns scan_input's tuple and the first
    frame's index in the card's order [B]."""
    import torch

    from swiftmp3_tpu_torch.ops.dsp import BITRATE_VALUES

    o = scan_options("energy_vbr")
    cfg, carry, ins, p_carry, hb = scan_input(o, B, T, seed, device)
    rng = np.random.default_rng(seed + 1)
    f32 = np.float32
    hist = np.zeros((B, 10), f32)
    energy = np.zeros(B, f32)
    want = np.zeros(B, np.int64)
    ten = np.full(B, 10)
    for b in range(B):
        while True:
            h = (10 ** rng.uniform(-3.5, -1, 10)).astype(f32)
            a = h[:8].copy()
            a[:2] += h[8:]
            up = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]))
            card = card_sum_of_ten(h)
            if up == card:
                continue
            avg = card / f32(10)
            m = np.arange(-30, 61)  # the ratio's clamp: (0.5 - 1) * 53 > -30
            e0 = (avg * (1 + m / 53.0)).astype(f32)
            e = (e0[:, None].view(np.int32) + np.arange(-8, 9)).view(f32).reshape(-1)
            i_card = _energy_law_index(np.full(e.shape, card), 10, e, o.bitrate_kbps, o.quality,
                                       BITRATE_VALUES)
            i_up = _energy_law_index(np.full(e.shape, up), 10, e, o.bitrate_kbps, o.quality,
                                     BITRATE_VALUES)
            edges = np.nonzero(i_card != i_up)[0]
            if len(edges):
                k = edges[rng.integers(len(edges))]
                hist[b], energy[b], want[b] = h, e[k], i_card[k]
                break
    carry["vbr_ehist"] = torch.from_numpy(hist).to(device)
    carry["vbr_count"] = torch.from_numpy(ten.astype(np.int32)).to(device)
    ins["frame_e"][0] = torch.from_numpy(energy).to(device)
    assert np.array_equal(
        _energy_law_index(card_sum_of_ten(hist), ten, energy, o.bitrate_kbps, o.quality,
                          BITRATE_VALUES), want)
    return (cfg, carry, ins, p_carry, hb), want


def chunk_kernel_inputs(options, device, frames: np.ndarray, la: np.ndarray = None) -> dict:
    """Run one chunk of the port's chunk program on `device` from a fresh
    carry (frames [B, T, spf*ch], la its lookahead or None) and return the
    first call's inputs of each kernel wrapper it reaches: {"pack":
    (chunks, nbits, cap), "rate_sweep": (mag, gstart, iso), "strict_sweep":
    (args, kwargs)}."""
    import torch

    from swiftmp3_tpu_torch.models import pipeline
    from swiftmp3_tpu_torch.ops import kernels

    B, T = frames.shape[:2]
    seen = {}
    pack, sweep, strict = kernels.pack, kernels.rate_sweep, kernels.strict_sweep

    def record_pack(chunks, nbits, cap):
        seen.setdefault("pack", (chunks.clone(), nbits.clone(), cap))
        return pack(chunks, nbits, cap)

    def record_sweep(mag, gstart, iso=False):
        seen.setdefault("rate_sweep", (mag.clone(), gstart.clone(), iso))
        return sweep(mag, gstart, iso=iso)

    def record_strict(*args, **kwargs):
        seen.setdefault("strict_sweep", (
            tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args), dict(kwargs),
        ))
        return strict(*args, **kwargs)

    kernels.pack, kernels.rate_sweep, kernels.strict_sweep = record_pack, record_sweep, record_strict
    try:
        pipeline.make_chunk_fn(options)(
            pipeline.init_carry(B, options, device),
            torch.from_numpy(frames).to(device),
            torch.zeros((B, T), dtype=torch.bool, device=device),
            torch.ones((B, T), dtype=torch.bool, device=device),
            None if la is None else torch.from_numpy(la).to(device),
        )
    finally:
        kernels.pack, kernels.rate_sweep, kernels.strict_sweep = pack, sweep, strict
    return seen


def strict_pack_input(device, B: int = 2, T: int = 2, seed: int = 0, mode: str = "joint_stereo"):
    """The main_data pack's input on the strict path: the (chunks, nbits)
    [B*T, P] the port's spec_strict chunk program hands `kernels.pack`
    (36 scalefactor slots, 288 pair and 144 quad slots a granule, so
    P = 1872 in stereo and 936 in mono), and the cap, for B streams of T
    frames of correlated noise with attacks on `device`."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions

    o = MP3EncoderOptions.spec_strict(**dict(STRICT_OPTIONS, mode=mode))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T * 1152 * o.channels)).astype(np.float32) * 0.2
    for i in range(1, 5):
        x[:, i:] += x[:, :-i] / (i + 1)
    x[:, 700:800] *= 20.0  # attacks: short granules and their scalefactors
    return chunk_kernel_inputs(o, device, x.reshape(B, T, -1))["pack"]


def hq_pack_input(
    device, B: int = 2, T: int = 2, seed: int = 0, mode: str = None, preset: str = "hq_joint"
):
    """The main_data pack's input on the hq path: the (chunks, nbits)
    [B*T, P] the port's hq chunk program hands `kernels.pack` (36
    scalefactor slots, 3 x 288 linbits pair slots and 144 quad slots a
    granule, so P = 4176 in stereo and 2088 in mono), and the cap, for B
    streams of T frames of loud correlated noise with attacks on `device`
    (each frame's lookahead the next frame's first granule), under the hq
    configuration `preset` of HQ_OPTIONS, HQ_FLAG_OPTIONS or DC_IS_OPTIONS
    (its mode replaced by `mode`, if given)."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions

    if preset in DC_IS_OPTIONS:
        factory, kw = DC_IS_OPTIONS[preset]
    else:
        factory, kw = "hq", {**HQ_OPTIONS, **HQ_FLAG_OPTIONS}[preset]
    o = getattr(MP3EncoderOptions, factory)(**dict(kw, mode=mode or kw["mode"]))
    n = 1152 * o.channels
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, (T + 1) * n)).astype(np.float32) * 0.3
    for i in range(1, 5):
        x[:, i:] += x[:, :-i] / (i + 1)
    x[:, 700:800] *= 3.0  # attacks: short granules and their scalefactors
    frames = x[:, : T * n].reshape(B, T, n)
    la = np.stack([x[:, (t + 1) * n : (t + 1) * n + n // 2] for t in range(T)], axis=1)
    return chunk_kernel_inputs(o, device, frames, la)["pack"]


def step_lookahead(audio: list, k: int, channels: int) -> np.ndarray:
    """The window-sequencing lookahead of step k of chained steps of audio
    [B, T, 1152*ch] (bench.py:168-175): each frame's next raw granule, the
    last frame's from the next step's first frame (zeros after the last
    step)."""
    la_n = 576 * channels
    pcm = audio[k]
    la = np.zeros(pcm.shape[:2] + (la_n,), dtype=pcm.dtype)
    la[:, :-1] = pcm[:, 1:, :la_n]
    if k + 1 < len(audio):
        la[:, -1] = audio[k + 1][:, 0, :la_n]
    return la


def polyphase_input(B: int = 3, ch: int = 2, T: int = 8, seed: int = 0):
    """The tests/test_pallas.py filterbank input: (hist [B, ch, 480],
    pcm [B, ch, T*1152]) float32."""
    rng = np.random.default_rng(seed)
    hist = (rng.standard_normal((B, ch, 480)) * 0.2).astype(np.float32)
    pcm = (rng.standard_normal((B, ch, T * 1152)) * 0.5).astype(np.float32)
    return hist, pcm


def fma_knife_edges(inv_table: np.ndarray) -> dict[int, np.ndarray]:
    """Per gain g, the float32 magnitudes m whose quantization
    floor(m*inv + 0.5) differs between separate rounding (round the
    product, then the sum — the reference's order) and one fused
    multiply-add. Searched 40 ulps either side of each .5 boundary."""
    inv = inv_table.astype(np.float32)[:, None, None]  # [256, 1, 1]
    q = np.arange(1, 17, dtype=np.float64)[None, :, None]
    x0 = ((q - 0.5) / inv.astype(np.float64)).astype(np.float32)  # [256, 16, 1]
    steps = [x0]
    lo = hi = x0
    for _ in range(40):
        lo = np.nextafter(lo, np.float32(0))
        hi = np.nextafter(hi, np.float32(np.inf))
        steps += [lo, hi]
    m = np.concatenate(steps, axis=-1)  # [256, 16, 81]
    sep = np.floor((m * inv).astype(np.float32) + np.float32(0.5))
    fused = np.floor((m.astype(np.float64) * inv.astype(np.float64) + 0.5).astype(np.float32))
    out = {}
    for g in range(256):
        vals = np.unique(m[g][sep[g] != fused[g]])
        if vals.size:
            out[g] = vals
    return out


def knife_edge_sweep_input(inv_table: np.ndarray, seed: int = 3):
    """Rate-sweep granules whose candidate gains meet FMA knife edges: each
    granule holds, for several of its 20 gains, magnitudes that quantize
    differently under a fused multiply-add. Returns (mag [n, 576], gstart)."""
    edges = fma_knife_edges(inv_table)
    rng = np.random.default_rng(seed)
    starts = [g for g in range(120, 256, 3)]
    mag = np.full((len(starts), 576), np.float32(1e-10) ** np.float32(0.75), np.float32)
    for i, g0 in enumerate(starts):
        vals = []
        for k in range(20):
            g = min(g0 + 4 * k, 255)
            if g in edges:
                vals.extend(rng.choice(edges[g], size=min(4, edges[g].size), replace=False))
        pos = rng.choice(576, size=min(len(vals), 576), replace=False)
        mag[i, pos] = np.asarray(vals[: len(pos)], dtype=np.float32)
    return mag, np.asarray(starts, dtype=np.int32)


def strict_sweep_input(n: int, seed: int = 0, linbits: bool = False, sample_rate: int = 44100):
    """Strict-sweep granules (kernels.strict_sweep's arguments as numpy):
    levels over six decades with the top lines cut 10-1000x at a seeded
    line (so the grid's gains reach the count1 region), an all-zero granule,
    gstart over 0..255 with 252-255 and 0 among them, long granules and
    switching ones (short, START/STOP: not long) with the rate's switching
    region-0 bounds, part2 up to 300 bits; under linbits some lines far past
    QCAP_LINBITS. n >= 6. Returns (mag [n, 576] f32, gstart, is_long,
    b0_switch, part2 [n])."""
    from swiftmp3_tpu_torch.tables import mixed_switch_bound, switch_bound

    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((n, 576)) * 10 ** rng.uniform(-5, 1, (n, 1))
    cut = rng.integers(16, 576, n)
    spec[np.arange(576)[None, :] >= cut[:, None]] *= 10 ** rng.uniform(-3, -1)
    spec[0] = 0.0
    if linbits:
        spec[1::7, rng.integers(0, 576, 3)] = 3e5
    mag = (np.maximum(np.abs(spec), 1e-10) ** 0.75).astype(np.float32)
    gstart = rng.integers(0, 256, n).astype(np.int32)
    gstart[2:6] = (252, 255, 0, 253)
    is_long = rng.random(n) < 0.5
    bounds = (switch_bound(sample_rate, True), switch_bound(sample_rate, False),
              mixed_switch_bound(sample_rate))
    b0_switch = rng.choice(np.asarray(bounds, np.int32), n).astype(np.int32)
    part2 = rng.integers(0, 300, n).astype(np.int32)
    return mag, gstart, is_long, b0_switch, part2


# --- copies of the reference tests' signals (numpy only) ----------------------


def _sine(n: int, sr: int, freq: float, amp: float) -> np.ndarray:
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _noise(n: int, seed: int, amp: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    for i in range(1, 5):  # correlate: reservoir-stressing but audio-like
        x[i:] += x[:-i] / (i + 1)
    return (amp * x / np.abs(x).max()).astype(np.float32)


def _burst(n: int, sr: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    x = (0.35 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    env = np.zeros(n, dtype=np.float32)
    p = 700
    while p < n - 1200:
        env[p : p + 500] = 1.0
        p += int(rng.integers(1900, 2700))
    return (x * (0.2 + 0.8 * env)).astype(np.float32)


def make_signal(kind: str, seconds: float, sr: int, channels: int, seed: int) -> np.ndarray:
    """Copy of tests/fixture_lib.make_signal."""
    n = int(seconds * sr)
    if kind == "sine":
        mono = _sine(n, sr, 440.0, 0.5)
    elif kind == "noise":
        mono = _noise(n, seed, 0.35)
    elif kind == "mix":
        mono = _sine(n, sr, 523.25, 0.3) + _noise(n, seed, 0.2)
    elif kind == "burst":
        mono = _burst(n, sr, seed)
    else:
        raise ValueError(kind)
    if channels == 1:
        return mono
    # slightly decorrelated channels so the M/S decision is exercised
    right = np.roll(mono, 7) * np.float32(0.9)
    return np.stack([mono, right], axis=-1).reshape(-1)


# The 8 compat rows of tests/fixture_lib.FIXTURES:
# (name, options kwargs, signal kind, seconds, seed).
COMPAT_FIXTURES = [
    ("mono_cbr128_44k_sine", dict(mode="mono"), "sine", 0.40, 1),
    ("stereo_cbr128_44k_noise", dict(mode="stereo"), "noise", 0.40, 2),
    (
        "joint_cbr192_48k_mix",
        dict(mode="joint_stereo", bitrate_kbps=192, sample_rate=48000),
        "mix",
        0.37,
        3,
    ),
    ("mono_vbr_q3_44k_noise", dict(mode="mono", vbr=True, quality=3), "noise", 0.40, 4),
    ("stereo_crc_cbr128_44k_sine", dict(mode="stereo", crc_protected=True), "sine", 0.40, 5),
    (
        "mono_cbr64_32k_noise",
        dict(mode="mono", bitrate_kbps=64, sample_rate=32000),
        "noise",
        0.45,
        6,
    ),
    (
        "stereo_aligned_cbr128_44k_mix",
        dict(mode="stereo", reservoir_mode="aligned"),
        "mix",
        0.40,
        7,
    ),
    (
        "joint_vbr_q7_crc_aligned_48k_noise",
        dict(
            mode="joint_stereo",
            vbr=True,
            quality=7,
            crc_protected=True,
            sample_rate=48000,
            reservoir_mode="aligned",
        ),
        "noise",
        0.37,
        8,
    ),
]


_STRICT_FLAGS = dict(
    reservoir_mode="aligned",
    iso_quantization=True,
    count1_coding=True,
    region_table_select=True,
    real_scalefactors=True,
)

# The 4 strict rows of tests/fixture_lib.FIXTURES, in its order.
STRICT_FIXTURES = [
    (
        "strict_full_mono_44k_noise",
        dict(mode="mono", iso_crc=True, crc_protected=True, **_STRICT_FLAGS),
        "noise",
        0.40,
        9,
    ),
    (
        "strict_full_stereo_48k_mix",
        dict(
            mode="stereo",
            sample_rate=48000,
            bitrate_kbps=160,
            iso_crc=True,
            crc_protected=True,
            **_STRICT_FLAGS,
        ),
        "mix",
        0.37,
        10,
    ),
    (
        "strict_shortblocks_mono_44k_burst",
        dict(mode="mono", iso_short_blocks=True, **_STRICT_FLAGS),
        "burst",
        0.42,
        11,
    ),
    (
        "strict_msmatrix_joint_48k_burst",
        dict(
            mode="joint_stereo",
            sample_rate=48000,
            iso_short_blocks=True,
            iso_mode_ext=True,
            iso_ms_matrix=True,
            **_STRICT_FLAGS,
        ),
        "burst",
        0.40,
        12,
    ),
]


# The hq fixture rows: the signals of the 4 strict rows (kind, seconds, seed),
# stereo at 44.1 kHz, encoded under each hq configuration.
HQ_ROWS = [(f"row_{name[len('strict_'):]}", kind, seconds, seed)
           for name, _, kind, seconds, seed in STRICT_FIXTURES]

# Five more strict configurations whose JAX-backend bytes are frozen under
# tests/fixtures/torch/ (jax_<name>.mp3): (name, options kwargs, preset,
# signal kind, seconds, seed); preset "spec_strict" builds the options with
# MP3EncoderOptions.spec_strict(**kwargs), None with MP3EncoderOptions(**kwargs).
STRICT_EXTRA_ROWS = [
    ("strict_vbr_q3_joint_44k_mix",
     dict(mode="joint_stereo", vbr=True, quality=3), "spec_strict", "mix", 0.40, 31),
    ("strict_mono_64k_32k_noise",
     dict(mode="mono", bitrate_kbps=64, sample_rate=32000), "spec_strict", "noise", 0.45, 32),
    ("strict_scfsi_psy_crc_joint_44k_burst",
     dict(mode="joint_stereo", scfsi=True, psy_scalefactors=True, crc_protected=True),
     "spec_strict", "burst", 0.40, 33),
    ("strict_noshort_stereo_48k_burst",
     dict(mode="stereo", sample_rate=48000, iso_short_blocks=False), "spec_strict", "burst",
     0.37, 34),
    ("strict_entropy_compat_reservoir_stereo_44k_mix",
     dict(mode="stereo", count1_coding=True, region_table_select=True), None, "mix", 0.40, 35),
]


def hq_streams() -> dict:
    """Every input whose hq streams are frozen under tests/fixtures/torch/
    (golden_<preset>_<stem>.mp3 from the golden encoder, jax_<preset>_<stem>.mp3
    from the JAX backend, for each preset of HQ_OPTIONS): {stem: PCM}, the
    HQ_ROWS signals and the telemetry corpus, interleaved stereo float32."""
    out = {stem: make_signal(kind, seconds, 44100, 2, seed) for stem, kind, seconds, seed in HQ_ROWS}
    out.update({f"corpus_{k}": pcm for k, pcm in corpus_stereo().items()})
    return out


def jax_path(stem: str) -> str:
    """The JAX backend's frozen stream of `stem` (jax_<stem>.mp3)."""
    return os.path.join(TORCH_FIXTURE_DIR, f"jax_{stem}.mp3")


# A checkpoint in the middle of an hq stream: the corpus class, the preset and
# the sample at which the stream is cut.
HQ_CHECKPOINT = ("corpus_tonal", "hq_joint", 2 * 1152 * 6 + 500)


def checkpoint_path(side: str, preset: str = HQ_CHECKPOINT[1]) -> str:
    """The frozen session checkpoint taken by `side` ("jax" or "port") in the
    middle of `preset`'s checkpoint stream (HQ_CHECKPOINT, DEPTH_CHECKPOINT),
    with the bytes emitted before the cut."""
    return os.path.join(TORCH_FIXTURE_DIR, f"checkpoint_{side}_{preset}.npz")


# The rest of the hq flags (ROADMAP item 8d): MP3EncoderOptions.hq(**kwargs)
# at 96 kbps, where the preset engages its rate-derived adaptive lowpass,
# mono and joint stereo; a static 10 kHz lowpass; demand VBR at quality 5
# (tests/test_ulp_telemetry.py's hq_vbr_demand_q5); reservoir depth 3 at 96
# kbps (tests/test_reservoir_depth.py's configuration).
HQ_FLAG_OPTIONS = {
    "hq_mono_96k": dict(mode="mono", bitrate_kbps=96, sample_rate=44100),
    "hq_joint_96k": dict(mode="joint_stereo", bitrate_kbps=96, sample_rate=44100),
    "hq_mono_lowpass10k": dict(mode="mono", bitrate_kbps=128, sample_rate=44100,
                               lowpass_hz=10000),
    "hq_vbr_demand_q5": dict(mode="mono", bitrate_kbps=128, sample_rate=44100, vbr=True,
                             vbr_demand=True, quality=5),
    "hq_mono_96k_depth3": dict(mode="mono", bitrate_kbps=96, sample_rate=44100,
                               reservoir_depth=3),
}
# A checkpoint in the middle of the depth-3 stream, where the slot fifo holds
# three slots.
DEPTH_CHECKPOINT = ("sparse", "hq_mono_96k_depth3", 7 * 1152 + 300)


def sparse_transients(n: int, seed: int = 21) -> np.ndarray:
    """Copy of tests/test_reservoir_depth._sparse: a quiet tone bed with
    short noise hits every 8 frames, mono float32; the content on which a
    deep reservoir reaches back past one slot."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    x = 0.08 * np.sin(2 * np.pi * 330 * t)
    for f in range(3, n // 1152, 8):
        off = f * 1152 + 400
        x[off : off + 300] += 0.7 * rng.standard_normal(300)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def corpus_mono(pcm: np.ndarray) -> np.ndarray:
    """Copy of tests/test_ulp_telemetry._mono: the mean of the two channels."""
    x = pcm.reshape(-1, 2)
    return ((x[:, 0] + x[:, 1]) * 0.5).astype(np.float32)


def hq_flag_streams(preset: str) -> dict:
    """The inputs whose streams under HQ_FLAG_OPTIONS[preset] are frozen
    under tests/fixtures/torch/ (jax_<preset>_<stem>.mp3 and
    golden_<preset>_<stem>.mp3): {stem: PCM}, the telemetry corpus (mono as
    the telemetry suite folds it), or for the depth-3 configuration 16
    frames of sparse transients."""
    if HQ_FLAG_OPTIONS[preset].get("reservoir_depth", 1) > 1:
        return {"sparse": sparse_transients(16 * 1152)}
    mono = HQ_FLAG_OPTIONS[preset]["mode"] == "mono"
    return {f"corpus_{k}": corpus_mono(v) if mono else v for k, v in corpus_stereo().items()}


# Distortion control and intensity stereo (ROADMAP Queue 1 items 9 and 10):
# {preset: (factory, kwargs)}, the options MP3EncoderOptions.<factory>(**kwargs)
# builds. The telemetry suite's hq_dc_mono128 and hq_is_32k
# (tests/test_ulp_telemetry.py), distortion control at its depth knobs, and
# the spec_strict preset's intensity stereo, which gates on the raw transient
# verdicts (no window sequencing).
DC_IS_OPTIONS = {
    "hq_dc_mono128": ("hq", dict(mode="mono", bitrate_kbps=128, sample_rate=44100,
                                 distortion_control=True)),
    "hq_dc3p_mono128": ("hq", dict(mode="mono", bitrate_kbps=128, sample_rate=44100,
                                   distortion_control=True, dc_passes=3, dc_proportional=True)),
    "hq_is_32k": ("hq", dict(mode="joint_stereo", bitrate_kbps=32, sample_rate=44100,
                             intensity_stereo=True)),
    "strict_is_32k": ("spec_strict", dict(mode="joint_stereo", bitrate_kbps=32, sample_rate=44100,
                                          intensity_stereo=True)),
}
# The corpus classes each DC_IS_OPTIONS preset's frozen rows cover: all six
# for the two telemetry configurations (their golden corpus), stationary and
# transient classes for the others.
DC_IS_CLASSES = {
    "hq_dc_mono128": ("tonal", "noise", "burst", "speech", "decorr", "panned"),
    "hq_dc3p_mono128": ("speech", "burst"),
    "hq_is_32k": ("tonal", "noise", "burst", "speech", "decorr", "panned"),
    "strict_is_32k": ("panned", "burst"),
}


def dc_is_options(preset: str, options_cls, mode_cls=str):
    """DC_IS_OPTIONS[preset] built by either package's MP3EncoderOptions
    (mode_cls: that package's Mode, or str for the port)."""
    factory, kw = DC_IS_OPTIONS[preset]
    return getattr(options_cls, factory)(**dict(kw, mode=mode_cls(kw["mode"])))


def preset_options(preset: str):
    """The port's MP3EncoderOptions of a key of SCAN_OPTIONS or
    DC_IS_OPTIONS."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions

    if preset in DC_IS_OPTIONS:
        return dc_is_options(preset, MP3EncoderOptions)
    return scan_options(preset)


def dc_is_streams(preset: str) -> dict:
    """The inputs whose streams under DC_IS_OPTIONS[preset] are frozen under
    tests/fixtures/torch/ (jax_<preset>_<stem>.mp3, golden_<preset>_<stem>.mp3):
    {stem: PCM}, the classes of DC_IS_CLASSES from the telemetry corpus, mono
    as the telemetry suite folds it for mono presets."""
    mono = DC_IS_OPTIONS[preset][1]["mode"] == "mono"
    corpus = corpus_stereo()
    return {f"corpus_{k}": corpus_mono(corpus[k]) if mono else corpus[k]
            for k in DC_IS_CLASSES[preset]}


# encode_corpus's frozen file: the JAX package's first complete file (ID3 tag,
# Xing header, frames) of CORPUS_STREAMS under CORPUS_OPTIONS with per-stream
# tags (title, artist), frames_per_step 4.
CORPUS_OPTIONS = dict(mode="stereo", bitrate_kbps=128, sample_rate=44100)
CORPUS_TAGS = [("Stream zero", "swiftmp3"), ("Stream one", "swiftmp3")]


def corpus_streams() -> list:
    """Two stereo streams of unequal length, one int16 and one float32."""
    a = (make_signal("mix", 0.3, 44100, 2, 41) * 32767).astype(np.int16)
    return [a, make_signal("burst", 0.2, 44100, 2, 42)]


# The command line's frozen file: the JAX package's CLI output on a mono WAV
# (tests write it with utils.wav.write_wav from CLI_SIGNAL) with CLI_ARGS:
# the hq preset at 96 kbps with a static 11 kHz lowpass (the command line
# passes lowpass_hz always, so the preset's rate-derived rule stays off).
CLI_SIGNAL = ("burst", 0.4, 44100, 1, 43)  # kind, seconds, rate, channels, seed
CLI_ARGS = ["--hq", "--bitrate", "96", "--lowpass", "11000", "--gapless", "--title", "Port",
            "--artist", "swiftmp3", "--quiet"]


def cli_pcm() -> np.ndarray:
    kind, seconds, sr, channels, seed = CLI_SIGNAL
    return make_signal(kind, seconds, sr, channels, seed)


# --- The mesh and the multi-process batch (ROADMAP Queue 1 item 12) ------------

# The JAX package's encode_batch over its 8-position CPU mesh
# (make_mesh() under --xla_force_host_platform_device_count=8), frames_per_step
# MESH_STEP, is frozen as jax_mesh_<set>_<i>.mp3 for each stream of each set of
# mesh_streams(); its single-process encode_batch_multihost of each of
# multihost_streams() as jax_multihost_<dtype>.mp3. (options kwargs, streams)
# per set: tests/test_parallel.py's compat mono streams (:18-33), and an hq
# joint-stereo set with each frame's lookahead granule (unequal lengths, an
# empty stream, an int16 stream among float ones, an exact frame multiple).
MESH_STEP = 4
MESH_OPTIONS = {
    "mono": (None, dict(mode="mono", bitrate_kbps=128, sample_rate=44100)),
    "hq": ("hq", dict(mode="joint_stereo", bitrate_kbps=128, sample_rate=44100)),
}


def mesh_streams(name: str) -> list:
    if name == "mono":  # a copy of tests/test_parallel.py's
        rng = np.random.default_rng(0)
        return [
            (rng.standard_normal(1152 * (2 + i % 3) + (211 * i) % 1000) * 0.4).astype(np.float32)
            for i in range(5)
        ]
    return [
        make_signal("burst", 0.15, 44100, 2, 51),
        np.zeros(0, dtype=np.float32),
        (make_signal("mix", 0.08, 44100, 2, 52) * 32767).astype(np.int16),
        np.resize(make_signal("noise", 0.2, 44100, 2, 53), 2 * 1152 * 5),
        make_signal("mix", 0.1, 44100, 2, 54),
    ]


def multihost_streams() -> dict:
    """A copy of tests/test_parallel.py's encode_batch_multihost streams
    (:84-97), mono, under MESH_OPTIONS["mono"]: {dtype name: PCM}."""
    rng = np.random.default_rng(11)
    f32 = (rng.standard_normal(1152 * 3 + 200) * 0.4).astype(np.float32)
    i16 = (rng.standard_normal(1152 * 2 + 900) * 8000).astype(np.int16)
    return {"float32": f32, "int16": i16}


# The graft entry (swiftmp3_tpu_torch/graft_entry.py against
# __graft_entry__.py): the JAX entry's step and the JAX dry run at each of
# ENTRY_DRYRUN_POSITIONS positions (batch 2 a position, 2 frames), frozen in
# one file by `python -m tests.torch_freeze_fixtures entry`. Its keys are
# "entry.<outputs|carry>.<name>" and "dry<n>.<vbr|hq>.<outputs|carry>.<name>".
ENTRY_FIXTURE = os.path.join(TORCH_FIXTURE_DIR, "jax_entry.npz")
ENTRY_DRYRUN_POSITIONS = (1, 2, 4, 8)


def entry_arrays(run: str, outputs: dict, carry: dict) -> dict:
    """One run's fetched outputs and carry under ENTRY_FIXTURE's keys."""
    return {
        **{f"{run}.outputs.{k}": np.asarray(v) for k, v in outputs.items()},
        **{f"{run}.carry.{k}": np.asarray(v) for k, v in carry.items()},
    }


def frozen_entry(run: str) -> tuple[dict, dict]:
    """(fetched outputs, carry) of a frozen run: "entry", or "dry<n>.vbr" /
    "dry<n>.hq"."""
    outputs, carry = {}, {}
    with np.load(ENTRY_FIXTURE) as z:
        for key in z.files:
            head, part, name = key.rsplit(".", 2)
            if head == run:
                (outputs if part == "outputs" else carry)[name] = z[key]
    if not outputs:
        raise KeyError(f"{run} is not in {ENTRY_FIXTURE}")
    return outputs, carry


def differing_frames(got: dict, ref: dict) -> int:
    """Frames (stream, time) in which any fetched field, main_data bytes
    included, differs; raises when the fields or their shapes differ."""
    if sorted(got) != sorted(ref):
        raise ValueError(f"fields differ: {sorted(set(got) ^ set(ref))}")
    differ = None
    for k, want in ref.items():
        have = np.asarray(got[k])
        if have.shape != want.shape:
            raise ValueError(f"{k}: shape {have.shape}, want {want.shape}")
        d = (have != want).reshape(*want.shape[:2], -1).any(axis=-1)
        differ = d if differ is None else differ | d
    return int(differ.sum())


def save_session_state(path: str, state: dict, **extra) -> None:
    """An EncoderSession.state_dict() (either package's) as an .npz of plain
    arrays; `extra` arrays ride along."""
    heads = list(state["buffered_heads"])
    arrays = {
        "pcm": np.asarray(state["pcm"], np.float32),
        "fed": np.asarray(state["fed"]),
        "fed_samples": np.asarray(state["fed_samples"], np.int64),
        "reservoir_stream": np.frombuffer(bytes(state["reservoir_stream"]), np.uint8),
        "reservoir_avail": np.asarray(state["reservoir_avail"], np.int64),
        "buffered_heads": np.frombuffer(b"".join(heads), np.uint8),
        "buffered_head_sizes": np.asarray([len(h) for h in heads], np.int64),
        "buffered_slots": np.asarray(state["buffered_slots"], np.int64),
        "frame_count": np.asarray(state["frame_count"], np.int64),
        "total_bytes": np.asarray(state["total_bytes"], np.int64),
        "frame_sizes": np.asarray(state["frame_sizes"], np.int64),
        **{f"backend.{k}": np.asarray(v) for k, v in state["backend"].items()},
        **{f"extra.{k}": np.asarray(v) for k, v in extra.items()},
    }
    np.savez(path, **arrays)


def load_session_state(path: str) -> tuple[dict, dict]:
    """(state_dict, extra arrays) saved by save_session_state."""
    z = np.load(path)
    heads, o = [], 0
    blob = z["buffered_heads"].tobytes()
    for n in z["buffered_head_sizes"].tolist():
        heads.append(blob[o : o + n])
        o += n
    state = {
        "pcm": z["pcm"],
        "fed": bool(z["fed"]),
        "fed_samples": int(z["fed_samples"]),
        "reservoir_stream": z["reservoir_stream"].tobytes(),
        "reservoir_avail": int(z["reservoir_avail"]),
        "buffered_heads": heads,
        "buffered_slots": z["buffered_slots"].tolist(),
        "frame_count": int(z["frame_count"]),
        "total_bytes": int(z["total_bytes"]),
        "frame_sizes": z["frame_sizes"].tolist(),
        "backend": {k[len("backend."):]: z[k] for k in z.files if k.startswith("backend.")},
    }
    extra = {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}
    return state, extra


def fixture_path(name: str, backend: str) -> str:
    """A committed reference stream, tests/fixtures/<name>.<backend>.mp3."""
    return os.path.join(FIXTURE_DIR, f"{name}.{backend}.mp3")


def corpus_stereo() -> dict:
    """Copy of tests/test_ulp_telemetry._corpus_stereo: the fixed mixed
    corpus (6 classes x 12 frames), interleaved stereo float32."""
    sr, n = 44100, 1152 * 12
    rng = np.random.default_rng(20260820)
    t = np.arange(n) / sr
    out = {}

    tone = 0.4 * np.sin(2 * np.pi * 441.0 * t) + 0.15 * np.sin(2 * np.pi * 1320.0 * t)
    out["tonal"] = (tone, 0.8 * tone)

    ar = rng.standard_normal(n + 8).astype(np.float64)
    for i in range(1, 8):
        ar[i:] += ar[:-i] / (i + 1)
    ar = 0.25 * ar[:n] / np.abs(ar[:n]).max()
    out["noise"] = (ar, ar + 0.01 * rng.standard_normal(n))

    burst = 0.3 * np.sin(2 * np.pi * 600.0 * t)
    for k in range(1152 * 2, n, 1152 * 3):
        burst[k : k + 96] += rng.standard_normal(96) * 0.6
    out["burst"] = (burst, burst * 0.9)

    exc = np.zeros(n)
    exc[:: int(sr / 120)] = 1.0
    exc += 0.3 * rng.standard_normal(n)
    sp = np.copy(exc)
    for i in range(1, 10):
        sp[i:] += sp[:-i] * (0.75 / i)
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t))
    sp = 0.3 * env * sp / np.abs(sp).max()
    out["speech"] = (sp, sp)

    out["decorr"] = (0.2 * rng.standard_normal(n), 0.2 * rng.standard_normal(n))

    pan = 0.35 * np.sin(2 * np.pi * 523.25 * t) + 0.1 * np.sin(2 * np.pi * 2093.0 * t)
    out["panned"] = (pan, 0.25 * pan)
    return {
        k: np.stack([np.asarray(l, np.float32), np.asarray(r, np.float32)], axis=-1).reshape(-1)
        for k, (l, r) in out.items()
    }


def bench_audio(
    rng, B: int, T: int, channels: int, sample_rate: int, spf: int = 1152
) -> np.ndarray:
    """Speech/music-like correlated audio, int16 interleaved [B, T, spf*ch]
    (spf samples a frame: 1152, or 576 at LSF rates); unique content per
    call (the generator of bench.py)."""
    t_ax = np.arange(T * spf) / sample_rate
    base = sum(
        a * np.sin(2 * np.pi * f * t_ax)
        for a, f in [(0.35, 220.0), (0.2, 467.0), (0.1, 1313.0)]
    )
    ar = rng.standard_normal((B, T * spf)).astype(np.float32)
    for i in range(1, 8):
        ar[:, i:] += ar[:, :-i] / (i + 1)
    ar *= 0.05 / np.abs(ar).max()
    sig = (base[None, :] * rng.uniform(0.5, 1.0, (B, 1)) + ar).astype(np.float32)
    mono = (np.clip(sig, -0.99, 0.99) * 32767).astype(np.int16)
    return np.repeat(mono[..., None], channels, axis=-1).reshape(B, T, spf * channels)


def panned_audio(rng, B: int, T: int, sample_rate: int = 44100) -> np.ndarray:
    """Panned two-tone stereo, int16 interleaved [B, T, 2304]: per stream a
    tone of 200-600 Hz and one of 1.8-4 kHz (above intensity stereo's lowest
    band) over quiet noise, the right channel the left at a gain of 0.1-0.6;
    the content intensity stereo codes (the telemetry corpus's panned
    class, at full width)."""
    t = np.arange(T * 1152, dtype=np.float32) * np.float32(2 * np.pi / sample_rate)
    f1 = rng.uniform(200, 600, (B, 1)).astype(np.float32)
    f2 = rng.uniform(1800, 4000, (B, 1)).astype(np.float32)
    left = np.sin(f1 * t) * np.float32(0.35 * 32767)
    left += np.sin(f2 * t) * np.float32(0.12 * 32767)
    left += rng.standard_normal((B, T * 1152), dtype=np.float32) * np.float32(0.002 * 32767)
    pcm = np.empty((B, T * 1152, 2), dtype=np.int16)
    pcm[..., 0] = left
    pcm[..., 1] = left * rng.uniform(0.1, 0.6, (B, 1)).astype(np.float32)
    return pcm.reshape(B, T, 1152 * 2)


def main_path_streams() -> list[np.ndarray]:
    """The 2 main-path streams held against the golden encoder: streams 0
    and 1 of the first step's audio of chip_smoke.py (bench_audio from seed
    0 at B_MAIN x T_MAIN), interleaved int16."""
    audio = bench_audio(np.random.default_rng(0), B_MAIN, T_MAIN, 2, 44100)
    return [audio[b].reshape(-1) for b in range(2)]


def golden_streams(main_audio: np.ndarray = None) -> dict:
    """Every input whose golden-encoder stream is frozen under
    tests/fixtures/torch/ (options MAIN_OPTIONS): {file stem: PCM}.
    main_audio: the first step's bench audio [B, T, 2304], if the caller
    already made it (else it is made here)."""
    if main_audio is None:
        streams = main_path_streams()
    else:
        streams = [main_audio[b].reshape(-1) for b in range(2)]
    out = {f"main_stream{b}": pcm for b, pcm in enumerate(streams)}
    out.update({f"corpus_{k}": pcm for k, pcm in corpus_stereo().items()})
    return out


def golden_path(stem: str, preset: str = "compat") -> str:
    """The frozen golden stream of `stem`: under MAIN_OPTIONS (preset
    "compat"), MP3EncoderOptions.spec_strict(**STRICT_OPTIONS) ("strict") or
    MP3EncoderOptions.hq(**HQ_OPTIONS[preset]) ("hq_joint", "hq_stereo")."""
    prefix = "golden_" if preset == "compat" else f"golden_{preset}_"
    return os.path.join(TORCH_FIXTURE_DIR, f"{prefix}{stem}.mp3")


# --- LSF sample rates and free format (ROADMAP Queue 1 item 11) ---------------

# The JAX backend's frozen bytes of each row: {row: (factory, kwargs, signal)}
# (jax_<row>.mp3). factory "spec_strict"/"hq" builds the options with
# MP3EncoderOptions.<factory>(**kwargs), None with MP3EncoderOptions(**kwargs);
# signal names a maker below and its arguments. The LSF rows: the JAX
# package's device-parity rows of tests/test_lsf_encode.py (spec_strict joint
# stereo 64 kbps at 22.05 kHz on its burst input, hq mono 48 kbps at 16 kHz),
# hq joint stereo 80 kbps at 24 kHz (its adaptive 10 kHz lowpass engages),
# spec_strict mono 48 kbps at 8 kHz (MPEG-2.5) on mixed-block content, demand
# VBR at quality 3, joint stereo without iso_short_blocks on mixed-block
# content (mixed granules demoted to short), and the non-strict program under
# the ISO law (the LSF path of the rate-sweep kernel).
LSF_ROWS = {
    "lsf_strict_joint64_22k_burst": (
        "spec_strict", dict(mode="joint_stereo", bitrate_kbps=64, sample_rate=22050),
        ("lsf_burst", 11)),
    "lsf_hq_mono48_16k_content": (
        "hq", dict(mode="mono", bitrate_kbps=48, sample_rate=16000), ("lsf_content", 1.0, 3)),
    "lsf_hq_joint80_24k_content": (
        "hq", dict(mode="joint_stereo", bitrate_kbps=80, sample_rate=24000),
        ("lsf_content", 0.75, 5)),
    "lsf_strict_mono48_8k_mixed": (
        "spec_strict", dict(mode="mono", bitrate_kbps=48, sample_rate=8000),
        ("lsf_mixed_content", 30, 3)),
    "lsf_strict_noshort_joint48_22k_mixed": (
        "spec_strict", dict(mode="joint_stereo", bitrate_kbps=48, sample_rate=22050,
                            iso_short_blocks=False), ("lsf_mixed_content", 30, 3)),
    "lsf_strict_vbr_q3_22k_content": (
        "spec_strict", dict(mode="joint_stereo", bitrate_kbps=64, sample_rate=22050, vbr=True,
                            vbr_demand=True, quality=3), ("lsf_content", 1.1, 3)),
    "lsf_iso_stereo64_22k_burst": (
        None, dict(mode="stereo", bitrate_kbps=64, sample_rate=22050, iso_quantization=True,
                   reservoir_mode="aligned"), ("lsf_burst", 12)),
}
# Free format: tests/test_freeformat.py's rows, mono 150 kbps (an off-table
# rate) with linbits at 44.1 kHz, on noise.
FF_ROWS = {
    "ff_strict_mono150_44k_noise": (
        "spec_strict", dict(mode="mono", bitrate_kbps=150, sample_rate=44100, free_format=True,
                            linbits_tables=True), ("ff_noise", 6, 5)),
}
# The LSF and free-format paths chip_smoke.py drives at full width (B_MAIN x
# T_MAIN, free format one step) and tools/torch_profile_step.py --lsf
# profiles: {path: (factory, kwargs)}. spec_strict joint stereo 64 kbps at
# 22.05 kHz and hq mono 48 kbps at 16 kHz (the JAX package's device-parity
# rows), the non-strict program at 22.05 kHz under the ISO law (the only LSF
# path of the rate-sweep kernel), and free format at 150 kbps.
LSF_PATHS = {
    "lsf strict": ("spec_strict", dict(mode="joint_stereo", bitrate_kbps=64, sample_rate=22050)),
    "lsf hq": ("hq", dict(mode="mono", bitrate_kbps=48, sample_rate=16000)),
    "lsf iso": (None, dict(mode="stereo", bitrate_kbps=64, sample_rate=22050,
                           iso_quantization=True, reservoir_mode="aligned")),
    "free format": ("spec_strict", dict(mode="mono", bitrate_kbps=150, sample_rate=44100,
                                        free_format=True, linbits_tables=True)),
}
# Steps of an odd number of frames: each row's JAX bytes are also frozen as
# the JAX package's encode_batch gives them at ODD_STEP frames a step
# (jax_<row>_step7.mp3). At LSF rates a frame is 18 filterbank windows, so a
# chunk of an odd number of frames moves the next chunk's frames to the
# other half of the folded filterbank's 4-window rows, another float order.
ODD_STEP = 7
# A checkpoint in the middle of the hq LSF row (tests/test_lsf_encode.py's
# cut): the row and the sample at which its stream is cut.
LSF_CHECKPOINT = ("lsf_hq_mono48_16k_content", 576 * 9 + 77)


def lsf_burst(channels: int, seed: int) -> np.ndarray:
    """Copy of the input of tests/test_lsf_encode.test_lsf_device_backend_byte_equality:
    13 frames and 200 samples of quiet noise with loud noise bursts every
    4000 samples, interleaved float32."""
    rng = np.random.default_rng(seed)
    n = (576 * 13 + 200) * channels
    pcm = (0.02 * rng.standard_normal(n)).astype(np.float32)
    for c in range(1500, n - 600, 4000):
        pcm[c : c + 350] += (0.5 * rng.standard_normal(350)).astype(np.float32)
    return np.clip(pcm, -1, 1)


def lsf_content(sr: int, seconds: float, channels: int, seed: int) -> np.ndarray:
    """Copy of tests/test_lsf_encode._content: a tonal bed with noise and
    one hard burst, the right channel the left delayed by 5 samples at 0.8;
    interleaved float32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float32) / sr
    base = (
        0.35 * np.sin(2 * np.pi * 330.0 * t)
        + 0.1 * np.sin(2 * np.pi * 997.0 * t)
        + 0.04 * rng.standard_normal(n)
    ).astype(np.float32)
    c = n // 2
    base[c : c + 400] += (0.45 * rng.standard_normal(400)).astype(np.float32)
    if channels == 1:
        return base
    return np.stack([base, np.roll(base, 5) * 0.8], axis=1).astype(np.float32).reshape(-1)


def lsf_mixed_content(sr: int, n_frames: int, seed: int, channels: int = 1) -> np.ndarray:
    """Copy of tests/test_lsf_encode._mixed_content: a tone with noise
    attacks at granule starts (the MIXED verdict), mono float32; in stereo
    the right channel the left delayed 3 samples at 0.7, interleaved."""
    rng = np.random.default_rng(seed)
    n = 576 * n_frames
    t = np.arange(n) / sr
    pcm = (0.25 * np.sin(2 * np.pi * 400.0 * t)).astype(np.float32)
    for k in range(576 * 4, n - 600, 576 * 5):
        pcm[k : k + 120] += (rng.standard_normal(120) * 0.55).astype(np.float32)
    if channels == 1:
        return pcm
    return np.stack([pcm, np.roll(pcm, 3) * np.float32(0.7)], axis=1).reshape(-1)


def ff_noise(n_frames: int, seed: int) -> np.ndarray:
    """Copy of the input of tests/test_freeformat.test_free_format_encode_backends_byte_equal."""
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(n_frames * 1152)).astype(np.float32)


def build_options(factory, kw: dict, options_cls, mode_cls=str):
    """MP3EncoderOptions.<factory>(**kw), or MP3EncoderOptions(**kw) when
    factory is None, of either package (mode_cls: that package's Mode, or
    str for the port)."""
    kw = dict(kw, mode=mode_cls(kw["mode"]))
    return getattr(options_cls, factory)(**kw) if factory else options_cls(**kw)


def lsf_row_options(row: str, options_cls, mode_cls=str):
    """The options of a row of LSF_ROWS or FF_ROWS, built by either package's
    MP3EncoderOptions."""
    factory, kw, _ = {**LSF_ROWS, **FF_ROWS}[row]
    return build_options(factory, kw, options_cls, mode_cls)


def path_kernel_inputs(device, path: str, B: int = 2, T: int = 2, seed: int = 0) -> dict:
    """The kernels' inputs on a path of LSF_PATHS (chunk_kernel_inputs: the
    pack's, and the rate sweep's on the path that sweeps) for B streams of
    T frames of the bench audio (each frame's lookahead the next frame's
    granule) on `device`."""
    from swiftmp3_tpu_torch.options import MP3EncoderOptions

    o = build_options(*LSF_PATHS[path], MP3EncoderOptions)
    audio = [bench_audio(np.random.default_rng(seed), B, T, o.channels, o.sample_rate,
                         o.samples_per_frame) for _ in range(2)]
    return chunk_kernel_inputs(o, device, audio[0], step_lookahead(audio, 0, o.channels))


def lsf_row_pcm(row: str) -> np.ndarray:
    """The input of a row of LSF_ROWS or FF_ROWS."""
    factory, kw, (maker, *args) = {**LSF_ROWS, **FF_ROWS}[row]
    channels = 1 if kw["mode"] == "mono" else 2
    if maker == "lsf_burst":
        return lsf_burst(channels, *args)
    if maker == "lsf_content":
        return lsf_content(kw["sample_rate"], args[0], channels, args[1])
    if maker == "lsf_mixed_content":
        return lsf_mixed_content(kw["sample_rate"], *args, channels)
    return ff_noise(*args)


# Frame walk of MPEG-1, MPEG-2 and MPEG-2.5 Layer III streams (numpy only;
# tests/util.parse_frames reads MPEG-1 alone).
_BITRATES_V1 = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0)
_BITRATES_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0)
# header version bits -> (version name, sample rates by index)
_VERSIONS = {3: ("1", (44100, 48000, 32000)), 2: ("2", (22050, 24000, 16000)),
             0: ("2.5", (11025, 12000, 8000))}


def walk_frames(data: bytes, free_kbps: int | None = None) -> list[dict]:
    """The frames of a contiguous Layer III stream of any version: per frame
    its offset, size, version ("1", "2", "2.5"), bitrate_index, bitrate_kbps,
    sample_rate, padding, mode, mode_extension and samples (1152, or 576 at
    LSF rates). Free-format frames (index 0) take their size from
    free_kbps, the stream's exact rate. Raises on a bad header, a gap or
    trailing bytes."""
    frames = []
    i = 0
    while i + 4 <= len(data):
        b = data[i : i + 4]
        if not (b[0] == 0xFF and (b[1] & 0xE0) == 0xE0 and (b[1] >> 1) & 3 == 1):
            raise ValueError(f"bad Layer III sync at byte {i}")
        version, rates = _VERSIONS[(b[1] >> 3) & 3]
        lsf = version != "1"
        index = b[2] >> 4
        sr = rates[(b[2] >> 2) & 3]
        if index == 0:
            if free_kbps is None:
                raise ValueError(f"free-format frame at byte {i} and no free_kbps")
            kbps = free_kbps
        else:
            kbps = (_BITRATES_V2 if lsf else _BITRATES_V1)[index]
        padding = (b[2] >> 1) & 1
        size = ((72 if lsf else 144) * kbps * 1000) // sr + padding
        frames.append(dict(offset=i, size=size, version=version, bitrate_index=index,
                           bitrate_kbps=kbps, sample_rate=sr, padding=padding,
                           mode=b[3] >> 6, mode_extension=(b[3] >> 4) & 3,
                           samples=576 if lsf else 1152))
        i += size
    if i != len(data):
        raise ValueError(f"trailing bytes: walked {i} of {len(data)}")
    return frames


class AssemblerRender:
    """The reference of `BatchEncoder.drain`'s native render: each row's
    frames through its own `FrameAssembler`, a frame at a time, from the
    chunk program's packed output (`fetch_outputs`,
    `frame_results_from_outputs`). The assemblers live across drains;
    `reset_lanes` gives the masked rows new ones, as the encoder's does."""

    def __init__(self, options, rows: int):
        from swiftmp3_tpu_torch.io.framing import FrameAssembler

        self.options = options
        self._new = lambda: FrameAssembler(options)
        self.renderers = [self._new() for _ in range(rows)]

    def reset_lanes(self, lanes) -> None:
        for b in np.flatnonzero(lanes).tolist():
            self.renderers[b] = self._new()

    def drain(self, outs: dict, valid: np.ndarray) -> list[bytes]:
        """One chunk's bytes a row; `outs` is what `BatchEncoder.step`
        returns (on the CPU)."""
        from swiftmp3_tpu_torch.models.pipeline import fetch_outputs, frame_results_from_outputs

        parts = outs["parts"] if "parts" in outs else [outs]
        packed = np.concatenate([np.asarray(p["packed"]) for p in parts])
        fields = fetch_outputs({"packed": packed}, self.options)
        out = [bytearray() for _ in self.renderers]
        for t in range(valid.shape[1]):
            for b, r in enumerate(self.renderers):
                if valid[b, t]:
                    out[b] += r.push(frame_results_from_outputs(fields, self.options, t, b))
        return [bytes(x) for x in out]

    def flush(self) -> list[bytes]:
        return [r.flush_buffered() for r in self.renderers]

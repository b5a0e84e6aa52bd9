"""The compat chunk program in PyTorch: chunk-parallel DSP + a small integer
loop over T. Twin of the `strict_entropy=False` branch of
`swiftmp3_tpu.models.pipeline.make_chunk_fn`.

Per chunk of T frames x B streams:

  Phase 1 (parallel): ingest, stereo decision, polyphase filterbank,
    transient detection, MDCT, initial gains and the 20-candidate rate
    sweep (kernel K1).
  Phase 2 (loop over T, integers only): bitrate, padding, reservoir budget,
    candidate selection and the reservoir mirror. Invalid frames freeze the
    carry.
  Phase 3 (parallel): re-quantize at the selected gains, regions, preflag,
    table-15 chunks, the main_data pack (kernel K2) and the packed output.

The carry and the packed output have the JAX program's names, shapes, dtypes
and byte layout, so `fetch_outputs` reads both and checkpoints cross between
the two backends (`carry_from_jax`, `carry_to_jax`). `valid[b, t]` must be a
prefix in t per stream; the carry-out is taken at each stream's last valid
frame.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from swiftmp3_tpu.io.framing import FrameResult
from swiftmp3_tpu.io.sideinfo import GranuleInfo
from swiftmp3_tpu.options import MP3EncoderOptions, Mode
from swiftmp3_tpu.tables import bitrate_index, bitrate_value, mode_bits

from ..ops import dsp, kernels

MAX_FRAME_MAIN_BITS = 1152 * 15  # all pair slots at 15 bits

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


def check_supported(options: MP3EncoderOptions) -> None:
    """Raise NotImplementedError for any option outside this slice (the
    compat chunk program), naming the ROADMAP Queue 1 item that brings it."""
    o = options
    unsupported = [
        (o.window_sequencing, "window_sequencing", 8),
        (o.linbits_tables, "linbits_tables", 8),
        (o.demand_budget, "demand_budget", 8),
        (o.vbr_demand, "vbr_demand", 8),
        (o.lowpass_hz is not None, "lowpass_hz", 8),
        (o.adaptive_lowpass, "adaptive_lowpass", 8),
        (o.reservoir_depth > 1, "reservoir_depth > 1", 8),
        (o.distortion_control, "distortion_control", 9),
        (o.intensity_stereo, "intensity_stereo", 10),
        (bool(o.lsf), "LSF sample rates", 11),
        (o.free_format, "free_format", 11),
        (o.iso_short_blocks, "iso_short_blocks", 7),
        (o.spec_strict_entropy, "the strict entropy layout (count1_coding, "
         "region_table_select, real_scalefactors)", 7),
        (o.iso_ms_matrix, "iso_ms_matrix", 7),
        (o.iso_mode_ext, "iso_mode_ext", 7),
        (o.ms_symmetric, "ms_symmetric", 7),
        (o.shared_ms_blocks, "shared_ms_blocks", 7),
    ]
    for active, name, item in unsupported:
        if active:
            raise NotImplementedError(
                f"{name} is not in the PyTorch port yet (ROADMAP Queue 1 "
                f"item {item}); this slice covers the compat chunk program"
            )


def init_carry(
    batch: int, options: MP3EncoderOptions, device: torch.device
) -> dict:
    """Fresh per-stream state (pipeline.py:80-115, compat keys)."""
    ch, k = options.channels, options.reservoir_depth
    return {
        name: torch.zeros((batch, *shape(ch, k)), dtype=dtype, device=device)
        for name, (shape, dtype) in _CARRY_SPEC.items()
    }


def main_data_cap(options: MP3EncoderOptions) -> int:
    """Static per-frame cap (bytes) of the packed main_data image
    (pipeline.py:118-149, MPEG-1): the frame's largest slot plus the
    reservoir reach, bounded by 1152 pair slots x 15 bits; even."""
    sr = options.sample_rate
    if options.vbr:
        max_kbps = min(320, options.bitrate_kbps + 64 - options.quality * 4)
    else:
        max_kbps = options.bitrate_kbps
    br_val = bitrate_value(bitrate_index(max_kbps, sr))
    side = 17 if options.channels == 1 else 32
    crc = 2 if options.crc_protected else 0
    slot_max = (144 * br_val * 1000) // sr + 1 - 4 - crc - side
    cap = min(MAX_FRAME_MAIN_BITS // 8, slot_max + options.reservoir_cap + 1)
    return cap + (cap & 1)


def make_chunk_fn(options: MP3EncoderOptions):
    """Build the chunk encode function
    (carry, pcm [B,T,1152*ch], final [B,T], valid [B,T]) -> (carry, outputs).

    All tensors lie on one device, the carry's. pcm is float32 or int16
    (normalized by 1/32768). outputs = {"packed": [B, T, cap + 4*M] uint8}:
    each frame's main_data image followed by its int32 side-info words,
    little-endian (the layout `fetch_outputs` reads)."""
    check_supported(options)
    sr = options.sample_rate
    ch = options.channels
    n_gr = options.n_granules
    spf = options.samples_per_frame
    res_cap = options.reservoir_cap
    n_gran = n_gr * ch
    side_size = 17 if ch == 1 else 32
    crc_size = 2 if options.crc_protected else 0
    is_vbr = options.vbr
    base_kbps = options.bitrate_kbps
    quality = options.quality
    cbr_index = bitrate_index(base_kbps, sr)
    cbr_value = bitrate_value(cbr_index)
    slots_per_kbps = 144
    cap_bytes = main_data_cap(options)
    aligned = options.reservoir_mode == "aligned"
    iso_quant = options.iso_quantization
    joint = options.mode is Mode.JOINT_STEREO
    mode_ext = mode_bits(options.mode.value)[1]
    i32 = torch.int32

    def run(carry, pcm, final, valid):
        pcm = dsp.ingest(pcm)
        B, T = pcm.shape[0], pcm.shape[1]
        dev = pcm.device

        # ---------------- Phase 1: parallel DSP (batch-major) ----------------
        pcm_bt = pcm.reshape(B, T * pcm.shape[-1])
        if ch == 1:
            pcm_chunk = pcm_bt[:, None, :]
        else:
            left = pcm_bt[:, 0::2].reshape(B, T, spf)
            right = pcm_bt[:, 1::2].reshape(B, T, spf)
            if joint:
                _, c0, c1 = dsp.stereo_decide(left, right)
            else:
                c0, c1 = left, right
            pcm_chunk = torch.stack([c0, c1], dim=1).reshape(B, ch, T * spf)
        granule_pcm = pcm_chunk.reshape(B, ch, T, n_gr, 576)

        S, full_x = dsp.polyphase_chunk_matmul(carry["fb_hist"], pcm_chunk)
        block_b, sb_gain_b = dsp.transient_frame(granule_pcm)  # [B,ch,T,gr], [..,3]
        if iso_quant:
            # the unit-gain law emits no per-window gains (pipeline.py:412-417)
            sb_gain_b = torch.zeros_like(sb_gain_b)
        spectra, cur = dsp.mdct_chunk(
            S, carry["overlap"], block_b.reshape(B, ch, n_gr * T)
        )
        spectra = spectra.reshape(B, ch, T, n_gr, 576)
        g0 = dsp.initial_gain(spectra, iso=iso_quant)
        pre = dsp.rate_loop_precompute(spectra, g0, iso=iso_quant)

        def tm(x):  # [B, ch, T, gr, ...] -> [T, B, G, ...], G = gr*ch + c
            rest = tuple(range(4, x.dim()))
            return x.permute(2, 0, 3, 1, *rest).reshape(T, B, n_gran, *x.shape[4:])

        def bm(x):  # inverse of tm
            y = x.reshape(T, B, n_gr, ch, *x.shape[3:])
            return y.permute(1, 3, 0, 2, *range(4, y.dim()))

        if is_vbr:
            frame_e = dsp.mean_square(pcm).transpose(0, 1)  # [T, B]
        granule_e = tm(dsp.mean_square(granule_pcm))  # [T, B, G]
        final_t = final.transpose(0, 1)
        valid_t = valid.transpose(0, 1)
        bits_t = tm(pre["bits"])
        evaluated_t = tm(pre["evaluated"])
        k_budget_t = tm(pre["k_budget"])

        # ---------------- Phase 2: integer loop over T ----------------
        c = {
            k: carry[k]
            for k in ("stream_len", "avail", "pad_rem", "slot_fifo", "vbr_ehist", "vbr_count")
        }
        if not is_vbr:
            br_idx_c = torch.full((B,), cbr_index, dtype=i32, device=dev)
            br_val_c = torch.full((B,), cbr_value, dtype=i32, device=dev)
        ys = []
        for t in range(T):
            fin = final_t[t]
            val = valid_t[t]
            if is_vbr:
                target = dsp.vbr_choose_bitrate(
                    frame_e[t], c["vbr_ehist"], c["vbr_count"], base_kbps, quality
                )
                br_idx = dsp.bitrate_index_device(target, sr)
                br_val = dsp.bitrate_value_device(br_idx)
            else:
                br_idx, br_val = br_idx_c, br_val_c

            numerator = slots_per_kbps * br_val * 1000
            base_size = numerator // sr
            pad_acc = c["pad_rem"] + numerator % sr
            padding = (pad_acc >= sr).to(i32)
            pad_rem = pad_acc - padding * sr
            slot = base_size + padding - 4 - crc_size - side_size

            sum_fifo = torch.sum(c["slot_fifo"], dim=1, dtype=i32)
            oldest = c["slot_fifo"][:, 0]
            res_bits = torch.where(fin, 0, c["avail"] * 8)
            usable = (res_bits * 9) // 10
            if aligned:
                gap_b = sum_fifo - c["stream_len"]
                usable = torch.minimum(usable, torch.clamp(gap_b, 0, res_cap) * 8)
            bits_per_granule = (slot * 8 + usable) // n_gran

            k_sel, has_fit, bits_sel = dsp.rate_loop_select(
                bits_t[t], evaluated_t[t], k_budget_t[t], bits_per_granule[:, None]
            )
            huffman_bytes = (torch.sum(bits_sel, dim=-1, dtype=i32) + 7) // 8
            if aligned:
                gap = sum_fifo - c["stream_len"]
                mdb = torch.clamp(torch.minimum(gap, huffman_bytes), 0, res_cap)
                stream_len = torch.clamp(
                    c["stream_len"] + (gap - mdb) + huffman_bytes - oldest, min=0
                )
            else:
                mdb = torch.where(fin, 0, torch.clamp(c["stream_len"], max=res_cap))
                stream_len = torch.clamp(
                    c["stream_len"] + huffman_bytes - oldest, min=0
                )
            new_c = {
                "stream_len": stream_len,
                "avail": torch.clamp(c["avail"] + slot - huffman_bytes, 0, res_cap),
                "pad_rem": pad_rem,
                "slot_fifo": torch.cat([c["slot_fifo"][:, 1:], slot[:, None]], dim=1),
                "vbr_ehist": torch.cat([c["vbr_ehist"][:, n_gran:], granule_e[t]], dim=1),
                "vbr_count": torch.clamp(c["vbr_count"] + n_gran, max=10),
            }
            c = {
                k: torch.where(val.reshape((B,) + (1,) * (v.dim() - 1)), v, c[k])
                for k, v in new_c.items()
            }
            ys.append((br_idx, padding, mdb, slot, k_sel, has_fit, bits_sel))
        br_idx, padding, mdb, slot, k_sel, has_fit, bits_sel = (
            torch.stack(y) for y in zip(*ys)
        )

        # ---------------- Phase 3: parallel finalize (batch-major) --------
        gain_b, quantized, big_values_b = dsp.rate_loop_finalize(
            pre, bm(k_sel), bm(has_fit)
        )
        region0_b, region1_b = dsp.region_counts(big_values_b, sr)
        if iso_quant:
            pref_b = torch.zeros_like(big_values_b)  # no pre-emphasis applied
        else:
            pref_b = dsp.preflag(spectra)
        chunks, nb = dsp.pair_chunks_device(quantized, big_values_b)

        def frame_major(x):  # [B, ch, T, gr, W] -> [B*T, n_gran*W], (gr, ch) order
            return x.permute(0, 2, 3, 1, 4).reshape(B * T, n_gran * x.shape[-1])

        main_data, _ = kernels.pack(
            frame_major(chunks).contiguous(), frame_major(nb).contiguous(), cap_bytes
        )
        main_data = main_data.reshape(B, T, cap_bytes)

        zeros_g = torch.zeros((T, B, n_gran), dtype=i32, device=dev)
        meta = torch.cat(
            [
                br_idx[..., None],
                padding[..., None],
                mdb[..., None],
                slot[..., None],
                bits_sel,  # part2_3_length
                tm(big_values_b),
                tm(gain_b),
                tm(block_b),
                tm(pref_b),
                tm(region0_b),
                tm(region1_b),
                tm(sb_gain_b).reshape(T, B, 3 * n_gran),
                torch.full((T, B, 3 * n_gran), 15, dtype=i32, device=dev),  # table_select
                zeros_g,  # count1table
                zeros_g,  # scalefac_compress
                torch.zeros((T, B, ch), dtype=i32, device=dev),  # scfsi
                torch.full((T, B, 1), mode_ext, dtype=i32, device=dev),
            ],
            dim=-1,
        ).to(i32)
        meta_bytes = meta.transpose(0, 1).contiguous().view(torch.uint8).reshape(B, T, -1)
        outputs = {"packed": torch.cat([main_data, meta_bytes], dim=-1)}

        # ---------------- Carry-out at each stream's last valid frame -------
        count_valid = torch.sum(valid, dim=1)  # [B] int64
        # trailing-480 slab of frame t starts at full_x[spf * t]
        idx = (count_valid * spf)[:, None, None] + torch.arange(480, device=dev)
        fb_hist = torch.gather(full_x, 2, idx.expand(B, ch, 480))
        all_ov = torch.cat([carry["overlap"][:, :, None, :], cur], dim=2)
        gi = (n_gr * count_valid)[:, None, None, None].expand(B, ch, 1, 576)
        overlap = torch.gather(all_ov, 2, gi)[:, :, 0]

        new_carry = dict(c)
        new_carry["est_stream_len"] = carry["est_stream_len"]
        new_carry["fb_hist"] = fb_hist
        new_carry["overlap"] = overlap
        return new_carry, outputs

    return run


# --- Host side of the output contract (numpy only) ------------------------------

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


def fetch_outputs(outs, options: MP3EncoderOptions) -> dict:
    """Unpack the packed chunk output to named host arrays, all batch-major
    [B, T, ...] (twin of pipeline.py:1206-1240)."""
    n_gran = options.n_granules * options.channels
    packed = _host_array(outs["packed"])
    cap = main_data_cap(options)
    main_data = packed[..., :cap]
    meta = packed[..., cap:].copy().view(np.int32)
    B, T = meta.shape[0], meta.shape[1]
    d = {
        "bitrate_index": meta[..., 0],
        "padding": meta[..., 1],
        "mdb": meta[..., 2],
        "slot": meta[..., 3],
        "main_data": main_data,
    }
    o = 4
    for name in _GRANULE_FIELDS:
        d[name] = meta[..., o : o + n_gran]
        o += n_gran
    d["subblock_gain"] = meta[..., o : o + 3 * n_gran].reshape(B, T, n_gran, 3)
    o += 3 * n_gran
    d["table_select"] = meta[..., o : o + 3 * n_gran].reshape(B, T, n_gran, 3)
    o += 3 * n_gran
    d["count1table"] = meta[..., o : o + n_gran]
    o += n_gran
    d["scalefac_compress"] = meta[..., o : o + n_gran]
    o += n_gran
    d["scfsi"] = meta[..., o : o + options.channels]
    o += options.channels
    d["mode_ext"] = meta[..., o]
    d["hb"] = (d["part23"].sum(axis=-1) + 7) // 8
    return d


def frame_results_from_outputs(
    outs: dict, options: MP3EncoderOptions, t: int, b: int
) -> FrameResult:
    """One (stream, time) slice of fetched outputs as a FrameResult for the
    host assembler (twin of pipeline.py:1243-1308, compat block types)."""
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
            block_type=block,
            mixed_block_flag=1 if block == dsp.BLOCK_MIXED else 0,
            table_select=tuple(int(x) for x in outs["table_select"][b, t, g]),
            subblock_gain=tuple(int(x) for x in outs["subblock_gain"][b, t, g]),
            region0_count=int(outs["region0"][b, t, g]),
            region1_count=int(outs["region1"][b, t, g]),
            preflag=int(outs["preflag"][b, t, g]),
            scalefac_scale=0,
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


def carry_from_jax(state: dict, device: torch.device) -> dict:
    """The port's carry from a JAX checkpoint (`TPUBackend.state_dict()` or a
    `BatchEncoder.carry` as numpy arrays). Pre-depth checkpoints
    (prev_slot / has_buffered) convert as the JAX backend converts them."""
    state = dict(state)
    if "slot_fifo" not in state and "prev_slot" in state:
        ps = np.asarray(state.pop("prev_slot"))
        hb = np.asarray(state.pop("has_buffered"))
        fifo = np.zeros((ps.shape[0], 1), dtype=np.int32)
        fifo[:, -1] = np.where(hb, ps, 0)
        state["slot_fifo"] = fifo
    extra = sorted(set(state) - set(_CARRY_SPEC))
    if extra:
        raise NotImplementedError(
            f"carry keys {extra} belong to options outside the compat slice "
            "(window_sequencing: ROADMAP Queue 1 item 8)"
        )
    carry = {}
    for name, (_, dtype) in _CARRY_SPEC.items():
        arr = np.array(state[name])  # a writable copy for torch
        carry[name] = torch.from_numpy(arr).to(device=device, dtype=dtype)
    return carry


def carry_to_jax(carry: dict) -> dict:
    """The port's carry as the numpy arrays a JAX backend loads."""
    return {k: v.detach().cpu().numpy() for k, v in carry.items()}


class TorchBackend:
    """Single-stream session backend on `device`: fixed-size chunks of
    frames, partial chunks padded with valid=False lanes (twin of
    pipeline.TPUBackend)."""

    CHUNK = 8

    def __init__(self, options: MP3EncoderOptions, device):
        self.options = options
        self.device = torch.device(device)
        self._run = make_chunk_fn(options)
        self.carry = init_carry(1, options, self.device)

    def encode_frames(
        self, frames: np.ndarray, is_final: np.ndarray, lookahead: np.ndarray = None
    ) -> List[FrameResult]:
        if lookahead is not None:
            raise NotImplementedError(
                "lookahead frames belong to window_sequencing (ROADMAP Queue 1 item 8)"
            )
        n = self.options.samples_per_frame * self.options.channels
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
            self.carry, outs = self._run(
                self.carry,
                torch.from_numpy(pcm).to(self.device),
                torch.from_numpy(fin).to(self.device),
                torch.from_numpy(val).to(self.device),
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
        self.carry = carry_from_jax(state, self.device)

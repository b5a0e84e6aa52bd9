"""Entry points of the port: one small chunk program, and the batched
step over an n-position data mesh (twin of the reference's
`__graft_entry__.py`).

    python -m swiftmp3_tpu_torch.graft_entry [--device cpu]

runs `entry()`, one call of its function, then `dryrun_multichip(8)`: on the
card by default, on the CPU with `--device cpu`.

MP3 encoding has no tensor, pipeline or expert dimension: each stream's
state (filterbank history, MDCT overlap, bit reservoir, VBR history) is a
strict serial chain, so the stream batch is the one axis that scales without
communication. The mesh cuts the batch into one contiguous span a position;
no collective runs in the numeric path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .models.pipeline import (
    fetch_outputs,
    init_carry,
    main_data_cap,
    make_chunk_fn,
    resolve_device,
)
from .options import SAMPLES_PER_GRANULE, MP3EncoderOptions, Mode
from .parallel.mesh import carry_sharding, make_mesh, process_batch_bounds, put_global


def entry(device="cuda"):
    """(fn, example_args): the chunk program of 128 kbps CBR stereo and one
    chunk of 8 streams x 4 frames on `device` (the card by default; raises
    without one). pcm is drawn as the reference entry draws it, so both see
    the same bytes. The reference also turns on JAX's compilation cache;
    the port compiles nothing ahead of a call, so there is none."""
    dev = resolve_device(device)
    options = MP3EncoderOptions(mode=Mode.STEREO, bitrate_kbps=128)
    fn = make_chunk_fn(options)
    T, B = 4, 8
    n = 1152 * options.channels
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal((B, T, n)) * 0.3).astype(np.float32)
    example_args = (
        init_carry(B, options, dev),
        torch.from_numpy(pcm).to(dev),
        torch.zeros((B, T), dtype=torch.bool, device=dev),
        torch.ones((B, T), dtype=torch.bool, device=dev),
    )
    return fn, example_args


def dryrun_inputs(batch: int, frames: int) -> dict:
    """The dry run's two steps, {name: (options, pcm, lookahead or None)},
    drawn from default_rng(1) in the reference's order
    (__graft_entry__.py:149-154, :183-189): compat joint stereo VBR at
    quality 3 on pcm x 0.4, then the hq joint-stereo preset on bursty
    content (x 0.1, samples 400:900 x 8) with each frame's lookahead granule
    (the next frame's first 576 x ch samples; silence after the last)."""
    vbr = MP3EncoderOptions(mode=Mode.JOINT_STEREO, vbr=True, quality=3)
    hq = MP3EncoderOptions.hq(mode=Mode.JOINT_STEREO)
    n = 1152 * vbr.channels
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal((batch, frames, n)) * 0.4).astype(np.float32)
    pcm_s = (rng.standard_normal((batch, frames, n)) * 0.1).astype(np.float32)
    pcm_s[:, :, 400:900] *= 8.0
    la_n = SAMPLES_PER_GRANULE * hq.channels
    la_s = np.zeros((batch, frames, la_n), dtype=np.float32)
    la_s[:, :-1] = pcm_s[:, 1:, :la_n]
    return {"vbr": (vbr, pcm, None), "hq": (hq, pcm_s, la_s)}


def _positions(n_devices: int, device) -> list:
    """The mesh's devices: round-robin over the cards present (device None
    or "cuda"), else n_devices positions on `device`."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "dryrun_multichip needs a CUDA card; pass device='cpu' for CPU positions"
            )
        count = torch.cuda.device_count()
        return [f"cuda:{i % count}" for i in range(n_devices)]
    return [resolve_device(device)] * n_devices


def _mesh_step(mesh, options, pcm, lookahead) -> tuple:
    """One chunk of a fresh batch over the mesh: this process's rows
    (process_batch_bounds) split over its positions (put_global), each
    position running the chunk program on its rows with its carry on its
    device, as BatchEncoder does under a mesh. Returns (fetched outputs,
    new carry as numpy), both in global row order."""
    B, T = pcm.shape[:2]
    lo, hi = process_batch_bounds(mesh, B)
    spans = carry_sharding(mesh).spans(hi - lo)
    final = np.zeros((hi - lo, T), dtype=bool)
    valid = np.ones((hi - lo, T), dtype=bool)
    x, f, v = (put_global(mesh, a) for a in (pcm[lo:hi], final, valid))
    la = put_global(mesh, lookahead[lo:hi]) if lookahead is not None else [None] * len(spans)
    run = make_chunk_fn(options)
    carries, packed = [], []
    for k, (dev, a, b) in enumerate(spans):
        carry, outs = run(init_carry(b - a, options, dev), x[k], f[k], v[k], la[k])
        carries.append(carry)
        packed.append(outs["packed"])
    outputs = fetch_outputs({"packed": np.concatenate([p.cpu().numpy() for p in packed])}, options)
    carry = {k: np.concatenate([c[k].cpu().numpy() for c in carries]) for k in carries[0]}
    return outputs, carry


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None, batch: int | None = None, frames: int = 2) -> dict:
    """Run the batched encode step over an n_devices-position mesh: one
    chunk of compat joint-stereo VBR (quality 3), then one of the hq
    joint-stereo preset with its lookahead, on fresh carries.

    The positions lie on the card by default, round-robin over the cards
    present (on a one-card host, n positions on cuda:0); device="cpu" gives
    n CPU positions. Without a card, and not asked for the CPU, it raises:
    unlike the reference, it does not re-execute itself on virtual CPU
    devices, which on the card would be a fallback that hides the device.

    batch defaults to 2 x n_devices streams (two a position) and frames to
    2, the reference's shapes; the inputs are `dryrun_inputs(batch,
    frames)`. Checks, each raising: main_data [B, T, main_data_cap],
    part23 >= 0, hb within the cap, gains in [0, 255], and every stream's
    newest slot-fifo entry set after the VBR step; part23 and hb after the
    hq step. Prints the reference's line and, unlike the reference, which
    returns None, returns {step: (fetched outputs, new carry)} for "vbr"
    and "hq", as numpy in global row order."""
    mesh = make_mesh(_positions(n_devices, device))
    B = 2 * n_devices if batch is None else batch
    result = {}
    for name, (options, pcm, la) in dryrun_inputs(B, frames).items():
        outputs, carry = _mesh_step(mesh, options, pcm, la)
        md = outputs["main_data"]
        if name == "vbr":
            cap = main_data_cap(options)
            _check(md.shape == (B, frames, cap), f"main_data {md.shape}, want {(B, frames, cap)}")
            _check(bool(np.all((outputs["gain"] >= 0) & (outputs["gain"] <= 255))),
                   "a global gain outside [0, 255]")
            _check(bool(np.all(carry["slot_fifo"][:, -1] > 0)), "a stream's slot fifo did not advance")
        _check(bool(np.all(outputs["part23"] >= 0)), f"{name}: a negative part2_3_length")
        _check(bool(np.all(outputs["hb"] <= md.shape[-1])), f"{name}: main_data past the cap")
        result[name] = (outputs, carry)
    print(f"dryrun_multichip ok: {n_devices} devices, batch {B}, mesh {mesh.shape}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m swiftmp3_tpu_torch.graft_entry",
        description="entry(), one call of its chunk program, then dryrun_multichip(8)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    fn, example_args = entry(args.device)
    _, outs = fn(*example_args)
    if outs["packed"].device.type == "cuda":
        torch.cuda.synchronize()
    print("entry ok")
    dryrun_multichip(8, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The hand-written CUDA kernels of the compat path, their wrappers and their
plain PyTorch versions.

    rate_sweep  <- swiftmp3_tpu/ops/pallas_kernels.py:rate_sweep_pallas (K1)
    pack        <- swiftmp3_tpu/ops/pallas_kernels.py:pack_pallas       (K2)

Dispatch is by the device of the input tensor, with no fallback: a CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises
(a failed build, a refused launch and a nonzero `cudaGetLastError()` all
raise). Each wrapper adds one to `LAUNCHES[name]` where it launches its
kernel, and nowhere else.

Build: `nvcc` (sm_90a) compiles each `csrc/*.cu` into a shared library with
a plain C interface under `swiftmp3_tpu_torch/_build/` at the first CUDA
call (or `build_kernels()`), all sources in parallel; the libraries are
loaded with ctypes. Nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

N_GAIN_CANDIDATES = 20  # the reference's maxIterations
_PAIRS = 288

LAUNCHES = {"rate_sweep": 0, "pack": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = {"rate_sweep": "rate_sweep.cu", "pack": "pack.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction: the quantizer rounds mag*inv, then +0.5, then floors
    "--fmad=false",
]

_vp = ctypes.c_void_p
_SIGNATURES = {
    # (mag, gstart, inv_table, len_table, bits, bv, n, stream)
    "rate_sweep": [_vp, _vp, _vp, _vp, _vp, _vp, ctypes.c_longlong, _vp],
    # (chunks, nbits, out, total_bits, F, P, cap, stream)
    "pack": [_vp, _vp, _vp, _vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, _vp],
}

_build_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels build from swiftmp3_tpu_torch/ops/csrc at first CUDA use"
        )
    return found


def build_kernels() -> dict[str, ctypes.CDLL]:
    """Compile (if stale) and load every kernel library; raises on any
    failed build. Returns {name: ctypes library}."""
    with _build_lock:
        if _libs:
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in SOURCES.items():
            src_path = os.path.join(CSRC_DIR, src)
            so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
            if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src_path):
                continue
            tmp = os.path.join(BUILD_DIR, f"lib{name}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                so_path,
            )
        failures = []
        for name, (proc, tmp, so_path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so_path)
        if failures:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
        libs = {}
        for name in SOURCES:
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            fn = getattr(lib, f"swm_{name}")
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            lib.swm_error_string.argtypes = [ctypes.c_int]
            lib.swm_error_string.restype = ctypes.c_char_p
            libs[name] = lib
        _libs.update(libs)
        return _libs


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point of kernel `name` on the current stream of
    `device`; raise on a nonzero CUDA error code."""
    lib = build_kernels()[name]
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, f"swm_{name}")(*args, stream)
    if err != 0:
        msg = lib.swm_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"kernel inputs must share one CUDA device, got {t.device} and {dev}"
            )


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# --- K1: the 20-gain table-15 rate sweep ----------------------------------------


def _sweep_tables(iso: bool, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    from .dsp import constant, inv_step_table

    return inv_step_table(iso, device), constant("t15_len", device)


def rate_sweep_plain(
    mag: torch.Tensor, gstart: torch.Tensor, iso: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 (dsp.py:865-870): quantize at the 20 gains, look
    up the table-15 pair lengths, sum the pairs below big_values.
    Materializes [..., 20, 576]; callers slice large inputs."""
    inv_table, len_table = _sweep_tables(iso, mag.device)
    k = torch.arange(N_GAIN_CANDIDATES, dtype=torch.int32, device=mag.device)
    gains = torch.clamp(gstart[..., None] + 4 * k, 0, 255)
    inv = inv_table[gains.long()]
    q = torch.clamp(torch.floor(mag[..., None, :] * inv[..., None] + 0.5), max=15.0)
    q = q.to(torch.int32)
    x = q[..., 0::2]
    y = q[..., 1::2]
    pair_bits = len_table[(x * 16 + y).long()] + (x != 0).to(torch.int32) + (
        y != 0
    ).to(torch.int32)
    pos = torch.arange(1, _PAIRS + 1, dtype=torch.int32, device=mag.device)
    bv = torch.amax(torch.where((x != 0) | (y != 0), pos, 0), dim=-1)
    bits = torch.sum(torch.where(pos <= bv[..., None], pair_bits, 0), dim=-1)
    return bits.to(torch.int32), bv.to(torch.int32)


def rate_sweep(
    mag: torch.Tensor, gstart: torch.Tensor, iso: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate (bits, bv) for the 20-gain walk grid: gains
    min(gstart + 4k, 255), q = min(floor(mag*inv + 0.5), 15), table-15 pair
    lengths plus sign bits summed below big_values.

    mag: [..., 576] float32 (|x|^0.75); gstart: [...] int32. Returns
    (bits [..., 20], bv [..., 20]) int32. iso selects the step^-0.75 law."""
    if _on_cpu(mag):
        return rate_sweep_plain(mag, gstart, iso)
    _require_cuda(mag, gstart)
    lead = tuple(gstart.shape)
    _require(mag, "mag", torch.float32, lead + (576,))
    _require(gstart, "gstart", torch.int32, lead)
    if mag.data_ptr() % 8:
        raise ValueError("mag: the kernel reads pairs as float2 (8-byte aligned)")
    n = gstart.numel()
    bits = torch.empty(lead + (N_GAIN_CANDIDATES,), dtype=torch.int32, device=mag.device)
    bv = torch.empty_like(bits)
    if n == 0:
        return bits, bv
    inv_table, len_table = _sweep_tables(iso, mag.device)
    _launch(
        "rate_sweep", mag.device,
        mag.data_ptr(), gstart.data_ptr(), inv_table.data_ptr(),
        len_table.data_ptr(), bits.data_ptr(), bv.data_ptr(), n,
    )
    LAUNCHES["rate_sweep"] += 1
    return bits, bv


# --- K2: the main_data pack --------------------------------------------------


def pack_plain(
    chunks: torch.Tensor, nbits: torch.Tensor, cap_bytes: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: exclusive cumsum of nbits gives each slot's bit
    offset O; each chunk's <=24-bit window lands in bytes O>>3 .. +2; bits
    are disjoint, so a three-plane scatter_add equals the OR. Bytes at or
    past cap_bytes are dropped."""
    nb = nbits.to(torch.int64)
    c = chunks.to(torch.int64)
    off = torch.cumsum(nb, dim=-1) - nb
    total = torch.sum(nb, dim=-1).to(torch.int32)
    pos = nb > 0
    shift = torch.where(pos, 24 - (off & 7) - nb, 0)
    win = torch.where(pos, c << shift, 0)
    b = off >> 3
    img = torch.zeros(
        (chunks.shape[0], cap_bytes + 3), dtype=torch.int64, device=chunks.device
    )
    for k, sh in ((0, 16), (1, 8), (2, 0)):
        # targets past the cap collect in the slack, which is sliced off
        tgt = torch.clamp(b + k, max=cap_bytes + 2)
        img.scatter_add_(1, tgt, (win >> sh) & 0xFF)
    return img[:, :cap_bytes].to(torch.uint8), total


def pack(
    chunks: torch.Tensor, nbits: torch.Tensor, cap_bytes: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack each frame's variable-length chunks into its main_data image.

    chunks/nbits: [F, P] int32 (codes of <= 15 bits and their lengths, in
    write order). Returns (bytes [F, cap_bytes] uint8, total_bits [F] int32);
    frames longer than cap_bytes are truncated (callers check hb <= cap)."""
    if _on_cpu(chunks):
        return pack_plain(chunks, nbits, cap_bytes)
    _require_cuda(chunks, nbits)
    if chunks.dim() != 2:
        raise ValueError(f"chunks: expected [F, P], got {tuple(chunks.shape)}")
    F, P = chunks.shape
    _require(chunks, "chunks", torch.int32, (F, P))
    _require(nbits, "nbits", torch.int32, (F, P))
    if not 0 < cap_bytes <= 16384:
        raise ValueError(f"cap_bytes {cap_bytes} outside the kernel's 1..16384")
    out = torch.empty((F, cap_bytes), dtype=torch.uint8, device=chunks.device)
    total = torch.empty((F,), dtype=torch.int32, device=chunks.device)
    if F == 0:
        return out, total
    _launch(
        "pack", chunks.device,
        chunks.data_ptr(), nbits.data_ptr(), out.data_ptr(), total.data_ptr(),
        F, P, cap_bytes,
    )
    LAUNCHES["pack"] += 1
    return out, total

"""The hand-written CUDA kernels of the port, their wrappers and their plain
PyTorch versions: one for each Pallas kernel of the reference.

    rate_sweep  <- swiftmp3_tpu/ops/pallas_kernels.py:rate_sweep_pallas      (K1)
    pack        <- swiftmp3_tpu/ops/pallas_kernels.py:pack_pallas            (K2)
    polyphase   <- swiftmp3_tpu/ops/pallas_kernels.py:polyphase_chunk_pallas (K3)

Dispatch is by the device of the input tensor, with no fallback: a CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises
(a failed build, a refused launch and a nonzero `cudaGetLastError()` all
raise). Each wrapper adds one to `LAUNCHES[name]` where it launches its
kernel, and nowhere else.

All three are laid out for the H100's SM (each csrc/*.cu says how): K1
quantizes without a float-to-int conversion and prices a pair with one byte
lookup in `sweep_cost_table`; K2 is a persistent grid of warps
(`pack_plan`), each packing whole frames from a ring of slot tiles, the
nbits staged by TMA bulk copies and only the live slots' chunks by cp.async;
K3 register-tiles its cosine product and walks
`polyphase_plan`'s tiles with asynchronous staging. What the launches need
beyond pointers (the cost table, the grids, the dynamic shared-memory sizes)
is computed here, where the CPU tests reach it.

Build: `nvcc` (sm_90a) compiles each `csrc/*.cu` into a shared library with
a plain C interface under `swiftmp3_tpu_torch/_build/` at the first CUDA
call (or `build_kernels()`), all sources in parallel; the libraries are
loaded with ctypes. Nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import torch

N_GAIN_CANDIDATES = 20  # the reference's maxIterations
_PAIRS = 288

LAUNCHES = {"rate_sweep": 0, "pack": 0, "polyphase": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = {"rate_sweep": "rate_sweep.cu", "pack": "pack.cu", "polyphase": "polyphase.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
EXTRA_NVCC_FLAGS = {
    # no FMA contraction: K1's quantizer rounds mag*inv, then +0.5, then floors
    "rate_sweep": ["--fmad=false"],
}

_vp = ctypes.c_void_p
_SIGNATURES = {
    # (mag, gstart, inv_table, cost_table, bits, bv, n, stream)
    "rate_sweep": [_vp, _vp, _vp, _vp, _vp, _vp, ctypes.c_longlong, _vp],
    # (chunks, nbits, out, total_bits, F, P, cap, blocks, smem_bytes, stream)
    "pack": [_vp, _vp, _vp, _vp] + [ctypes.c_int] * 5 + [_vp],
    # (hist, pcm, wrev, mrev_t, S, n_rows, n_pcm, tiles_per_block, smem_bytes, stream)
    "polyphase": [_vp, _vp, _vp, _vp, _vp] + [ctypes.c_longlong] * 4 + [_vp],
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
            cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_NVCC_FLAGS.get(name, []), "-o", tmp, src_path]
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
    `device`, with `device` current around the call (the entry points
    launch, and opt their kernels in, on the device `cudaGetDevice` names,
    which must be the tensors' card and not whichever card the caller left
    current); raise on a nonzero CUDA error code."""
    lib = _libs.get(name) or build_kernels()[name]
    with torch.cuda.device(device):
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


@functools.lru_cache(maxsize=None)
def sweep_cost_table(device: torch.device) -> torch.Tensor:
    """The kernel's one lookup per pair: cost[16 qx + qy] = table-15 length
    + (qx != 0) + (qy != 0), the pair's code and sign bits, uint8 [256]
    (at most 15; made once per device)."""
    from .dsp import T15_LEN

    q = torch.arange(16)
    signs = (q != 0)[:, None].to(torch.int32) + (q != 0)[None, :].to(torch.int32)
    cost = torch.from_numpy(T15_LEN).to(torch.int32) + signs.reshape(256)
    return cost.to(torch.uint8).to(device)


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
    from .dsp import inv_step_table

    _launch(
        "rate_sweep", mag.device,
        mag.data_ptr(), gstart.data_ptr(), inv_step_table(iso, mag.device).data_ptr(),
        sweep_cost_table(mag.device).data_ptr(), bits.data_ptr(), bv.data_ptr(), n,
    )
    LAUNCHES["rate_sweep"] += 1
    return bits, bv


# --- K2: the main_data pack --------------------------------------------------

# The kernel's layout (csrc/pack.cu): warps a block, slots a staged tile,
# tiles in each warp's ring, and blocks an SM at most (32 warps at <= 64
# registers); a block's dynamic shared memory is, for each warp, its ring of
# nbits and chunks tiles, its frame image (ceil(cap / 4) + 1 words, rounded
# up to 4) and two mbarriers a stage.
K2_WARPS = 8
K2_TILE = 512
K2_STAGES = 3
K2_MAX_BLOCKS_PER_SM = 32 // K2_WARPS
SM_COUNT = 132  # H100 SXM
SM_SMEM_BYTES = 233472  # 228 KB of shared memory an SM
BLOCK_SMEM_BYTES = 232448  # at most 227 KB a block
BLOCK_SMEM_RESERVED = 1024  # the runtime's own share of each resident block
MAX_PACK_SLOTS = (2**31 - 1) // 15  # bit offsets are int32


def pack_smem_bytes(cap_bytes: int) -> int:
    image_words = -(-(-(-cap_bytes // 4) + 1) // 4) * 4
    return K2_WARPS * (4 * (K2_STAGES * 2 * K2_TILE + image_words) + 16 * K2_STAGES)


@functools.lru_cache(maxsize=256)
def pack_plan(F: int, P: int, cap_bytes: int) -> dict:
    """The kernel's launch plan for F frames of P slots into cap_bytes: as
    many blocks as fit on each SM (at most K2_MAX_BLOCKS_PER_SM, as the
    shared memory allows) times SM_COUNT, and no more than the frames need
    (one warp a frame); each warp walks frames w, w + warps, ... Made once
    for each shape. Raises ValueError for a cap outside 1..16384 or a frame
    whose bit offsets would pass int32."""
    if not 0 < cap_bytes <= 16384:
        raise ValueError(f"cap_bytes {cap_bytes} outside the kernel's 1..16384")
    if not 0 <= P <= MAX_PACK_SLOTS:
        raise ValueError(f"pack: {P} slots a frame pass the kernel's {MAX_PACK_SLOTS}")
    smem = pack_smem_bytes(cap_bytes)
    if smem > BLOCK_SMEM_BYTES:
        raise ValueError(f"pack: {smem} B of shared memory a block pass {BLOCK_SMEM_BYTES}")
    per_sm = min(K2_MAX_BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + BLOCK_SMEM_RESERVED))
    return {
        "blocks": min(-(-F // K2_WARPS), per_sm * SM_COUNT),
        "blocks_per_sm": per_sm,
        "tiles": max(1, -(-P // K2_TILE)),
        "smem_bytes": smem,
    }


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
    plan = pack_plan(F, P, cap_bytes)
    out = torch.empty((F, cap_bytes), dtype=torch.uint8, device=chunks.device)
    total = torch.empty((F,), dtype=torch.int32, device=chunks.device)
    if F == 0:
        return out, total
    _launch(
        "pack", chunks.device,
        chunks.data_ptr(), nbits.data_ptr(), out.data_ptr(), total.data_ptr(),
        F, P, cap_bytes, plan["blocks"], plan["smem_bytes"],
    )
    LAUNCHES["pack"] += 1
    return out, total


# --- K3: the polyphase analysis filterbank --------------------------------------

HIST = 480  # filterbank history samples carried between chunks
# The kernel's tiling (csrc/polyphase.cu): window positions per tile, and the
# dynamic shared memory of a block in bytes: the [64, 32] cosine matrix, a
# tile's 32 * tile + 480 samples, and its partial sums in rows of 64 + 4.
K3_TILE = 256
K3_SMEM_BYTES = 4 * (64 * 32 + 32 * K3_TILE + HIST + K3_TILE * (64 + 4))
K3_MAX_TILES_PER_BLOCK = 8
K3_BLOCKS_TO_FILL = 4 * 2 * 132  # four rounds of the two blocks each of 132 SMs holds
MAX_GRID_BLOCKS = 0x7FFFFFFF


def _polyphase_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    from .dsp import constant

    return constant("window_rev", device), constant("matrix_rev_t", device)


def polyphase_plan(n_rows: int, n_pcm: int) -> dict:
    """The kernel's launch plan for n_rows rows of n_pcm samples. A block
    walks `tiles_per_block` consecutive tiles of one row (the cosine matrix
    is loaded once a block, and a tile's samples arrive while the tile
    before it computes): as many as leave enough blocks to fill the card,
    at most K3_MAX_TILES_PER_BLOCK, spread evenly over the row's blocks.
    Raises ValueError when the grid would pass CUDA's limit."""
    tiles = -(-(n_pcm // 32) // K3_TILE)
    per_block = min(K3_MAX_TILES_PER_BLOCK, max(1, n_rows * tiles // K3_BLOCKS_TO_FILL))
    blocks_per_row = -(-tiles // per_block)
    per_block = -(-tiles // blocks_per_row)
    blocks = n_rows * blocks_per_row
    if blocks > MAX_GRID_BLOCKS:
        raise ValueError(f"polyphase: {blocks} blocks pass the grid limit {MAX_GRID_BLOCKS}")
    return {
        "tiles": tiles,
        "tiles_per_block": per_block,
        "blocks": blocks,
        "smem_bytes": K3_SMEM_BYTES,
    }


def polyphase_chunk_plain(
    hist: torch.Tensor, pcm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: the stepwise filterbank (dsp.py:259-281). With A
    the signal in 32-sample rows and Y[u] = (A[u], A[u+1]), the 64-phase
    partial sums are 8 shifted multiply-adds on Y with the reversed window,
    then one [64, 32] fp32 product with the reversed cosine matrix. Takes any
    leading shape and any T. Returns (S [..., 36T, 32], x = hist | pcm)."""
    wrev, mrev_t = _polyphase_tables(hist.device)
    w8 = wrev.reshape(8, 64)
    x = torch.cat([hist, pcm], dim=-1)
    n_steps = x.shape[-1] // 32  # 15 + 36T
    T36 = n_steps - 15
    A = x.reshape(*x.shape[:-1], n_steps, 32)
    Y = torch.cat([A[..., :-1, :], A[..., 1:, :]], dim=-1)  # [..., n_steps - 1, 64]
    partial = None
    for m in range(8):
        term = Y[..., 2 * m : 2 * m + T36, :] * w8[m]
        partial = term if partial is None else partial + term
    return torch.matmul(partial, mrev_t), x


def polyphase_subbands(hist: torch.Tensor, pcm: torch.Tensor) -> torch.Tensor:
    """K3 alone: the subband samples S [..., n/32, 32] of hist | pcm, without
    the concatenated signal. hist: [..., 480]; pcm: [..., n] float32 with n
    a whole number of frames (a multiple of 576: 1152 samples at MPEG-1, 576
    at LSF). A CPU tensor takes the plain version."""
    if _on_cpu(hist):
        return polyphase_chunk_plain(hist, pcm)[0]
    _require_cuda(hist, pcm)
    lead = tuple(hist.shape[:-1])
    n_pcm = pcm.shape[-1]
    _require(hist, "hist", torch.float32, lead + (HIST,))
    _require(pcm, "pcm", torch.float32, lead + (n_pcm,))
    if n_pcm % 576:
        raise ValueError(f"pcm: {n_pcm} samples is not a whole number of frames (576)")
    if hist.data_ptr() % 16 or pcm.data_ptr() % 16:
        raise ValueError("hist, pcm: the kernel reads float4 (16-byte aligned)")
    n = 1
    for d in lead:
        n *= d
    S = torch.empty(lead + (n_pcm // 32, 32), dtype=torch.float32, device=hist.device)
    if n == 0 or n_pcm == 0:
        return S
    plan = polyphase_plan(n, n_pcm)
    wrev, mrev_t = _polyphase_tables(hist.device)
    _launch(
        "polyphase", hist.device,
        hist.data_ptr(), pcm.data_ptr(), wrev.data_ptr(), mrev_t.data_ptr(),
        S.data_ptr(), n, n_pcm, plan["tiles_per_block"], plan["smem_bytes"],
    )
    LAUNCHES["polyphase"] += 1
    return S


def polyphase_chunk(
    hist: torch.Tensor, pcm: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The ISO analysis filterbank over a chunk, with the contract of
    polyphase_chunk_pallas: hist [..., 480], pcm [..., n] with n a multiple
    of 576 (T frames of 1152 samples at MPEG-1, of 576 at LSF rates) ->
    (S [..., n/32, 32], x = hist | pcm [..., 480 + n]). The kernel computes
    S; x is concatenated outside it, as the plain version does."""
    return polyphase_subbands(hist, pcm), torch.cat([hist, pcm], dim=-1)

"""The hand-written CUDA kernels of the port, their wrappers and their plain
PyTorch versions: one for each Pallas kernel of the reference.

    rate_sweep  <- swiftmp3_tpu/ops/pallas_kernels.py:rate_sweep_pallas      (K1)
    pack        <- swiftmp3_tpu/ops/pallas_kernels.py:pack_pallas            (K2)
    polyphase   <- swiftmp3_tpu/ops/pallas_kernels.py:polyphase_chunk_pallas (K3)

and two with no Pallas kernel behind them: the chunk program's integer scans
over T (the reference's Phase 2 `lax.scan`, swiftmp3_tpu/models/pipeline.py),
`rate_loop_scan` and strict's second loop `placement_scan`, two entry points
of one source (K4); and the strict sweep, `strict_sweep` (K5), which prices
all 20 grid gains of each granule under the strict entropy layout in one
launch, where the reference lays out each gain in XLA
(swiftmp3_tpu/ops/dsp.py:1604-1736) and the plain version does so one gain
at a time (the loop that was ops/dsp.py:1127-1137).

Dispatch is by the device of the input tensor, with no fallback: a CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises
(a failed build, a refused launch and a nonzero `cudaGetLastError()` all
raise). Each wrapper adds one to `LAUNCHES[name]` where it launches its
kernel, and nowhere else (K5 also to the port's trace counter
`sweep.strict_launches`).

Each is laid out for the H100's SM (each csrc/*.cu says how): K1
quantizes without a float-to-int conversion and prices a pair with one byte
lookup in `sweep_cost_table`; K2 is a persistent grid of warps
(`pack_plan`), each packing whole frames from a ring of slot tiles, the
nbits staged by TMA bulk copies and only the live slots' chunks by cp.async;
K3 register-tiles its cosine product and walks
`polyphase_plan`'s tiles with asynchronous staging; K4 walks each stream's
frames with one warp, its state in registers; K5 gives each granule a warp
whose lanes hold its magnitudes in registers (four lines a lane a round, by
float4 loads) for all 20 gains, with the pair costs as bytes
(`strict_cost_table`) and the rate's region bounds (`strict_sweep_lut`) in
shared memory. K1's and K5's quantizers round the product and the sum
apart (no FMA, which would move q across .5 knife edges). What the launches
need beyond pointers (the cost tables, the grids, the dynamic shared-memory
sizes, K4's parameter block) is computed here, where the CPU tests reach it.

Build: `nvcc` (sm_90a) compiles each `csrc/*.cu` into a shared library with
a plain C interface under `swiftmp3_tpu_torch/_build/` at the first CUDA
call (or `build_kernels()`), all sources in parallel; the libraries are
loaded with ctypes. Nothing is built or imported at module import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import threading

import torch

from ..utils import profiling

N_GAIN_CANDIDATES = 20  # the reference's maxIterations
_PAIRS = 288

LAUNCHES = {
    "rate_sweep": 0, "pack": 0, "polyphase": 0, "rate_loop_scan": 0, "placement_scan": 0,
    "strict_sweep": 0,
}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# library -> source; each library's C entry points are swm_<name> for the
# names that ENTRY_LIBRARY maps to it
SOURCES = {
    "rate_sweep": "rate_sweep.cu", "pack": "pack.cu", "polyphase": "polyphase.cu",
    "rate_loop_scan": "rate_loop_scan.cu", "strict_sweep": "strict_sweep.cu",
}
ENTRY_LIBRARY = {name: name for name in SOURCES} | {"placement_scan": "rate_loop_scan"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
EXTRA_NVCC_FLAGS = {
    # no FMA contraction: K1's and K5's quantizers round mag*inv, then +0.5,
    # then floor; K4's energy law subtracts, then multiplies
    "rate_sweep": ["--fmad=false"],
    "rate_loop_scan": ["--fmad=false"],
    "strict_sweep": ["--fmad=false"],
}

_vp = ctypes.c_void_p
_SIGNATURES = {
    # (mag, gstart, inv_table, cost_table, bits, bv, n, stream)
    "rate_sweep": [_vp, _vp, _vp, _vp, _vp, _vp, ctypes.c_longlong, _vp],
    # (chunks, nbits, out, total_bits, F, P, cap, blocks, smem_bytes, stream)
    "pack": [_vp, _vp, _vp, _vp] + [ctypes.c_int] * 5 + [_vp],
    # (hist, pcm, wrev, mrev_t, S, n_rows, n_pcm, tiles_per_block, smem_bytes, stream)
    "polyphase": [_vp, _vp, _vp, _vp, _vp] + [ctypes.c_longlong] * 4 + [_vp],
    # (&SwmScanParams, &SwmScanIo, stream); (&SwmScanParams, &SwmPlacementIo, stream)
    "rate_loop_scan": [_vp, _vp, _vp],
    "placement_scan": [_vp, _vp, _vp],
    # (mag, gstart, is_long, b0_switch, part2, inv_table, cost_table, lut, bits, n,
    #  count1_coding, region_table_select, linbits, stream)
    "strict_sweep": [_vp] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [_vp],
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
            for entry, library in ENTRY_LIBRARY.items():
                if library == name:
                    fn = getattr(lib, f"swm_{entry}")
                    fn.argtypes = _SIGNATURES[entry]
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
    library = ENTRY_LIBRARY[name]
    lib = _libs.get(library) or build_kernels()[library]
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


# --- K4: the rate loop's scans over T --------------------------------------------

# The kernel's limits (csrc/rate_loop_scan.cu): granules a frame, reservoir
# depth, demand-VBR candidates, bitrate-table entries, the energy history
K4_MAX_GRANULES = 4
K4_MAX_DEPTH = 8
K4_MAX_CANDS = 16
K4_HISTORY = 10
RATE_LAWS = {"cbr": 0, "energy": 1, "demand": 2}


@dataclasses.dataclass(frozen=True)
class RateLoopConfig:
    """What the scans over T read of the options
    (`models.pipeline.rate_loop_config` makes it): the frame geometry
    (granules, sample rate, slots a kbps, side-info and CRC bytes, the
    reservoir's reach), the rate law ("cbr", "energy" or "demand") with the
    CBR frame's header index and kbps, the energy law's base and quality,
    demand VBR's candidate kbps and their slots in bits, and the reservoir
    (aligned, deeper than one frame), linbits and demand-budget switches."""

    n_gran: int
    sample_rate: int
    lsf: bool
    slots_per_kbps: int
    side_size: int
    crc_size: int
    res_cap: int
    rate_law: str
    cbr_index: int
    cbr_value: int
    base_kbps: int
    quality: int
    cands: tuple = ()
    cand_slot_bits: tuple = ()
    aligned: bool = False
    deep: bool = False
    linbits: bool = False
    demand_budget: bool = False


class _ScanParams(ctypes.Structure):
    """csrc/rate_loop_scan.cu's SwmScanParams, field for field."""

    _fields_ = [
        (name, ctypes.c_int)
        for name in (
            "B", "T", "G", "K", "sample_rate", "slots_per_kbps", "side_size", "crc_size",
            "res_cap", "rate_law", "aligned", "deep", "linbits", "demand_budget", "cbr_index",
            "cbr_value", "base_kbps", "min_bitrate", "max_bitrate", "max_adjustment", "n_cands",
        )
    ] + [(name, ctypes.c_int * K4_MAX_CANDS) for name in ("bitrates", "cands", "cand_slot_bits")]


def _pointers(name: str, fields: tuple) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": [(f, ctypes.c_void_p) for f in fields]})


_SCAN_CARRY = ("stream_len", "avail", "pad_rem", "slot_fifo", "vbr_ehist", "vbr_count")
_SCAN_IN = ("bits", "evaluated", "k_budget", "granule_e", "final", "valid", "frame_e", "demand",
            "frame_demand")
_SCAN_OUT = ("br_idx", "padding", "mdb", "slot", "k_sel", "has_fit", "bits_sel")
_PLACEMENT_CARRY = ("stream_len", "slot_fifo")
_PLACEMENT_IN = ("hb", "slot", "final", "valid")
# csrc/rate_loop_scan.cu's SwmScanIo and SwmPlacementIo, field for field
_ScanIo = _pointers(
    "_ScanIo",
    _SCAN_IN + tuple(f"{k}_in" for k in _SCAN_CARRY) + _SCAN_OUT
    + tuple(f"{k}_out" for k in _SCAN_CARRY),
)
_PlacementIo = _pointers(
    "_PlacementIo",
    _PLACEMENT_IN + tuple(f"{k}_in" for k in _PLACEMENT_CARRY) + ("mdb",)
    + tuple(f"{k}_out" for k in _PLACEMENT_CARRY),
)


def scan_params(cfg: RateLoopConfig, B: int, T: int, K: int) -> _ScanParams:
    """K4's parameter block for B streams of T frames at reservoir depth K:
    the config's numbers, the energy law's constants (dsp.vbr_law) and the
    bitrate table of the config's MPEG version."""
    from .dsp import BITRATE_VALUES, BITRATE_VALUES_V2, vbr_law

    if T < 1:
        raise ValueError(f"rate loop scan: {T} frames; a scan takes at least one")
    if not 1 <= cfg.n_gran <= K4_MAX_GRANULES:
        raise ValueError(f"rate loop scan: {cfg.n_gran} granules a frame pass {K4_MAX_GRANULES}")
    if not 1 <= K <= K4_MAX_DEPTH:
        raise ValueError(f"rate loop scan: reservoir depth {K} outside 1..{K4_MAX_DEPTH}")
    if len(cfg.cands) > K4_MAX_CANDS or len(cfg.cand_slot_bits) != len(cfg.cands):
        raise ValueError(
            f"rate loop scan: {len(cfg.cands)} demand candidates (at most {K4_MAX_CANDS})"
        )
    if cfg.rate_law == "demand" and not cfg.cands:
        raise ValueError("rate loop scan: demand VBR needs its candidates")
    max_adjustment, min_bitrate, max_bitrate = vbr_law(cfg.base_kbps, cfg.quality)
    table = BITRATE_VALUES_V2 if cfg.lsf else BITRATE_VALUES
    return _ScanParams(
        B=B, T=T, G=cfg.n_gran, K=K, sample_rate=cfg.sample_rate,
        slots_per_kbps=cfg.slots_per_kbps, side_size=cfg.side_size, crc_size=cfg.crc_size,
        res_cap=cfg.res_cap, rate_law=RATE_LAWS[cfg.rate_law], aligned=cfg.aligned,
        deep=cfg.deep, linbits=cfg.linbits, demand_budget=cfg.demand_budget,
        cbr_index=cfg.cbr_index, cbr_value=cfg.cbr_value, base_kbps=cfg.base_kbps,
        min_bitrate=min_bitrate, max_bitrate=max_bitrate, max_adjustment=max_adjustment,
        n_cands=len(cfg.cands), bitrates=(ctypes.c_int * K4_MAX_CANDS)(*table.tolist()),
        cands=(ctypes.c_int * K4_MAX_CANDS)(*cfg.cands),
        cand_slot_bits=(ctypes.c_int * K4_MAX_CANDS)(*cfg.cand_slot_bits),
    )


def _keep(new: dict, old: dict, val: torch.Tensor) -> dict:  # invalid frames freeze the carry
    B = val.shape[0]
    return {
        k: torch.where(val.reshape((B,) + (1,) * (v.dim() - 1)), v, old[k])
        for k, v in new.items()
    }


def _gap_of(cfg: RateLoopConfig, c: dict):
    """Buffered slot bytes past the stream mirror (aligned reservoir only:
    the compat law never reads it)."""
    if not cfg.aligned:
        return None
    return torch.sum(c["slot_fifo"], dim=1, dtype=torch.int32) - c["stream_len"]


def _placement(cfg: RateLoopConfig, c: dict, gap, hb, fin):
    """main_data_begin and the stream-length mirror after a frame of hb
    bytes (the aligned reservoir: tail-aligned at depth 1, front-aligned on
    the whole gap at depth > 1)."""
    res_cap = cfg.res_cap
    if cfg.aligned:
        if cfg.deep:
            mdb = torch.clamp(gap, 0, res_cap)
        else:
            mdb = torch.clamp(torch.minimum(gap, hb), 0, res_cap)
        sl = c["stream_len"] + (gap - mdb) + hb - c["slot_fifo"][:, 0]
    else:
        mdb = torch.where(fin, 0, torch.clamp(c["stream_len"], max=res_cap))
        sl = c["stream_len"] + hb - c["slot_fifo"][:, 0]
    return mdb, torch.clamp(sl, min=0)


def rate_loop_scan_plain(
    cfg: RateLoopConfig, carry: dict, bits, evaluated, k_budget, granule_e, final, valid,
    frame_e=None, demand=None, frame_demand=None,
) -> tuple[dict, tuple]:
    """Plain version of K4's selection scan: the chunk program's integer loop
    over T, one step of [B] ops a frame (pipeline.py, "Phase 2")."""
    from .dsp import (
        PART23_MAX_BITS,
        bitrate_index_device,
        bitrate_value_device,
        demand_budget_bits,
        demand_vbr_bitrate,
        rate_loop_select,
        vbr_choose_bitrate,
    )

    i32 = torch.int32
    T, B = valid.shape
    dev = valid.device
    sr, n_gran, lsf = cfg.sample_rate, cfg.n_gran, cfg.lsf
    res_cap = cfg.res_cap
    c = dict(carry)
    if cfg.rate_law == "cbr":
        br_idx_c = torch.full((B,), cfg.cbr_index, dtype=i32, device=dev)
        br_val_c = torch.full((B,), cfg.cbr_value, dtype=i32, device=dev)
    if cfg.rate_law == "demand":
        slots_c = torch.tensor(cfg.cand_slot_bits, dtype=i32, device=dev)
        cands_c = torch.tensor(cfg.cands, dtype=i32, device=dev)
    ys = []
    for t in range(T):
        fin = final[t]
        val = valid[t]
        if cfg.rate_law == "demand":
            target = demand_vbr_bitrate(frame_demand[t], slots_c, cands_c)
            br_idx = bitrate_index_device(target, sr)
            br_val = bitrate_value_device(br_idx, lsf=lsf)
        elif cfg.rate_law == "energy":
            target = vbr_choose_bitrate(
                frame_e[t], c["vbr_ehist"], c["vbr_count"], cfg.base_kbps, cfg.quality
            )
            br_idx = bitrate_index_device(target, sr)
            br_val = bitrate_value_device(br_idx, lsf=lsf)
        else:
            br_idx, br_val = br_idx_c, br_val_c

        numerator = cfg.slots_per_kbps * br_val * 1000
        base_size = numerator // sr
        pad_acc = c["pad_rem"] + numerator % sr
        padding = (pad_acc >= sr).to(i32)
        pad_rem = pad_acc - padding * sr
        slot = base_size + padding - 4 - cfg.crc_size - cfg.side_size

        gap = _gap_of(cfg, c)
        res_bits = torch.where(fin, 0, c["avail"] * 8)
        usable = (res_bits * 9) // 10
        if cfg.aligned:
            # the depth-general expressibility cap: a frame's data lands
            # only in still-buffered slots, within main_data_begin's reach
            usable = torch.minimum(usable, torch.clamp(gap, 0, res_cap) * 8)
        total_bits = slot * 8 + usable
        bits_per_granule = total_bits // n_gran
        if cfg.linbits:
            # ESC coding can reach the 12-bit part2_3_length field
            bits_per_granule = torch.clamp(bits_per_granule, max=PART23_MAX_BITS)
        if cfg.demand_budget:
            max_bits = demand_budget_bits(demand[t], total_bits, bits_per_granule)
        else:
            max_bits = bits_per_granule[:, None]

        k_sel, has_fit, bits_sel = rate_loop_select(
            bits[t], evaluated[t], k_budget[t], max_bits
        )
        huffman_bytes = (torch.sum(bits_sel, dim=-1, dtype=i32) + 7) // 8
        mdb, stream_len = _placement(cfg, c, gap, huffman_bytes, fin)
        new_c = {
            "stream_len": stream_len,
            "avail": torch.clamp(c["avail"] + slot - huffman_bytes, 0, res_cap),
            "pad_rem": pad_rem,
            "slot_fifo": torch.cat([c["slot_fifo"][:, 1:], slot[:, None]], dim=1),
            "vbr_ehist": torch.cat([c["vbr_ehist"][:, n_gran:], granule_e[t]], dim=1),
            "vbr_count": torch.clamp(c["vbr_count"] + n_gran, max=10),
        }
        c = _keep(new_c, c, val)
        ys.append((br_idx, padding, mdb, slot, k_sel, has_fit, bits_sel))
    return c, tuple(torch.stack(y) for y in zip(*ys))


def placement_scan_plain(
    cfg: RateLoopConfig, carry: dict, hb, slot, final, valid
) -> tuple[dict, torch.Tensor]:
    """Plain version of K4's placement scan: strict's second loop over T,
    the reservoir mirror on the actual bytes of each frame."""
    c2 = dict(carry)
    mdbs = []
    for t in range(valid.shape[0]):
        mdb_t, sl = _placement(cfg, c2, _gap_of(cfg, c2), hb[t], final[t])
        new_c2 = {
            "stream_len": sl,
            "slot_fifo": torch.cat([c2["slot_fifo"][:, 1:], slot[t][:, None]], dim=1),
        }
        c2 = _keep(new_c2, c2, valid[t])
        mdbs.append(mdb_t)
    return c2, torch.stack(mdbs)


def _require_one_device(tensors: dict) -> torch.device:
    """The device all of `tensors` lie on, a CPU or a CUDA one; raises when
    they mix devices or lie elsewhere."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or dev.type not in ("cpu", "cuda"):
            raise ValueError(
                f"{name}: on {t.device}; the scan's tensors share one CPU or CUDA device"
            )
    return dev


def _check_scan_tensors(specs: dict, tensors: dict) -> None:
    """Each tensor's dtype and shape, and (on a card) its contiguity."""
    for name, (dtype, shape) in specs.items():
        t = tensors[name]
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")


def _carry_specs(names: tuple, B: int, K: int) -> dict:
    shapes = {"slot_fifo": (B, K), "vbr_ehist": (B, K4_HISTORY)}
    return {
        n: (torch.float32 if n == "vbr_ehist" else torch.int32, shapes.get(n, (B,))) for n in names
    }


def rate_loop_scan(
    cfg: RateLoopConfig, carry: dict, bits, evaluated, k_budget, granule_e, final, valid,
    frame_e=None, demand=None, frame_demand=None,
) -> tuple[dict, tuple]:
    """The selection scan over T of B streams (K4's first entry point): each
    frame's bitrate, padding and slot, reservoir budget, the candidate of
    each granule and the reservoir mirror, the carry frozen on invalid
    frames.

    carry: {stream_len (strict: the priced mirror), avail, pad_rem [B],
    slot_fifo [B, K] int32, vbr_ehist [B, 10] float32, vbr_count [B]
    int32}; bits [T, B, G, 20] int32, evaluated [T, B, G, 20] bool,
    k_budget [T, B, G] int32, granule_e [T, B, G] float32, final and valid
    [T, B] bool; frame_e [T, B] float32 under the energy law, demand
    [T, B, G] int32 under demand_budget, frame_demand [T, B] int32 under
    demand VBR (None otherwise). Returns (the carry, (br_idx, padding, mdb,
    slot [T, B] int32, k_sel [T, B, G] int32, has_fit [T, B, G] bool,
    bits_sel [T, B, G] int32))."""
    T, B = valid.shape
    G = cfg.n_gran
    K = carry["slot_fifo"].shape[-1]
    optional = {
        "frame_e": (frame_e, cfg.rate_law == "energy", torch.float32, (T, B)),
        "demand": (demand, cfg.demand_budget, torch.int32, (T, B, G)),
        "frame_demand": (frame_demand, cfg.rate_law == "demand", torch.int32, (T, B)),
    }
    tensors = {f"{k}_in": carry[k] for k in _SCAN_CARRY}
    tensors.update(bits=bits, evaluated=evaluated, k_budget=k_budget, granule_e=granule_e,
                   final=final, valid=valid)
    specs = {f"{k}_in": v for k, v in _carry_specs(_SCAN_CARRY, B, K).items()}
    specs.update(
        bits=(torch.int32, (T, B, G, N_GAIN_CANDIDATES)),
        evaluated=(torch.bool, (T, B, G, N_GAIN_CANDIDATES)),
        k_budget=(torch.int32, (T, B, G)), granule_e=(torch.float32, (T, B, G)),
        final=(torch.bool, (T, B)), valid=(torch.bool, (T, B)),
    )
    for name, (t, needed, dtype, shape) in optional.items():
        if (t is not None) != needed:
            raise ValueError(f"{name}: {'required' if needed else 'not read'} under this config")
        if needed:
            tensors[name], specs[name] = t, (dtype, shape)
    dev = _require_one_device(tensors)
    _check_scan_tensors(specs, tensors)
    params = scan_params(cfg, B, T, K)
    if _on_cpu(bits):
        return rate_loop_scan_plain(
            cfg, carry, bits, evaluated, k_budget, granule_e, final, valid,
            frame_e=frame_e, demand=demand, frame_demand=frame_demand,
        )
    new = {k: torch.empty(shape, dtype=dtype, device=dev)
           for k, (dtype, shape) in _carry_specs(_SCAN_CARRY, B, K).items()}
    per_granule = {"k_sel": (T, B, G), "has_fit": (T, B, G), "bits_sel": (T, B, G)}
    outs = tuple(
        torch.empty(per_granule.get(n, (T, B)), dtype=torch.bool if n == "has_fit" else torch.int32,
                    device=dev)
        for n in _SCAN_OUT
    )
    io = _ScanIo(
        **{k: (tensors[k].data_ptr() if k in tensors else None) for k in _SCAN_IN},
        **{f"{k}_in": carry[k].data_ptr() for k in _SCAN_CARRY},
        **{k: o.data_ptr() for k, o in zip(_SCAN_OUT, outs)},
        **{f"{k}_out": new[k].data_ptr() for k in _SCAN_CARRY},
    )
    _launch("rate_loop_scan", dev, ctypes.addressof(params), ctypes.addressof(io))
    LAUNCHES["rate_loop_scan"] += 1
    return new, outs


def placement_scan(
    cfg: RateLoopConfig, carry: dict, hb, slot, final, valid
) -> tuple[dict, torch.Tensor]:
    """strict's second scan over T (K4's second entry point): each frame's
    main_data_begin and the stream mirror on the actual bytes hb [T, B]
    int32 of the frames whose slots slot [T, B] int32 the first scan chose,
    the carry {stream_len [B], slot_fifo [B, K] int32} frozen on invalid
    frames (final, valid [T, B] bool). Returns (the carry, mdb [T, B]
    int32)."""
    T, B = valid.shape
    K = carry["slot_fifo"].shape[-1]
    tensors = {f"{k}_in": carry[k] for k in _PLACEMENT_CARRY}
    tensors.update(hb=hb, slot=slot, final=final, valid=valid)
    specs = {f"{k}_in": v for k, v in _carry_specs(_PLACEMENT_CARRY, B, K).items()}
    specs.update(hb=(torch.int32, (T, B)), slot=(torch.int32, (T, B)),
                 final=(torch.bool, (T, B)), valid=(torch.bool, (T, B)))
    dev = _require_one_device(tensors)
    _check_scan_tensors(specs, tensors)
    params = scan_params(cfg, B, T, K)
    if _on_cpu(hb):
        return placement_scan_plain(cfg, carry, hb, slot, final, valid)
    new = {k: torch.empty(shape, dtype=dtype, device=dev)
           for k, (dtype, shape) in _carry_specs(_PLACEMENT_CARRY, B, K).items()}
    mdb = torch.empty((T, B), dtype=torch.int32, device=dev)
    io = _PlacementIo(
        **{k: tensors[k].data_ptr() for k in _PLACEMENT_IN},
        **{f"{k}_in": carry[k].data_ptr() for k in _PLACEMENT_CARRY},
        mdb=mdb.data_ptr(),
        **{f"{k}_out": new[k].data_ptr() for k in _PLACEMENT_CARRY},
    )
    _launch("placement_scan", dev, ctypes.addressof(params), ctypes.addressof(io))
    LAUNCHES["placement_scan"] += 1
    return new, mdb


# --- K5: the strict sweep ---------------------------------------------------------

# The kernel's word table (csrc/strict_sweep.cu): a long granule's region
# bounds b0 | b1 << 16 for each big_values 0..288, table_for_max for maxima
# 0..15, the ESC family's bounds, the count1 A code lengths by pattern
K5_LUT_REGION = 0
K5_LUT_TABLE_FOR_MAX = 289
K5_LUT_ESC_BOUNDS = 305
K5_LUT_COUNT1_LEN = 312
K5_LUT_WORDS = 328


@functools.lru_cache(maxsize=None)
def strict_cost_table(device: torch.device) -> torch.Tensor:
    """The kernel's one lookup per pair: dsp.PAIR_COST, [32 x 256] (table id,
    then min(x, 15) * 16 + min(y, 15): code length, sign bits and the id's
    linbits per escaped coordinate) as uint8 (made once per device). Raises
    if a cost does not fit a byte."""
    from .dsp import PAIR_COST

    cost = torch.from_numpy(PAIR_COST).reshape(-1)
    if int(cost.min()) < 0 or int(cost.max()) > 255:
        raise ValueError("strict sweep: a pair cost does not fit the kernel's byte table")
    return cost.to(torch.uint8).to(device)


@functools.lru_cache(maxsize=None)
def strict_sweep_lut(sample_rate: int, device: torch.device) -> torch.Tensor:
    """The kernel's word table for `sample_rate` (made once per rate and
    device), K5_LUT_WORDS int32 at the K5_LUT_* offsets: a long granule's
    region bounds by big_values (dsp.region_counts, then the bounds the
    plain layout reads, b0 | b1 << 16), dsp.TABLE_FOR_MAX, dsp.ESC_BOUNDS and
    the count1 A code lengths."""
    from .dsp import COUNT1A_LEN_T, ESC_BOUNDS, TABLE_FOR_MAX, _region_bounds, region_counts

    bv = torch.arange(K5_LUT_TABLE_FOR_MAX, dtype=torch.int32)
    b0, b1 = _region_bounds(*region_counts(bv, sample_rate), sample_rate)
    lut = torch.zeros(K5_LUT_WORDS, dtype=torch.int32)
    lut[K5_LUT_REGION:K5_LUT_TABLE_FOR_MAX] = b0 | (b1 << 16)
    lut[K5_LUT_TABLE_FOR_MAX:K5_LUT_ESC_BOUNDS] = torch.from_numpy(TABLE_FOR_MAX)
    lut[K5_LUT_ESC_BOUNDS:K5_LUT_ESC_BOUNDS + len(ESC_BOUNDS)] = torch.from_numpy(ESC_BOUNDS)
    lut[K5_LUT_COUNT1_LEN:] = torch.from_numpy(COUNT1A_LEN_T)
    return lut.to(device)


def strict_sweep_plain(
    mag, gstart, inv_table, is_long, b0_switch=None, part2=None, *,
    sample_rate: int, count1_coding: bool, region_table_select: bool, linbits: bool,
) -> torch.Tensor:
    """Plain version of K5: the 20 gains priced one at a time, each
    quantized (the product and the sum rounded separately, as the
    reference) and laid out in full by dsp.strict_layout_device."""
    from .dsp import QCAP_LINBITS, strict_layout_device

    qcap = float(QCAP_LINBITS if linbits else 15)
    cols = []
    for a in range(N_GAIN_CANDIDATES):
        inv = inv_table[torch.clamp(gstart + 4 * a, max=255).long()]
        q_abs = torch.clamp(torch.floor(mag * inv[..., None] + 0.5), max=qcap).to(torch.int32)
        lay = strict_layout_device(
            q_abs, sample_rate, is_long, count1_coding, region_table_select,
            assume_abs=True, linbits=linbits, b0_switch=b0_switch,
        )
        cols.append(lay["bits"])
    bits = torch.stack(cols, dim=-1)
    if part2 is not None:
        bits = bits + part2[..., None]
    return bits.to(torch.int32)


def _per_granule(t: torch.Tensor, lead: tuple, dtype: torch.dtype) -> torch.Tensor:
    """t broadcast to the granules' shape, contiguous, as `dtype` (no copy
    when it already is)."""
    if tuple(t.shape) != lead or t.dtype != dtype or not t.is_contiguous():
        t = torch.broadcast_to(t.to(dtype), lead).contiguous()
    return t


def strict_sweep(
    mag, gstart, inv_table, is_long, b0_switch=None, part2=None, *,
    sample_rate: int, count1_coding: bool, region_table_select: bool, linbits: bool,
) -> torch.Tensor:
    """The strict-entropy bits of the 20-gain grid (K5): for gains
    min(gstart + 4a, 255), q = min(floor(mag * inv + 0.5), qcap) (15, or
    QCAP_LINBITS under linbits) laid out by dsp.strict_layout_device, its
    "bits", plus part2.

    mag: [..., 576] float32 (|x|^0.75, scaled, in stream order); gstart:
    [...] int32 in 0..255; inv_table: [256] float32, the inverse steps of
    the law (dsp.inv_step_table); is_long: bool, and b0_switch (None: 36)
    and part2 (None: 0) int32, each broadcasting against [...]. Returns
    bits [..., 20] int32."""
    options = dict(
        sample_rate=sample_rate, count1_coding=count1_coding,
        region_table_select=region_table_select, linbits=linbits,
    )
    if _on_cpu(mag):
        return strict_sweep_plain(mag, gstart, inv_table, is_long, b0_switch, part2, **options)
    _require_cuda(mag, gstart, inv_table)
    lead = tuple(gstart.shape)
    _require(mag, "mag", torch.float32, lead + (576,))
    _require(gstart, "gstart", torch.int32, lead)
    _require(inv_table, "inv_table", torch.float32, (256,))
    if mag.data_ptr() % 16:
        raise ValueError("mag: the kernel reads float4 (16-byte aligned)")
    dev = mag.device
    is_long = _per_granule(is_long, lead, torch.bool)
    if b0_switch is not None:
        b0_switch = _per_granule(b0_switch, lead, torch.int32)
    if part2 is not None:
        part2 = _per_granule(part2, lead, torch.int32)
    _require_cuda(mag, is_long, *(t for t in (b0_switch, part2) if t is not None))
    n = gstart.numel()
    bits = torch.empty(lead + (N_GAIN_CANDIDATES,), dtype=torch.int32, device=dev)
    if n == 0:
        return bits
    _launch(
        "strict_sweep", dev,
        mag.data_ptr(), gstart.data_ptr(), is_long.data_ptr(),
        None if b0_switch is None else b0_switch.data_ptr(),
        None if part2 is None else part2.data_ptr(),
        inv_table.data_ptr(), strict_cost_table(dev).data_ptr(),
        strict_sweep_lut(sample_rate, dev).data_ptr(), bits.data_ptr(), n,
        int(count1_coding), int(region_table_select), int(linbits),
    )
    LAUNCHES["strict_sweep"] += 1
    profiling.count("sweep.strict_launches")
    return bits

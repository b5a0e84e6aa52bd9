// K2 on Hopper: the main_data pack.
//
// Replaces swiftmp3_tpu/ops/pallas_kernels.py:pack_pallas (the Pallas
// _pack_kernel, which scatters through one-hot MXU matmuls on 8-frame
// tiles). Per frame: the exclusive prefix sum of nbits gives each slot's bit
// offset O; each chunk of nbits <= 15 bits (and below 2^nbits) lands
// MSB-first at O. Bits of different slots are disjoint, so OR equals SUM.
// The result is the frame's byte image, truncated at cap, and total_bits
// (the full sum, past the cap too).
//
// What bounds it on this card: bytes. A frame reads P nbits and the chunks
// of its live slots (nbits > 0), and writes cap bytes; per slot the work is
// a few integer operations. Read in full, the two int32 rows are 9 KB a
// frame at the main path's P = 1152, 331 MB at 32 768 frames: 0.099 ms at
// 3.35 TB/s. The coder leaves most slots dead, in runs (the zero region of
// each granule, the unused ESC and quad slots), so a kernel that reads no
// dead chunk moves far less: on the paths' own inputs 4-35% of the 16-byte
// groups of chunks hold a live slot.
//
// Design, and what each part does about the first kernel's limits (one
// 256-thread block a frame; each thread read a run of P/256 slots twice,
// strided; a block scan; byte stores; no load overlapping the block's
// zero-scan-scatter-store chain; up to a quarter of the threads idle at
// P <= 1152):
//  - A persistent grid of warps, each warp owning whole frames. The grid is
//    kernels.pack_plan's: as many blocks of kWarps warps as the shared
//    memory lets each of the 132 SMs hold (two up to cap 2124, one above),
//    and no more than the frames need. Warp g of G walks frames g, g + G,
//    ...; a frame's scan and scatter stay inside its warp, so there is no
//    block-level combine and no __syncthreads, and no warp waits for another.
//  - Asynchronous staging in a ring of kStages tiles of kTile slots a warp
//    (a frame of any P: its last tile is short), two mbarriers a stage. The
//    nbits of a tile come by one TMA 1D bulk copy (cp.async.bulk ...
//    mbarrier::complete_tx; no tensor map), asked for kStages tiles ahead by
//    lane 0. When a tile's nbits have landed, kLead tiles ahead of the
//    consumer, the lanes ask for its chunks by cp.async: 16 bytes where any
//    of 4 slots is live, nothing where all 4 are dead; each lane's copies
//    arrive on the stage's second mbarrier. So the next tiles (of this frame
//    or the warp's next one) are in flight while a tile is scanned and
//    packed, and no dead chunk is read. Bulk and 16-byte copies need 16-byte
//    aligned addresses: a tile whose start is not (a row of P = 4k + 2
//    slots, a misaligned base pointer) takes its nbits by the lanes'
//    ordinary loads and its chunks by 4-byte cp.async of live slots, and so
//    do the last 1-3 slots of a tile whose length is not a multiple of 4, in
//    this kernel.
//  - A striped scan without conflicts. A warp step takes 128 consecutive
//    slots: lane l reads slots 4l .. 4l + 3 of each array as one 16-byte
//    shared load (the warp's lanes on consecutive addresses: no bank
//    conflict, no strided read), sums them, and a 5-shuffle inclusive scan
//    over the lanes gives each lane's offset; the running offset (the
//    frame's bits so far) is carried from step to step and tile to tile in
//    a register. A warp's time goes to these dependent chains more than to
//    its instructions, so kPar steps are scanned together (their shuffles
//    interleaved) and only the carry joins them. Only a frame's last step
//    may hold fewer than 128 slots, so no lane sits idle through a frame at
//    any P >= 128 (P = 576: 4 full steps and one of 64 slots).
//  - Fewer, wider atomics. A lane appends its four chunks into one 64-bit
//    register (at most 60 bits), shifts that run to its place in a 96-bit
//    window of three words and ORs the nonzero words into the frame's image
//    in shared memory: at most 3 atomicOr a lane and step (the first kernel
//    made up to 3 byte atomics a slot). The image holds big-endian words
//    (byte 4k in the top bits of word k), so a run's bits are one shift.
//    Words at or past ceil(cap / 4) are dropped, which is the truncation.
//  - Word stores. The image goes out as 32-bit stores of 4 bytes each,
//    byte-swapped and realigned to the row's address with one __byte_perm
//    (rows are cap bytes long, so a row's start is not word-aligned in
//    general); only the 0-3 head and tail bytes are stored one at a time.
//    The image is zeroed after the store for the warp's next frame.
// Shared memory a block: kWarps x (the ring, kStages x 2 x kTile x 4 B; the
// image, ceil(cap / 4) + 1 words rounded up to 4; 2 x kStages mbarriers):
// 104 KB at cap 894, 225 KB at cap 16384 (kernels.pack_plan computes the
// same and refuses more than a block may have). The entry point opts in to
// the 227 KB maximum, and asks for the SM's largest shared-memory carveout,
// once a device, not on every launch. The layout (kWarps, kTile, kStages,
// kLead, kPar) was chosen on an H100 among builds of other layouts (PERF.md
// section 6); kernels.py mirrors kWarps, kTile and kStages.

#include <atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                      // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 512;                     // slots a staged tile
constexpr int kStages = 3;                     // tiles in each warp's ring
constexpr int kLead = 1;                       // tiles whose chunks are asked for ahead
constexpr int kMaxBlocksPerSm = 32 / kWarps;   // 32 warps an SM at <= 64 registers
constexpr int kMaxBlockSmem = 232448;          // 227 KB, the most a block may have
constexpr int kStep = 128;                     // slots a warp step: 4 a lane
constexpr int kPar = 2;                        // warp steps scanned together

static_assert(kTile % (kPar * kStep) == 0, "a tile is whole groups of kPar warp steps");
static_assert(0 < kLead && kLead < kStages, "nbits land before their chunks are asked for");

__host__ __device__ constexpr int image_words(int cap) {
  return ((cap + 3) / 4 + 1 + 3) / 4 * 4;  // ceil(cap / 4) + a zero word, 16-byte rows
}

// a warp's ring (nbits and chunks tiles), its image and two mbarriers a stage
__host__ __device__ constexpr int warp_smem_bytes(int cap) {
  return 4 * (kStages * 2 * kTile + image_words(cap)) + 16 * kStages;
}

__host__ __device__ constexpr int block_smem_bytes(int cap) {
  return kWarps * warp_smem_bytes(cap);
}

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned int parity) {
  unsigned int done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// A warp's walk over its tiles: frame f, tile t of it, ring stage s and the
// parity of that stage's current use.
struct Cursor {
  long long f;
  int t, s;
  unsigned int phase;
  __device__ void next(int tiles, long long step) {
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
    }
    if (++t == tiles) {
      t = 0;
      f += step;
    }
  }
};

// Ask for the nbits of slots [g0, g0 + n) into ns: the 16-byte-aligned part
// by one bulk copy on `bar` (lane 0), the rest by the lanes' ordinary loads.
__device__ __forceinline__ void stage_nbits(int* ns, unsigned long long* bar,
                                            const int* __restrict__ nbits, long long g0, int n,
                                            bool aligned, int lane) {
  const int n_bulk = (aligned && (g0 & 3) == 0) ? (n & ~3) : 0;
  if (lane == 0) {
    // the ring slot was read by this warp's generic loads; order them
    // before the async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_expect(bar, 4u * (unsigned int)n_bulk);
    if (n_bulk > 0) bulk_load(ns, nbits + g0, 4u * (unsigned int)n_bulk, bar);
  }
  for (int j = n_bulk + lane; j < n; j += 32) ns[j] = nbits[g0 + j];
}

// Once the nbits of slots [g0, g0 + n) are in ns: ask for the chunks of the
// live ones into cs, 16 bytes (4 slots) at a time where any of the 4 is
// live and the address allows, else 4 bytes a live slot; each lane's copies
// arrive on `bar` (32 arrivals a phase). A dead slot's chunk is never read.
__device__ __forceinline__ void stage_chunks(int* cs, const int* ns, unsigned long long* bar,
                                             const int* __restrict__ chunks, long long g0,
                                             int n, bool aligned, int lane) {
  const int n16 = (aligned && (g0 & 3) == 0) ? (n >> 2) : 0;
  for (int q = lane; q < n16; q += 32) {
    const int4 nb = reinterpret_cast<const int4*>(ns)[q];
    if ((nb.x | nb.y | nb.z | nb.w) != 0) copy16(cs + 4 * q, chunks + g0 + 4 * q);
  }
  for (int j = 4 * n16 + lane; j < n; j += 32)
    if (ns[j] != 0) copy4(cs + j, chunks + g0 + j);
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// A lane's slots j .. j + 3 of a staged tile of n slots (those at or past n
// are stale and count as empty): their bits appended into `run`,
// right-aligned (at most 60 bits), and how many there are.
__device__ __forceinline__ int lane_run(const int* cs, const int* ns, int j, int n,
                                        unsigned long long& run) {
  const int4 c4 = *reinterpret_cast<const int4*>(cs + j);
  const int4 n4 = *reinterpret_cast<const int4*>(ns + j);
  const int lim = n - j;
  const int nb[4] = {lim > 0 ? n4.x : 0, lim > 1 ? n4.y : 0, lim > 2 ? n4.z : 0,
                     lim > 3 ? n4.w : 0};
  const int ch[4] = {c4.x, c4.y, c4.z, c4.w};  // stale where nb is 0
  run = 0ull;
  int len = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run = (run << nb[k]) | (unsigned int)(nb[k] > 0 ? ch[k] : 0);
    len += nb[k];
  }
  return len;
}

// OR a lane's run of len bits, starting at bit `at` of the frame, into the
// frame's image: the run in the 96-bit window of words at / 32 .. + 2.
__device__ __forceinline__ void place_run(unsigned int* img, unsigned long long run, int len,
                                          int at, int capw) {
  const int k0 = at >> 5;
  if (len == 0 || k0 >= capw) return;
  const int sh = 96 - (at & 31) - len;  // 5 .. 95
  unsigned int w0, w1, w2;
  if (sh >= 32) {
    const unsigned long long v = run << (sh - 32);
    w0 = (unsigned int)(v >> 32);
    w1 = (unsigned int)v;
    w2 = 0u;
  } else {
    const unsigned long long v = run >> (32 - sh);
    w0 = (unsigned int)(v >> 32);
    w1 = (unsigned int)v;
    w2 = (unsigned int)(run << sh);
  }
  if (w0) atomicOr(img + k0, w0);
  if (w1 && k0 + 1 < capw) atomicOr(img + k0 + 1, w1);
  if (w2 && k0 + 2 < capw) atomicOr(img + k0 + 2, w2);
}

__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
pack_kernel(const int* __restrict__ chunks, const int* __restrict__ nbits,
            unsigned char* __restrict__ out, int* __restrict__ total_bits, int F, int P,
            int cap, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int iw = image_words(cap);
  // [kWarps][kStages][nbits tile, chunks tile], [kWarps][iw], [kWarps][kStages][2]
  int* ring = reinterpret_cast<int*>(smem) + warp * (kStages * 2 * kTile);
  unsigned int* img =
      reinterpret_cast<unsigned int*>(smem + kWarps * 4 * kStages * 2 * kTile) + warp * iw;
  unsigned long long* nbar = reinterpret_cast<unsigned long long*>(
                                 smem + kWarps * 4 * (kStages * 2 * kTile + iw)) +
                             warp * 2 * kStages;
  unsigned long long* cbar = nbar + kStages;

  const int n_warps = gridDim.x * kWarps;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= F) return;  // warp-uniform; no block-level barrier follows
  const int tiles = P > 0 ? (P + kTile - 1) / kTile : 1;  // P = 0: one empty tile
  const long long n_items = (long long)((F - 1 - w) / n_warps + 1) * tiles;
  const int capw = (cap + 3) / 4;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(nbar + s, 1);
      bar_init(cbar + s, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = lane; k < iw; k += 32) img[k] = 0u;
  __syncwarp();

  // three walks over the same tiles: the nbits asked for kStages ahead, the
  // chunks kLead ahead (once that tile's nbits are in), and the consumer
  Cursor nc{w, 0, 0, 0u}, cc{w, 0, 0, 0u}, uc{w, 0, 0, 0u};
  auto ask_nbits = [&]() {
    const int t0 = nc.t * kTile;
    stage_nbits(ring + nc.s * 2 * kTile, nbar + nc.s, nbits, nc.f * P + t0,
                min(kTile, P - t0), aligned, lane);
    nc.next(tiles, n_warps);
  };
  auto ask_chunks = [&]() {
    const int t0 = cc.t * kTile;
    int* ns = ring + cc.s * 2 * kTile;
    bar_wait(nbar + cc.s, cc.phase);
    __syncwarp();  // and the lanes' ordinary loads of the tile's unaligned nbits
    stage_chunks(ns + kTile, ns, cbar + cc.s, chunks, cc.f * P + t0, min(kTile, P - t0),
                 aligned, lane);
    cc.next(tiles, n_warps);
  };
  for (long long i = 0; i < kStages && i < n_items; ++i) ask_nbits();
  __syncwarp();
  for (long long i = 0; i < kLead && i < n_items; ++i) ask_chunks();

  int carry = 0;  // the frame's bits before this step
  for (long long i = 0; i < n_items; ++i) {
    if (i + kLead < n_items) ask_chunks();
    bar_wait(cbar + uc.s, uc.phase);
    const int* ns = ring + uc.s * 2 * kTile;
    const int* cs = ns + kTile;
    const int n = min(kTile, P - uc.t * kTile);
    // kPar warp steps at a time: their scans are independent until the carry
    for (int base = 0; base < n; base += kPar * kStep) {
      unsigned long long run[kPar];
      int len[kPar], incl[kPar];
#pragma unroll
      for (int q = 0; q < kPar; ++q) {
        len[q] = lane_run(cs, ns, base + q * kStep + 4 * lane, n, run[q]);
        incl[q] = len[q];
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        int v[kPar];
#pragma unroll
        for (int q = 0; q < kPar; ++q) v[q] = __shfl_up_sync(0xffffffffu, incl[q], d);
        if (lane >= d) {
#pragma unroll
          for (int q = 0; q < kPar; ++q) incl[q] += v[q];
        }
      }
#pragma unroll
      for (int q = 0; q < kPar; ++q) {
        const int total = __shfl_sync(0xffffffffu, incl[q], 31);
        place_run(img, run[q], len[q], carry + incl[q] - len[q], capw);
        carry += total;
      }
    }
    __syncwarp();  // the stage is read; the image holds this tile's bits
    if (i + kStages < n_items) ask_nbits();

    if (uc.t == tiles - 1) {
      // the frame is whole: store its image as words, leave it zeroed
      unsigned char* row = out + uc.f * cap;
      const int h = (int)((4 - ((unsigned long long)row & 3)) & 3);  // bytes to a word boundary
      const int head = min(h, cap);
      const int nw = (cap - head) >> 2;
      if (lane < head) row[lane] = (unsigned char)(img[lane >> 2] >> (24 - 8 * (lane & 3)));
      for (int b = head + 4 * nw + lane; b < cap; b += 32)
        row[b] = (unsigned char)(img[b >> 2] >> (24 - 8 * (b & 3)));
      // little-endian word m of the row = stream bytes h + 4m .. h + 4m + 3,
      // from big-endian image words m and m + 1: selector nibble i is
      // (3 - h - i) & 7 in {img[m + 1] : img[m]}
      const unsigned int sel = ((3u - h) & 7u) | (((2u - h) & 7u) << 4) |
                               (((1u - h) & 7u) << 8) | (((0u - h) & 7u) << 12);
      unsigned int* wrow = reinterpret_cast<unsigned int*>(row + head);
      for (int m = lane; m < nw; m += 32) wrow[m] = __byte_perm(img[m], img[m + 1], sel);
      if (lane == 0) total_bits[uc.f] = carry;
      __syncwarp();
      for (int k = lane; k < capw; k += 32) img[k] = 0u;
      __syncwarp();
      carry = 0;
    }
    uc.next(tiles, n_warps);
  }
}

std::atomic<unsigned long long> g_opted_in{0};  // devices whose kernel may take kMaxBlockSmem

}  // namespace

// blocks and smem_bytes come from the wrapper's launch plan
// (kernels.pack_plan); smem_bytes must be this source's own size for cap.
extern "C" int swm_pack(const void* chunks, const void* nbits, void* out, void* total_bits,
                        int F, int P, int cap, int blocks, int smem_bytes, void* stream) {
  if (F <= 0) return 0;
  if (P < 0 || cap <= 0 || blocks <= 0 || smem_bytes != block_smem_bytes(cap) ||
      smem_bytes > kMaxBlockSmem)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(g_opted_in.load(std::memory_order_relaxed) & bit)) {
    // once a device: any plan's size may launch, and the SM keeps its
    // shared memory for kMaxBlocksPerSm blocks rather than for L1
    err = cudaFuncSetAttribute(pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxBlockSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pack_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    g_opted_in.fetch_or(bit);
  }
  const bool aligned = ((reinterpret_cast<unsigned long long>(chunks) |
                         reinterpret_cast<unsigned long long>(nbits)) & 15) == 0;
  pack_kernel<<<blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const int*>(chunks), static_cast<const int*>(nbits),
      static_cast<unsigned char*>(out), static_cast<int*>(total_bits), F, P, cap, aligned);
  return (int)cudaGetLastError();
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K3 on Hopper: the ISO analysis filterbank over a chunk.
//
// Replaces swiftmp3_tpu/ops/pallas_kernels.py:polyphase_chunk_pallas (the
// Pallas _kernel). For each row n (one channel of one stream) of the signal
// x = concat(hist [480], pcm [L]) and each window position p < T36 = L / 32:
//   partial[p][j] = sum_{m<8} x[32p + 64m + j] * Wrev[64m + j]   (j < 64)
//   S[n, p, k]    = sum_{j<64} partial[p][j] * MrevT[j][k]        (k < 32)
// with Wrev the reversed ISO window [512] and MrevT the reversed, transposed
// cosine matrix [64, 32] (the reformulation of dsp.py:polyphase_chunk).
//
// What bounds it on this card: bytes and operations about equally, and under
// both the shared-memory budget of phase (b). At the main path's shape (512
// rows, T = 128 frames: 4608 positions x 32 subbands a row) it reads 303 MB
// and writes 302 MB, 0.18 ms at 3.35 TB/s, and does 80 FMAs per output (16
// for the partial sums, 64 for the cosine product), 6.0 G FMAs, 0.18 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores. The fp32 pin keeps it off
// the tensor cores (TF32 would round the operands). An SM starts 128 FMAs a
// clock but its shared memory delivers 32 words a clock, so the cosine
// product reaches the FMA rate only if each word read from shared memory
// feeds several FMAs: a thread that reads one partial sum per FMA runs at a
// quarter of it (a first version built that way took 0.67 ms at that shape
// on an H100 at 700 W; this one takes 0.35 ms, and what is left is that the
// memory stream and the FMAs of a block overlap only in part).
//
// Design: 256 threads a block, tiles of 256 window positions, and each block
// walks several consecutive tiles of one row.
//  - Once per block: the cosine matrix goes to shared memory (8 KB) and each
//    thread keeps its 8 window terms in registers.
//  - Stage: a tile's 32 * 256 + 480 samples go to shared memory as 16-byte
//    asynchronous copies (cp.async), neighbouring threads on neighbouring
//    addresses, through two base pointers (x index i < 480 reads hist, the
//    rest pcm), so no concatenated copy of the input is written first. 480
//    and the row lengths are multiples of 4, so a 16-byte piece never
//    straddles hist and pcm or the end of a row; samples past the end of the
//    row are zeros, stored directly (the ragged last tile). The samples of
//    tile t + 1 are requested as soon as phase (a) of tile t has consumed the
//    buffer, so they arrive while phase (b) of tile t computes.
//  - Phase (a): thread (j, parity, half) walks 64 positions of one parity.
//    Two positions of one parity apart are 64 samples apart, so the eight
//    window terms slide by one: one new shared-memory load per partial sum,
//    the other seven stay in registers. Partials go to shared memory as
//    [256][64 + 4]: the row stride of 68 words keeps phase (b)'s 16-byte
//    reads aligned and off each other's banks.
//  - Phase (b): a register tile. Each thread owns 8 positions x 4 subbands
//    (32 accumulators); a warp is 4 position groups x 8 subband groups and
//    covers 32 consecutive positions. Per four values of j a thread reads 8
//    float4 of partial sums (its positions, j .. j+3) and 4 float4 of the
//    cosine matrix (its subbands) for 128 FMAs: 0.375 words an FMA. No read
//    has a bank conflict (the 8 lanes of a quarter warp share one position
//    group's address; position groups are 68 words apart). Stores are
//    float4: 8 lanes cover one position's 128 bytes, a warp 512 contiguous
//    bytes.
// Positions at or past T36 are computed on zeros and not stored (warps whose
// positions all lie past T36 skip phase (b)), so T36 need not be a multiple
// of the tile (a session chunk of T = 8 frames has 288 positions). The block
// needs 110 KB of dynamic shared memory (two blocks an SM), which the entry
// point opts in to.
//
// Rounding: every term is one fused multiply-add (__fmaf_rn) in a fixed order
// (m = 0..7, then j = 0..63 into one accumulator per output); the plain
// version rounds products and sums apart, and sums the product in BLAS
// order. They agree to ~1e-6 on unit-scale audio; the tolerance held is the
// JAX package's own for K3, 2e-5.

#include <cuda_runtime.h>

namespace {

constexpr int kHist = 480;
constexpr int kTile = 256;                  // window positions per tile
constexpr int kThreads = kTile;             // phase (b): 8 x 4 outputs a thread
constexpr int kSpan = 32 * kTile + kHist;   // samples staged per tile
constexpr int kPartialStride = 64 + 4;      // words per row of partial sums
constexpr int kSmemFloats = 64 * 32 + kSpan + kTile * kPartialStride;
constexpr int kSmemBytes = 4 * kSmemFloats;

static_assert(kThreads % 64 == 0 && kTile % 128 == 0, "phase (a) splits by parity and half");
static_assert(kSpan % 4 == 0, "16-byte staging");

__device__ __forceinline__ void copy16_async(float* smem_dst, const float* gmem_src) {
  const unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

// Request samples x0 .. x0 + kSpan of the row (hist | pcm | zeros) into xs.
__device__ __forceinline__ void stage_tile(float* xs, const float* hrow, const float* prow,
                                           long long x0, long long n_pcm) {
  for (int q = threadIdx.x; q < kSpan / 4; q += kThreads) {
    const long long i = x0 + 4 * q;
    if (i < kHist) {
      copy16_async(xs + 4 * q, hrow + i);
    } else if (i - kHist < n_pcm) {
      copy16_async(xs + 4 * q, prow + (i - kHist));
    } else {
      *reinterpret_cast<float4*>(xs + 4 * q) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
polyphase_kernel(const float* __restrict__ hist, const float* __restrict__ pcm,
                 const float* __restrict__ wrev, const float* __restrict__ mrev_t,
                 float* __restrict__ out, long long n_pcm, long long t36,
                 long long n_tiles, long long tiles_per_block, long long chunks) {
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;                 // [64][32] cosine matrix
  float* xs = ms + 64 * 32;         // [kSpan] staged samples
  float* partial = xs + kSpan;      // [kTile][kPartialStride]

  const long long row = blockIdx.x / chunks;
  const long long tile0 = (blockIdx.x % chunks) * tiles_per_block;
  const long long tile1 = min(tile0 + tiles_per_block, n_tiles);
  const float* hrow = hist + row * kHist;
  const float* prow = pcm + row * n_pcm;
  float* orow = out + row * t36 * 32;

  stage_tile(xs, hrow, prow, 32 * tile0 * kTile, n_pcm);
  for (int q = threadIdx.x; q < 64 * 32 / 4; q += kThreads) {
    reinterpret_cast<float4*>(ms)[q] = __ldg(reinterpret_cast<const float4*>(mrev_t) + q);
  }

  // phase (a): phase j of the window, positions first + 2i
  const int j = threadIdx.x & 63;
  const int first = ((threadIdx.x >> 6) & 1) + 128 * (threadIdx.x >> 7);
  float w[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) w[m] = __ldg(wrev + 64 * m + j);
  const float* xb = xs + 32 * first + j;  // x[32p + 64m + j] = xb[64 (i + m)]
  float* pa = partial + first * kPartialStride + j;

  // phase (b): positions pb + 4r (r < 8), subbands 4 kg .. 4 kg + 3
  const int warp = threadIdx.x >> 5;
  const int kg = threadIdx.x & 7;
  const int pb = 32 * warp + ((threadIdx.x >> 3) & 3);
  const float* pr = partial + pb * kPartialStride;
  const float* mr = ms + 4 * kg;

  for (long long tile = tile0; tile < tile1; ++tile) {
    const long long p0 = tile * kTile;  // first position of the tile
    // the tile's samples have landed; phase (b) of the last tile is done
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    {
      float v[8];
#pragma unroll
      for (int m = 0; m < 7; ++m) v[m] = xb[64 * m];
#pragma unroll 8
      for (int i = 0; i < kTile / 4; ++i) {
        v[7] = xb[64 * (i + 7)];
        float acc = __fmul_rn(v[0], w[0]);
#pragma unroll
        for (int m = 1; m < 8; ++m) acc = __fmaf_rn(v[m], w[m], acc);
        pa[2 * i * kPartialStride] = acc;
#pragma unroll
        for (int m = 0; m < 7; ++m) v[m] = v[m + 1];
      }
    }
    __syncthreads();

    // the sample buffer is free: request the next tile under phase (b)
    if (tile + 1 < tile1) stage_tile(xs, hrow, prow, 32 * (p0 + kTile), n_pcm);

    if (p0 + 32 * warp < t36) {  // warp-uniform
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      }
#pragma unroll 4
      for (int q = 0; q < 16; ++q) {
        const float4 m0 = *reinterpret_cast<const float4*>(mr + (4 * q + 0) * 32);
        const float4 m1 = *reinterpret_cast<const float4*>(mr + (4 * q + 1) * 32);
        const float4 m2 = *reinterpret_cast<const float4*>(mr + (4 * q + 2) * 32);
        const float4 m3 = *reinterpret_cast<const float4*>(mr + (4 * q + 3) * 32);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 a =
              *reinterpret_cast<const float4*>(pr + 4 * r * kPartialStride + 4 * q);
          acc[r][0] = __fmaf_rn(a.x, m0.x, acc[r][0]);
          acc[r][1] = __fmaf_rn(a.x, m0.y, acc[r][1]);
          acc[r][2] = __fmaf_rn(a.x, m0.z, acc[r][2]);
          acc[r][3] = __fmaf_rn(a.x, m0.w, acc[r][3]);
          acc[r][0] = __fmaf_rn(a.y, m1.x, acc[r][0]);
          acc[r][1] = __fmaf_rn(a.y, m1.y, acc[r][1]);
          acc[r][2] = __fmaf_rn(a.y, m1.z, acc[r][2]);
          acc[r][3] = __fmaf_rn(a.y, m1.w, acc[r][3]);
          acc[r][0] = __fmaf_rn(a.z, m2.x, acc[r][0]);
          acc[r][1] = __fmaf_rn(a.z, m2.y, acc[r][1]);
          acc[r][2] = __fmaf_rn(a.z, m2.z, acc[r][2]);
          acc[r][3] = __fmaf_rn(a.z, m2.w, acc[r][3]);
          acc[r][0] = __fmaf_rn(a.w, m3.x, acc[r][0]);
          acc[r][1] = __fmaf_rn(a.w, m3.y, acc[r][1]);
          acc[r][2] = __fmaf_rn(a.w, m3.z, acc[r][2]);
          acc[r][3] = __fmaf_rn(a.w, m3.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const long long p = p0 + pb + 4 * r;
        if (p < t36) {
          *reinterpret_cast<float4*>(orow + p * 32 + 4 * kg) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
  }
}

}  // namespace

// tiles_per_block and smem_bytes come from the wrapper's launch plan
// (kernels.polyphase_plan); smem_bytes must be this source's own size.
extern "C" int swm_polyphase(const void* hist, const void* pcm, const void* wrev,
                             const void* mrev_t, void* out, long long n_rows,
                             long long n_pcm, long long tiles_per_block,
                             long long smem_bytes, void* stream) {
  if (n_rows <= 0 || n_pcm <= 0) return 0;
  if (tiles_per_block <= 0 || smem_bytes != kSmemBytes) return (int)cudaErrorInvalidValue;
  const long long t36 = n_pcm / 32;
  const long long n_tiles = (t36 + kTile - 1) / kTile;
  const long long chunks = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const long long blocks = n_rows * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      polyphase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  polyphase_kernel<<<(unsigned int)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(hist), static_cast<const float*>(pcm),
      static_cast<const float*>(wrev), static_cast<const float*>(mrev_t),
      static_cast<float*>(out), n_pcm, t36, n_tiles, tiles_per_block, chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

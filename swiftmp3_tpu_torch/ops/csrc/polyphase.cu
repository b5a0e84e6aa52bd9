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
// What bounds it on this card: bytes and operations about equally. At the
// main path's shape (512 rows, T = 128 frames: 4608 positions x 32 subbands
// a row) it reads 303 MB and writes 302 MB, 0.18 ms at 3.35 TB/s, and does
// 80 FMAs per output (16 for the partial sums, 64 for the cosine product),
// 6.0 G FMAs, 0.18 ms at the 67 TFLOP/s of fp32 outside the tensor cores. The
// fp32 pin keeps it off the tensor cores (TF32 would round the operands).
//
// Design: one block per (row, tile of 64 positions), 256 threads.
//  - Stage: the tile's 32 * 64 + 480 samples go to shared memory in 16-byte
//    loads, neighbouring threads on neighbouring addresses, through two base
//    pointers (x index i < 480 reads hist, the rest pcm), so no concatenated
//    copy of the input is written first. 480 and the row lengths are
//    multiples of 4, so a float4 never straddles hist and pcm or the end of a
//    row; samples past the end of the row are zeros (the ragged last tile).
//  - Phase (a): thread (j, parity, half) walks 16 positions of one parity.
//    Two positions of one parity apart are 64 samples apart, so the eight
//    window terms slide by one: one new shared-memory load per partial sum,
//    the other seven stay in registers. Partials go to shared memory [64][64].
//  - Phase (b): thread (k, group) holds column k of MrevT (64 values) in
//    registers and computes 8 positions, reading each partial row as
//    broadcast float4 loads; stores are coalesced along k.
// Positions at or past T36 are computed on zeros and not stored, so T36 need
// not be a multiple of the tile (a session chunk of T = 8 frames has 288).
//
// Rounding: every term is one fused multiply-add (__fmaf_rn) in a fixed order
// (m = 0..7, then j = 0..63); the plain version rounds products and sums
// apart, and sums the product in BLAS order. They agree to ~1e-6 on
// unit-scale audio; the tolerance held is the JAX package's own for K3, 2e-5.

#include <cuda_runtime.h>

namespace {

constexpr int kHist = 480;
constexpr int kTile = 64;                  // window positions per block
constexpr int kSpan = 32 * kTile + kHist;  // samples staged per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
polyphase_kernel(const float* __restrict__ hist, const float* __restrict__ pcm,
                 const float* __restrict__ wrev, const float* __restrict__ mrev_t,
                 float* __restrict__ out, long long n_pcm, long long t36,
                 long long n_tiles) {
  __shared__ __align__(16) float xs[kSpan];
  __shared__ __align__(16) float partial[kTile * 64];

  const long long row = blockIdx.x / n_tiles;
  const long long p0 = (blockIdx.x % n_tiles) * kTile;  // first position
  const long long x0 = 32 * p0;                          // first staged sample
  const float* hrow = hist + row * kHist;
  const float* prow = pcm + row * n_pcm;

  for (int q = threadIdx.x; q < kSpan / 4; q += kThreads) {
    const long long i = x0 + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < kHist) {
      v = *reinterpret_cast<const float4*>(hrow + i);
    } else if (i - kHist < n_pcm) {
      v = *reinterpret_cast<const float4*>(prow + (i - kHist));
    }
    reinterpret_cast<float4*>(xs)[q] = v;
  }

  // column k of the cosine matrix, for phase (b); loaded while staging lands
  const int k = threadIdx.x & 31;
  float mk[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) mk[j] = __ldg(mrev_t + j * 32 + k);
  __syncthreads();

  // Phase (a): 64-phase windowed partial sums, a sliding window of 8 terms.
  {
    const int j = threadIdx.x & 63;
    const int parity = (threadIdx.x >> 6) & 1;
    const int first = parity + 32 * (threadIdx.x >> 7);  // positions first + 2i
    float w[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) w[m] = __ldg(wrev + 64 * m + j);
    const float* xb = xs + 32 * first + j;  // x[32p + 64m + j] = xb[64 (i + m)]
    float v[8];
#pragma unroll
    for (int m = 0; m < 7; ++m) v[m] = xb[64 * m];
#pragma unroll
    for (int i = 0; i < kTile / 4; ++i) {
      v[7] = xb[64 * (i + 7)];
      float acc = __fmul_rn(v[0], w[0]);
#pragma unroll
      for (int m = 1; m < 8; ++m) acc = __fmaf_rn(v[m], w[m], acc);
      partial[(first + 2 * i) * 64 + j] = acc;
#pragma unroll
      for (int m = 0; m < 7; ++m) v[m] = v[m + 1];
    }
  }
  __syncthreads();

  // Phase (b): the [64, 32] cosine product, 8 positions per thread.
  const int group = threadIdx.x >> 5;
  float* orow = out + row * t36 * 32;
#pragma unroll
  for (int r = 0; r < kTile / 8; ++r) {
    const int p = group + 8 * r;
    const float4* part4 = reinterpret_cast<const float4*>(partial + p * 64);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const float4 a = part4[q];
      acc = __fmaf_rn(a.x, mk[4 * q], acc);
      acc = __fmaf_rn(a.y, mk[4 * q + 1], acc);
      acc = __fmaf_rn(a.z, mk[4 * q + 2], acc);
      acc = __fmaf_rn(a.w, mk[4 * q + 3], acc);
    }
    if (p0 + p < t36) orow[(p0 + p) * 32 + k] = acc;
  }
}

}  // namespace

extern "C" int swm_polyphase(const void* hist, const void* pcm, const void* wrev,
                             const void* mrev_t, void* out, long long n_rows,
                             long long n_pcm, void* stream) {
  if (n_rows <= 0 || n_pcm <= 0) return 0;
  const long long t36 = n_pcm / 32;
  const long long n_tiles = (t36 + kTile - 1) / kTile;
  const long long blocks = n_rows * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  polyphase_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(hist), static_cast<const float*>(pcm),
      static_cast<const float*>(wrev), static_cast<const float*>(mrev_t),
      static_cast<float*>(out), n_pcm, t36, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

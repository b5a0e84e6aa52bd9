// K1 on Hopper: the compat rate loop's 20-gain table-15 sweep.
//
// Replaces swiftmp3_tpu/ops/pallas_kernels.py:rate_sweep_pallas (the Pallas
// _sweep_kernel with its where-tree lookups). Per granule: for each of 20
// gains g = min(gstart + 4k, 255), q = min(floor(mag * inv(g) + 0.5), 15) on
// the 288 (x, y) magnitude pairs; bv = last nonzero pair + 1; bits = sum over
// pairs < bv of (table-15 length + sign bits).
//
// What bounds it on this card: arithmetic, not bytes. Each granule reads
// 2304 bytes once and does 20 x 576 multiply/add/floor/min steps plus 20 x
// 288 table lookups (~11 G lane instructions at the main path's 131 072
// granules, against ~0.3 GB read).
//
// Design: one warp per granule, eight granules per 256-thread block. Each
// lane keeps its 9 pairs in registers (float2 loads, neighbouring lanes on
// neighbouring pairs), so the magnitudes are read once for all 20 gains. The
// two 256-entry tables (inverse step for the chosen law, table-15 lengths)
// sit in shared memory and are indexed directly: the gain is warp-uniform
// (a broadcast read), the pair index is per lane. The masked sum needs no
// second pass: pairs at or above bv are all (0, 0) pairs, so
// bits = sum over all 288 pairs - (288 - bv) * len(0, 0); both reductions are
// warp reductions (__reduce_add_sync / __reduce_max_sync).
//
// Rounding: the reference rounds mag*inv, then adds 0.5, then floors. An FMA
// would skip the first rounding and move q across .5 knife edges, so the
// product and the sum use __fmul_rn / __fadd_rn (and the build passes
// --fmad=false). Values past 15 clamp in float before the conversion, which
// is the saturating conversion of the reference.

#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 288;
constexpr int kGains = 20;
constexpr int kPairsPerLane = kPairs / 32;  // 9
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
rate_sweep_kernel(const float2* __restrict__ mag, const int* __restrict__ gstart,
                  const float* __restrict__ inv_table,
                  const int* __restrict__ len_table, int* __restrict__ bits_out,
                  int* __restrict__ bv_out, long long n) {
  __shared__ float s_inv[256];
  __shared__ int s_len[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    s_inv[i] = inv_table[i];
    s_len[i] = len_table[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long gr = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gr >= n) return;  // warp-uniform

  float2 v[kPairsPerLane];
  const float2* row = mag + gr * kPairs;
#pragma unroll
  for (int j = 0; j < kPairsPerLane; ++j) v[j] = row[lane + 32 * j];

  const int g0 = gstart[gr];
  const int zero_pair_len = s_len[0];
  int my_bits = 0;
  int my_bv = 0;
  for (int k = 0; k < kGains; ++k) {
    const int g = min(max(g0 + 4 * k, 0), 255);
    const float inv = s_inv[g];
    int sum = 0;
    int last = 0;
#pragma unroll
    for (int j = 0; j < kPairsPerLane; ++j) {
      const float fx = fminf(floorf(__fadd_rn(__fmul_rn(v[j].x, inv), 0.5f)), 15.0f);
      const float fy = fminf(floorf(__fadd_rn(__fmul_rn(v[j].y, inv), 0.5f)), 15.0f);
      const int qx = (int)fx;
      const int qy = (int)fy;
      sum += s_len[qx * 16 + qy] + (qx != 0) + (qy != 0);
      if ((qx | qy) != 0) last = lane + 32 * j + 1;
    }
    const int total = __reduce_add_sync(0xffffffffu, sum);
    const int bv = __reduce_max_sync(0xffffffffu, last);
    if (lane == k) {
      my_bits = total - (kPairs - bv) * zero_pair_len;
      my_bv = bv;
    }
  }
  if (lane < kGains) {
    bits_out[gr * kGains + lane] = my_bits;
    bv_out[gr * kGains + lane] = my_bv;
  }
}

}  // namespace

extern "C" int swm_rate_sweep(const void* mag, const void* gstart,
                              const void* inv_table, const void* len_table,
                              void* bits, void* bv, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kWarps - 1) / kWarps;
  rate_sweep_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(mag), static_cast<const int*>(gstart),
      static_cast<const float*>(inv_table), static_cast<const int*>(len_table),
      static_cast<int*>(bits), static_cast<int*>(bv), n);
  return (int)cudaGetLastError();
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1 on Hopper: the compat rate loop's 20-gain table-15 sweep.
//
// Replaces swiftmp3_tpu/ops/pallas_kernels.py:rate_sweep_pallas (the Pallas
// _sweep_kernel with its where-tree lookups). Per granule: for each of 20
// gains g = min(gstart + 4k, 255), q = min(floor(mag * inv(g) + 0.5), 15) on
// the 288 (x, y) magnitude pairs; bv = last nonzero pair + 1; bits = sum over
// pairs < bv of (table-15 length + sign bits).
//
// What bounds it on this card: instruction count, not bytes. Each granule
// reads 2304 bytes once and does 20 x 288 pair steps (0.76 G pairs at the
// main path's 131 072 granules, against ~0.3 GB read). An SM runs 128 lane
// instructions a clock on its fp32/integer lanes; floorf (round to integral)
// and an (int) cast (float to int) do not run there but on a narrower unit,
// and a per-lane index into a 256-word table makes a warp's shared-memory
// read collide up to 8-way. A first version with both (19 instructions a
// pair, 4 of them conversions) took 0.79 ms at that size on an H100 (700 W);
// replacing only the conversions gave 0.63 ms, and this design, with no
// conversion, about 13 instructions a pair and a byte table, 0.39 ms.
//
// Design: one warp per granule, eight granules per 256-thread block. Each
// lane keeps its 9 pairs in registers (float2 loads, neighbouring lanes on
// neighbouring pairs), so the magnitudes are read once for all 20 gains. The
// gain is warp-uniform (a broadcast read of the 256-entry inverse-step table
// in shared memory). Per pair:
//  - s = mag * inv + 0.5 with the product and the sum rounded apart (below);
//  - floor and clamp without a conversion: magnitudes are |x|^0.75 >= 0 and
//    inv > 0, so s >= 0 and min(floor(s), 15) == floor(min(s, 15.5)). For
//    0 <= t < 16, t + 2^23 rounded toward minus infinity (__fadd_rd, an
//    ordinary add) is exactly 2^23 + floor(t): the sum's unit in the last
//    place is 1, so rounding down drops the fraction of t. Its low four
//    mantissa bits are q. fminf(NaN, 15.5f) is 15.5 (fminf returns the
//    number), which gives 15 as fminf(floorf(NaN), 15.0f) does, and +inf
//    clamps to 15.5 likewise;
//  - one index: with wx, wy the two sums' bit patterns (0x4B000000 + q),
//    (wx * 16 + wy) & 255 == 16 qx + qy, since the high parts vanish under
//    the mask;
//  - one lookup: cost[16 qx + qy] = table-15 length + (qx != 0) + (qy != 0),
//    a 256-byte table built by the wrapper (64 words of shared memory, so a
//    warp's 32 scattered byte reads collide far less than in a 256-word
//    table); the pair is nonzero iff its index is.
// The masked sum needs no second pass: pairs at or above bv are all (0, 0)
// pairs, so bits = sum over all 288 pairs - (288 - bv) * cost[0]; both
// reductions are warp reductions (__reduce_add_sync / __reduce_max_sync).
//
// Rounding: the reference rounds mag*inv, then adds 0.5, then floors. An FMA
// would skip the first rounding and move q across .5 knife edges, so the
// product and the sum use __fmul_rn / __fadd_rn (and the build passes
// --fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 288;
constexpr int kGains = 20;
constexpr int kPairsPerLane = kPairs / 32;  // 9
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// The bit pattern of 2^23 + min(floor(s), 15) for s >= 0 or NaN.
__device__ __forceinline__ unsigned int quantized_word(float m, float inv) {
  const float s = fminf(__fadd_rn(__fmul_rn(m, inv), 0.5f), 15.5f);
  return __float_as_uint(__fadd_rd(s, 8388608.0f));
}

__global__ void __launch_bounds__(kThreads)
rate_sweep_kernel(const float2* __restrict__ mag, const int* __restrict__ gstart,
                  const float* __restrict__ inv_table,
                  const unsigned char* __restrict__ cost_table,
                  int* __restrict__ bits_out, int* __restrict__ bv_out, long long n) {
  __shared__ float s_inv[256];
  __shared__ __align__(4) unsigned char s_cost[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    s_inv[i] = inv_table[i];
    s_cost[i] = cost_table[i];
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
  const int zero_pair_cost = s_cost[0];
  int my_bits = 0;
  int my_bv = 0;
  for (int k = 0; k < kGains; ++k) {
    const int g = min(max(g0 + 4 * k, 0), 255);
    const float inv = s_inv[g];
    int sum = 0;
    int last_j = 0;  // 1 + the lane's last j with a nonzero pair
#pragma unroll
    for (int j = 0; j < kPairsPerLane; ++j) {
      const unsigned int idx =
          (quantized_word(v[j].x, inv) * 16u + quantized_word(v[j].y, inv)) & 255u;
      sum += s_cost[idx];
      if (idx != 0u) last_j = j + 1;
    }
    const int last = last_j != 0 ? lane + 32 * last_j - 31 : 0;  // pair index + 1
    const int total = __reduce_add_sync(0xffffffffu, sum);
    const int bv = __reduce_max_sync(0xffffffffu, last);
    if (lane == k) {
      my_bits = total - (kPairs - bv) * zero_pair_cost;
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
                              const void* inv_table, const void* cost_table,
                              void* bits, void* bv, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kWarps - 1) / kWarps;
  rate_sweep_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float2*>(mag), static_cast<const int*>(gstart),
      static_cast<const float*>(inv_table),
      static_cast<const unsigned char*>(cost_table), static_cast<int*>(bits),
      static_cast<int*>(bv), n);
  return (int)cudaGetLastError();
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

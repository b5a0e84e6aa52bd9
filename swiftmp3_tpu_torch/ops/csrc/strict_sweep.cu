// K5 on Hopper: the strict-entropy rate sweep, all 20 gains of a granule in
// one launch.
//
// Replaces no Pallas kernel. The reference prices the strict sweep in XLA
// (swiftmp3_tpu/ops/dsp.py:1604-1736, rate_loop_precompute_strict: every one
// of the 20 grid gains laid out by strict_entropy_layout). The port's plain
// version does the same one gain at a time (kernels.strict_sweep_plain, the
// loop that was ops/dsp.py:1127-1137), each gain a full strict_layout_device:
// ~170 memory-bound tensor ops over every granule, some 3,400 launches a
// 256-stream hq chunk.
//
// Per granule and gain g = min(gstart + 4a, 255), a = 0..19, on the 576
// magnitudes (|x|^0.75, scaled and in stream order):
//  - q = min(floor(mag * inv(g) + 0.5), qcap), qcap 15 or, under linbits,
//    8206 (QCAP_LINBITS);
//  - the last line with q > 0 and (count1 coding) the last with q > 1 give
//    big_values x 2 (bv2), the count1 quads n1 and the +2 shift that keeps
//    bv2 + 4 n1 within the granule;
//  - the region bounds: a long granule's from its big_values (the rate's
//    region table, made by the wrapper from dsp.region_counts), a switching
//    one's b0 = 36 (or the LSF b0_switch) and b1 = 576;
//  - (region_table_select) each region's maximum over the pairs below bv2
//    and its table (table_for_max, the ESC family under linbits; region 2 of
//    a switching granule takes id 0); otherwise table 15 everywhere;
//  - the pairs below bv2 priced by one byte lookup each, cost[tid][min(x,
//    15) * 16 + min(y, 15)] (code length, sign bits and linbits);
//  - (count1 coding) the quads in [bv2, bv2 + 4 n1) priced by count1 table
//    A and by table B, the smaller kept; then part2 is added.
// Every output is an integer and equals the plain version's bit for bit.
//
// What bounds it on this card: lane operations, not bytes. A granule reads
// 2304 bytes once and does 20 x (576 quantizations, the position maxima,
// 288 pair lookups, 144 quads): some 5,900 lane operations a gain, 15.5 G
// at hq's 131,072 granules against 0.3 GB read. Design:
//  - one warp a granule, eight a 256-thread block, at least three blocks an
//    SM (__launch_bounds__ caps the registers at 85, with no spills: the
//    region-select instantiations take 102-104 registers uncapped, two
//    blocks an SM, and ran 9% slower on an H100; four blocks spill);
//  - lane l holds the quads l + 32r (r = 0..4; lanes 16-31 have no fifth),
//    read once by coalesced float4 loads and kept in registers for all 20
//    gains, so each lane also holds both pairs of each of its quads;
//  - the quantizer floors and clamps without a conversion, as K1's does:
//    min(floor(s), qcap) == floor(min(s, qcap + 0.5)) for s >= 0, and
//    t + 2^23 rounded toward minus infinity is 2^23 + floor(t) exactly for
//    0 <= t < 2^23, so q is that sum's bit pattern less 2^23's;
//  - the positions, the three region maxima and the three sums are warp
//    reductions (__reduce_max_sync / __reduce_add_sync); everything that
//    follows from them (bv2, n1, the bounds, the tables) is warp-uniform;
//  - the quads at offset 2 take the next quad's first two flags from the
//    next lane by a shuffle (lane 31 from lane 0 of the next round); the
//    last offset-2 quad is padding and stays zero, as in the plain version;
//  - the tables sit in shared memory: the [32 x 256] pair costs as bytes (8
//    KB; the wrapper checks they fit one), the 256 inverse steps, and one
//    word table (region bounds by big_values, table_for_max, the ESC bounds,
//    the count1 A lengths; offsets below, mirrored in kernels.K5_LUT_*);
//  - count1 coding, region table select and linbits are template
//    parameters, so each preset runs its own straight-line code; the sample
//    rate reaches the kernel only through the region table, and is_long,
//    b0_switch and part2 are read per granule.
//
// Rounding: the reference rounds mag * inv, then adds 0.5, then floors. An
// FMA would skip the first rounding and move q across .5 knife edges (the
// fault of the Pallas sweep in interpret mode), so the product and the sum
// use __fmul_rn / __fadd_rn, and the build passes --fmad=false as well.

#include <cuda_runtime.h>

namespace {

constexpr int kLines = 576;
constexpr int kQuads = 144;
constexpr int kRounds = 5;  // quads lane + 32r, r < kRounds
constexpr int kGains = 20;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 3;  // resident blocks an SM
constexpr int kCostBytes = 32 * 256;  // [tid][16 x + y]
constexpr unsigned kFull = 0xffffffffu;

// the word table (kernels.K5_LUT_*): b0 | b1 << 16 of a long granule for each
// big_values 0..288, table_for_max for maxima 0..15, the ESC family's bounds,
// the count1 A code lengths by pattern
constexpr int kLutRegion = 0;
constexpr int kLutTableForMax = 289;
constexpr int kLutEscBounds = 305;
constexpr int kEscBounds = 7;
constexpr int kLutCount1Len = 312;
constexpr int kLutWords = 328;

// min(floor(m * inv + 0.5), cap_half - 0.5) for m >= 0, inv > 0, with the
// product and the sum rounded apart; no float-to-int conversion.
__device__ __forceinline__ int quantize(float m, float inv, float cap_half) {
  const float s = fminf(__fadd_rn(__fmul_rn(m, inv), 0.5f), cap_half);
  return (int)(__float_as_uint(__fadd_rd(s, 8388608.0f)) - 0x4B000000u);
}

template <bool kLinbits>
__device__ __forceinline__ int table_for_max(int m, const int* lut) {
  int tid = lut[kLutTableForMax + min(m, 15)];
  if (kLinbits && m > 15) {
    int above = 0;
#pragma unroll
    for (int j = 0; j < kEscBounds; ++j) above += lut[kLutEscBounds + j] < m - 15;
    tid = 24 + above;
  }
  return tid;
}

template <bool kCount1, bool kSelect, bool kLinbits>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
strict_sweep_kernel(const float4* __restrict__ mag, const int* __restrict__ gstart,
                    const unsigned char* __restrict__ is_long,
                    const int* __restrict__ b0_switch, const int* __restrict__ part2,
                    const float* __restrict__ inv_table,
                    const unsigned char* __restrict__ cost_table,
                    const int* __restrict__ lut_table, int* __restrict__ bits_out,
                    long long n) {
  __shared__ float s_inv[256];
  __shared__ __align__(16) unsigned char s_cost[kCostBytes];
  __shared__ int s_lut[kLutWords];
  for (int i = threadIdx.x; i < kCostBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(s_cost)[i] = reinterpret_cast<const uint4*>(cost_table)[i];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_inv[i] = inv_table[i];
  for (int i = threadIdx.x; i < kLutWords; i += kThreads) s_lut[i] = lut_table[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long gr = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gr >= n) return;  // warp-uniform

  float4 v[kRounds];
  const float4* row = mag + gr * kQuads;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int k = lane + 32 * r;
    // a missing fifth quad reads as zeros: they quantize to 0, lie past
    // every bound, and so add nothing
    v[r] = k < kQuads ? row[k] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int g0 = gstart[gr];
  const bool long_gr = is_long[gr] != 0;
  const int b0_short = b0_switch != nullptr ? b0_switch[gr] : 36;
  const float cap_half = kLinbits ? 8206.5f : 15.5f;

  int my_bits = 0;
  for (int a = 0; a < kGains; ++a) {
    const float inv = s_inv[min(max(g0 + 4 * a, 0), 255)];
    int q[kRounds][4];
    int last0 = 0;  // 1 + the lane's last line with q > 0
    int last1 = 0;  // ... with q > 1
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      q[r][0] = quantize(v[r].x, inv, cap_half);
      q[r][1] = quantize(v[r].y, inv, cap_half);
      q[r][2] = quantize(v[r].z, inv, cap_half);
      q[r][3] = quantize(v[r].w, inv, cap_half);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int line1 = 4 * (lane + 32 * r) + e + 1;
        if (q[r][e] > 0) last0 = line1;
        if (kCount1 && q[r][e] > 1) last1 = line1;
      }
    }
    const int l0c = __reduce_max_sync(kFull, last0);
    int bv2;
    int n1 = 0;
    if (kCount1) {
      const int c1c = __reduce_max_sync(kFull, last1);
      bv2 = min((c1c + 1) & ~1, kLines);
      n1 = (max(l0c - bv2, 0) + 3) >> 2;
      if (bv2 + 4 * n1 > kLines) bv2 += 2;
      n1 = (max(l0c - bv2, 0) + 3) >> 2;
    } else {
      bv2 = min((l0c + 1) & ~1, kLines);
    }
    const int bounds = s_lut[kLutRegion + (bv2 >> 1)];
    const int b0 = long_gr ? (bounds & 0xffff) : b0_short;
    const int b1 = long_gr ? (bounds >> 16) : kLines;

    int tid0 = 15, tid1 = 15, tid2 = 15;
    if (kSelect) {
      int m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = 4 * (lane + 32 * r) + 2 * h;
          const int m = pos < bv2 ? max(q[r][2 * h], q[r][2 * h + 1]) : 0;
          if (pos < b0) {
            m0 = max(m0, m);
          } else if (pos < b1) {
            m1 = max(m1, m);
          } else {
            m2 = max(m2, m);
          }
        }
      }
      tid0 = table_for_max<kLinbits>(__reduce_max_sync(kFull, m0), s_lut);
      tid1 = table_for_max<kLinbits>(__reduce_max_sync(kFull, m1), s_lut);
      tid2 = long_gr ? table_for_max<kLinbits>(__reduce_max_sync(kFull, m2), s_lut) : 0;
    }

    int pair_bits = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = 4 * (lane + 32 * r) + 2 * h;
        const int tid = pos < b0 ? tid0 : (pos < b1 ? tid1 : tid2);
        const int x = kLinbits ? min(q[r][2 * h], 15) : q[r][2 * h];
        const int y = kLinbits ? min(q[r][2 * h + 1], 15) : q[r][2 * h + 1];
        const int cost = s_cost[tid * 256 + x * 16 + y];
        pair_bits += pos < bv2 ? cost : 0;
      }
    }
    int total = __reduce_add_sync(kFull, pair_bits);

    if (kCount1) {
      const bool use2 = (bv2 & 2) != 0;
      const int end = bv2 + 4 * n1;
      int nib[kRounds];  // the lane's quads' flags, first line in bit 3
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
        nib[r] = (q[r][0] > 0) << 3 | (q[r][1] > 0) << 2 | (q[r][2] > 0) << 1 | (q[r][3] > 0);
      int bits_a = 0;
      int bits_b = 0;
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int k = lane + 32 * r;
        int patt = nib[r];
        if (use2) {  // warp-uniform: every lane takes part in the shuffles
          int next = __shfl_down_sync(kFull, nib[r], 1);
          if (r + 1 < kRounds) {
            const int wrap = __shfl_sync(kFull, nib[r + 1], 0);
            if (lane == 31) next = wrap;
          }
          patt = k < kQuads - 1 ? ((nib[r] & 3) << 2) | (next >> 2) : 0;
        }
        const int start = 4 * k + (use2 ? 2 : 0);
        const bool counted = start >= bv2 && start < end;
        const int signs = __popc(patt);
        bits_a += counted ? s_lut[kLutCount1Len + patt] + signs : 0;
        bits_b += counted ? 4 + signs : 0;
      }
      total += min(__reduce_add_sync(kFull, bits_a), __reduce_add_sync(kFull, bits_b));
    }
    if (lane == a) my_bits = total;
  }
  if (lane < kGains)
    bits_out[gr * kGains + lane] = my_bits + (part2 != nullptr ? part2[gr] : 0);
}

template <bool kCount1, bool kSelect, bool kLinbits>
cudaError_t launch(const void* mag, const void* gstart, const void* is_long,
                   const void* b0_switch, const void* part2, const void* inv_table,
                   const void* cost_table, const void* lut, void* bits, long long n,
                   cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  strict_sweep_kernel<kCount1, kSelect, kLinbits><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(mag), static_cast<const int*>(gstart),
      static_cast<const unsigned char*>(is_long), static_cast<const int*>(b0_switch),
      static_cast<const int*>(part2), static_cast<const float*>(inv_table),
      static_cast<const unsigned char*>(cost_table), static_cast<const int*>(lut),
      static_cast<int*>(bits), n);
  return cudaGetLastError();
}

template <bool kCount1, bool kSelect>
cudaError_t launch_linbits(int linbits, const void* mag, const void* gstart,
                           const void* is_long, const void* b0_switch, const void* part2,
                           const void* inv_table, const void* cost_table, const void* lut,
                           void* bits, long long n, cudaStream_t stream) {
  return linbits ? launch<kCount1, kSelect, true>(mag, gstart, is_long, b0_switch, part2,
                                                  inv_table, cost_table, lut, bits, n, stream)
                 : launch<kCount1, kSelect, false>(mag, gstart, is_long, b0_switch, part2,
                                                   inv_table, cost_table, lut, bits, n, stream);
}

}  // namespace

// b0_switch and part2 may be null (36; nothing added). The options pick one
// of eight instantiations.
extern "C" int swm_strict_sweep(const void* mag, const void* gstart, const void* is_long,
                                const void* b0_switch, const void* part2,
                                const void* inv_table, const void* cost_table,
                                const void* lut, void* bits, long long n, int count1_coding,
                                int region_table_select, int linbits, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (count1_coding) {
    err = region_table_select
              ? launch_linbits<true, true>(linbits, mag, gstart, is_long, b0_switch, part2,
                                           inv_table, cost_table, lut, bits, n, s)
              : launch_linbits<true, false>(linbits, mag, gstart, is_long, b0_switch, part2,
                                            inv_table, cost_table, lut, bits, n, s);
  } else {
    err = region_table_select
              ? launch_linbits<false, true>(linbits, mag, gstart, is_long, b0_switch, part2,
                                            inv_table, cost_table, lut, bits, n, s)
              : launch_linbits<false, false>(linbits, mag, gstart, is_long, b0_switch, part2,
                                             inv_table, cost_table, lut, bits, n, s);
  }
  return (int)err;
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K2 on Hopper: the main_data pack.
//
// Replaces swiftmp3_tpu/ops/pallas_kernels.py:pack_pallas (the Pallas
// _pack_kernel, which scatters through one-hot MXU matmuls). Per frame: the
// exclusive prefix sum of nbits gives each slot's bit offset O; each chunk of
// <= 15 bits lands MSB-first at O and spans <= 3 bytes (O & 7 <= 7,
// 7 + 15 < 24). Bits of different slots are disjoint, so OR equals SUM. The
// result is the frame's byte image, truncated at cap, and total_bits.
//
// What bounds it on this card: bytes. A frame reads 2 x P int32 (9 KB at the
// main path's P = 1152) and writes cap bytes (894); the work per slot is a
// few integer operations and at most three shared-memory atomics.
//
// Design: one block per frame. Each thread takes a run of consecutive slots,
// sums their lengths, and a CUB BlockScan gives the run's starting offset
// and the frame's total. The image lives in shared memory as ceil(cap/4)
// 32-bit words; each slot builds its window chunk << (24 - (O & 7) - nbits)
// and atomicOr's its nonzero bytes into byte O>>3, +1, +2 (byte b at shift
// 8*(b & 3) of word b>>2, so the words hold the bytes in memory order).
// Bytes at or past cap are dropped, which is the truncation of the TPU
// kernel. No one-hot products: the scatter is the atomics.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int* __restrict__ chunks, const int* __restrict__ nbits,
            unsigned char* __restrict__ out, int* __restrict__ total_bits, int P,
            int cap) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_storage;
  extern __shared__ unsigned int image[];  // ceil(cap / 4) words

  const long long f = blockIdx.x;
  const int* crow = chunks + f * P;
  const int* nrow = nbits + f * P;

  const int words = (cap + 3) / 4;
  for (int i = threadIdx.x; i < words; i += kThreads) image[i] = 0u;

  const int per = (P + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * per, P);
  const int hi = min(lo + per, P);
  int run = 0;
  for (int p = lo; p < hi; ++p) run += nrow[p];
  int offset = 0;
  int total = 0;
  Scan(scan_storage).ExclusiveSum(run, offset, total);
  __syncthreads();  // the zeroed image is visible before any atomicOr

  for (int p = lo; p < hi; ++p) {
    const int nb = nrow[p];
    if (nb > 0) {
      const unsigned int win = (unsigned int)crow[p] << (24 - (offset & 7) - nb);
      const int b = offset >> 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const unsigned int byte = (win >> (16 - 8 * k)) & 0xFFu;
        const int idx = b + k;
        if (byte != 0u && idx < cap) atomicOr(&image[idx >> 2], byte << (8 * (idx & 3)));
      }
    }
    offset += nb;
  }
  __syncthreads();

  unsigned char* orow = out + f * cap;
  for (int i = threadIdx.x; i < cap; i += kThreads)
    orow[i] = (unsigned char)(image[i >> 2] >> (8 * (i & 3)));
  if (threadIdx.x == 0) total_bits[f] = total;
}

}  // namespace

extern "C" int swm_pack(const void* chunks, const void* nbits, void* out,
                        void* total_bits, int F, int P, int cap, void* stream) {
  if (F <= 0) return 0;
  const size_t smem = sizeof(unsigned int) * (size_t)((cap + 3) / 4);
  pack_kernel<<<F, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(chunks), static_cast<const int*>(nbits),
      static_cast<unsigned char*>(out), static_cast<int*>(total_bits), P, cap);
  return (int)cudaGetLastError();
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

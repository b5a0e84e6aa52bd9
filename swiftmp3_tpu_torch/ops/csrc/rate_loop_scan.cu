// K4 on Hopper: the chunk program's integer scans over T.
//
// Replaces no Pallas kernel. The reference runs this part of the chunk
// program, its Phase 2, as a lax.scan (swiftmp3_tpu/models/pipeline.py,
// "Phase 2: integer loop over T"), which XLA compiles into one loop on the
// TPU. Eagerly in PyTorch the same loop is ~60 small ops over [B] rows a
// frame: 7,689 launches a 128-frame compat chunk, which the card waits on.
// Two entry points, the two loops:
//  - swm_rate_loop_scan, the selection loop: each frame's bitrate (CBR, the
//    energy VBR law or demand VBR), padding and slot, the reservoir budget
//    (the 9/10 draw, the aligned expressibility cap, the linbits clamp, the
//    demand_budget donation law), the candidate of each granule (the first
//    evaluated in-budget fit, else the last evaluated in-budget one) and the
//    reservoir mirror (compat, or aligned at depth 1 or deeper), the carry
//    frozen on invalid frames;
//  - swm_placement_scan, the strict path's second loop: main_data_begin and
//    the stream mirror on the actual bytes of the chosen frames.
//
// What bounds it on this card: the serial chain over T, not bytes. Frame
// t + 1 needs frame t's reservoir state; the bytes are small (~14 MB a
// 256-stream, 128-frame compat chunk, ~4 us at 3.35 TB/s). Design:
//  - one warp a stream (swm_rate_loop_scan) whose 32 lanes each hold the
//    whole scalar state, so no exchange is needed for it;
//  - what a frame reads that no state decides (its [G, 20] candidate bits
//    and evaluated flags, contiguous in the time-major layout, its budgets,
//    energies and demand) is loaded one frame ahead, while the frame before
//    computes;
//  - lane k holds candidate k of each granule: the first fit is the lowest
//    set bit of the ballot of fits, the last evaluated in-budget candidate
//    the highest of theirs, and the chosen bits come back by a shuffle;
//  - the energy history lives on lanes 0-9 (lane i, entry i): its shift by
//    G granules is one shuffle, and its sum takes the order torch.sum takes
//    over a row of ten on the card (energy_target), so the bitrates equal
//    the plain version's there bit for bit;
//  - strict's second loop carries two numbers a stream: one thread a
//    stream, the next frame's four inputs loaded ahead.
// Every output is an integer and equals the plain version's. The one float
// step, the energy law's mean and ratio, rounds each operation as PyTorch
// does (the build passes --fmad=false, and the intrinsics say it again).

#include <cuda_runtime.h>

extern "C" {

// kernels.py _ScanParams, field for field
struct SwmScanParams {
  int B;
  int T;
  int G;
  int K;
  int sample_rate;
  int slots_per_kbps;
  int side_size;
  int crc_size;
  int res_cap;
  int rate_law;
  int aligned;
  int deep;
  int linbits;
  int demand_budget;
  int cbr_index;
  int cbr_value;
  int base_kbps;
  int min_bitrate;
  int max_bitrate;
  int max_adjustment;
  int n_cands;
  int bitrates[16];
  int cands[16];
  int cand_slot_bits[16];
};

// kernels.py _ScanIo, field for field: [T, B, ...] time-major, contiguous
struct SwmScanIo {
  const int* bits;
  const unsigned char* evaluated;
  const int* k_budget;
  const float* granule_e;
  const unsigned char* final;
  const unsigned char* valid;
  const float* frame_e;
  const int* demand;
  const int* frame_demand;
  const int* stream_len_in;
  const int* avail_in;
  const int* pad_rem_in;
  const int* slot_fifo_in;
  const float* vbr_ehist_in;
  const int* vbr_count_in;
  int* br_idx;
  int* padding;
  int* mdb;
  int* slot;
  int* k_sel;
  unsigned char* has_fit;
  int* bits_sel;
  int* stream_len_out;
  int* avail_out;
  int* pad_rem_out;
  int* slot_fifo_out;
  float* vbr_ehist_out;
  int* vbr_count_out;
};

// kernels.py _PlacementIo, field for field
struct SwmPlacementIo {
  const int* hb;
  const int* slot;
  const unsigned char* final;
  const unsigned char* valid;
  const int* stream_len_in;
  const int* slot_fifo_in;
  int* mdb;
  int* stream_len_out;
  int* slot_fifo_out;
};

}  // extern "C"

namespace {

constexpr int kCandidates = 20;
constexpr int kMaxGranules = 4;
constexpr int kMaxDepth = 8;
constexpr int kMaxCands = 16;
constexpr int kTable = 16;
constexpr int kHistory = 10;
constexpr int kPart23Max = 4095;
constexpr int kWarps = 4;
constexpr int kPlacementThreads = 128;
constexpr unsigned int kAll = 0xffffffffu;
constexpr int kCbr = 0;
constexpr int kEnergy = 1;
constexpr int kDemand = 2;

// torch's // and % on int32 (divisor > 0): rounded toward minus infinity
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int b) { return a - floor_div(a, b) * b; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }
// torch.clamp on float32: NaN passes through
__device__ __forceinline__ float clamp_min_f(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int buffered(const int (&fifo)[kMaxDepth], int K) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < kMaxDepth; ++k)
    if (k < K) s += fifo[k];
  return s;
}

// the slot FIFO after a frame: the oldest slot out, this frame's in
__device__ __forceinline__ void shift_in(int (&fifo)[kMaxDepth], int K, int slot) {
#pragma unroll
  for (int k = 0; k < kMaxDepth; ++k) {
    if (k == K - 1)
      fifo[k] = slot;
    else if (k < K - 1)
      fifo[k] = fifo[min(k + 1, kMaxDepth - 1)];
  }
}

// main_data_begin and the stream mirror (before its clamp at 0) after a
// frame of hb bytes: the aligned reservoir, tail-aligned at depth 1 and
// front-aligned on the whole gap deeper; else the compat law
__device__ __forceinline__ void place(const SwmScanParams& p, int stream_len, int oldest,
                                      int gap, int hb, bool fin, int& mdb, int& sl) {
  if (p.aligned) {
    mdb = p.deep ? clampi(gap, 0, p.res_cap) : clampi(min(gap, hb), 0, p.res_cap);
    sl = stream_len + (gap - mdb) + hb - oldest;
  } else {
    mdb = fin ? 0 : min(stream_len, p.res_cap);
    sl = stream_len + hb - oldest;
  }
  sl = max(sl, 0);
}

// bitrate_index_device and bitrate_value_device: the table entry nearest to
// target, the earliest on ties (torch.argmin's)
__device__ __forceinline__ void nearest_bitrate(const SwmScanParams& p, int target, int& index,
                                                int& value) {
  index = 0;
  value = p.bitrates[0];
  int best = abs(p.bitrates[0] - target);
#pragma unroll
  for (int i = 1; i < kTable; ++i) {
    const int d = abs(p.bitrates[i] - target);
    if (d < best) {
      best = d;
      index = i;
      value = p.bitrates[i];
    }
  }
}

// The energy VBR law (dsp.vbr_choose_bitrate). torch.sum over a contiguous
// row of ten on the card (Reduce.cuh: eight lanes along the row) adds
// entries i and i + 8 on lanes 0 and 1, then the eight lanes by shuffles
// down by 4, 2 and 1: ((a0 + a4) + (a2 + a6)) + ((a1 + a5) + (a3 + a7)),
// the order read on an H100 with torch 2.11 (every other order differs on
// ~40% of rows). These shuffles take that order, with zeros on lanes 10-15
// (x + 0 is exact). Every lane calls it.
__device__ __forceinline__ int energy_target(const SwmScanParams& p, float energy, float hist,
                                             int count) {
  float s = hist;
  s = __fadd_rn(s, __shfl_down_sync(kAll, s, 8));
  s = __fadd_rn(s, __shfl_down_sync(kAll, s, 4));
  s = __fadd_rn(s, __shfl_down_sync(kAll, s, 2));
  s = __fadd_rn(s, __shfl_down_sync(kAll, s, 1));
  const float sum = __shfl_sync(kAll, s, 0);
  const float avg = count > 0 ? __fdiv_rn(sum, (float)max(count, 1)) : energy;
  const float ratio = clamp_f(__fdiv_rn(energy, clamp_min_f(avg, 1e-4f)), 0.5f, 2.0f);
  const int adjustment =
      (int)truncf(__fmul_rn(__fsub_rn(ratio, 1.0f), (float)p.max_adjustment));
  return max(min(p.base_kbps + adjustment, p.max_bitrate), p.min_bitrate);
}

// what a frame reads that no state decides, on one lane
struct Frame {
  int bits[kMaxGranules];  // lane k: candidate k's bits (lanes 20-31: 0)
  bool ev[kMaxGranules];   // lane k: candidate k evaluated (lanes 20-31: false)
  int k_budget[kMaxGranules];
  int demand[kMaxGranules];
  float gran_e;  // lanes 10 - G .. 9: the granule energy entering the history there
  float frame_e;
  int frame_demand;
  bool fin;
  bool val;
};

__device__ __forceinline__ void load_frame(const SwmScanParams& p, const SwmScanIo& io,
                                           long long row, int lane, Frame& f) {
  const long long gran = row * p.G;
#pragma unroll
  for (int g = 0; g < kMaxGranules; ++g) {
    f.bits[g] = 0;
    f.ev[g] = false;
    f.k_budget[g] = 0;
    f.demand[g] = 0;
    if (g < p.G) {
      if (lane < kCandidates) {
        const long long at = (gran + g) * kCandidates + lane;
        f.bits[g] = io.bits[at];
        f.ev[g] = io.evaluated[at] != 0;
      }
      f.k_budget[g] = io.k_budget[gran + g];
      if (p.demand_budget) f.demand[g] = io.demand[gran + g];
    }
  }
  const int first = kHistory - p.G;
  f.gran_e = (lane >= first && lane < kHistory) ? io.granule_e[gran + lane - first] : 0.0f;
  f.frame_e = p.rate_law == kEnergy ? io.frame_e[row] : 0.0f;
  f.frame_demand = p.rate_law == kDemand ? io.frame_demand[row] : 0;
  f.fin = io.final[row] != 0;
  f.val = io.valid[row] != 0;
}

__global__ void __launch_bounds__(32 * kWarps)
rate_loop_scan_kernel(const __grid_constant__ SwmScanParams p,
                      const __grid_constant__ SwmScanIo io) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= p.B) return;  // warp-uniform

  int stream_len = io.stream_len_in[b];
  int avail = io.avail_in[b];
  int pad_rem = io.pad_rem_in[b];
  int count = io.vbr_count_in[b];
  int fifo[kMaxDepth];
#pragma unroll
  for (int k = 0; k < kMaxDepth; ++k)
    fifo[k] = k < p.K ? io.slot_fifo_in[(long long)b * p.K + k] : 0;
  float hist = lane < kHistory ? io.vbr_ehist_in[(long long)b * kHistory + lane] : 0.0f;

  Frame cur, next;
  load_frame(p, io, b, lane, cur);
  for (int t = 0; t < p.T; ++t) {
    const long long row = (long long)t * p.B + b;
    if (t + 1 < p.T) load_frame(p, io, row + p.B, lane, next);

    // the bitrate
    int br_idx = p.cbr_index;
    int br_val = p.cbr_value;
    if (p.rate_law != kCbr) {
      int target = 0;
      if (p.rate_law == kDemand) {
        // the smallest candidate whose slot covers the demand, else the top
        bool found = false;
#pragma unroll
        for (int i = 0; i < kMaxCands; ++i) {
          if (i < p.n_cands && !found) {
            if (cur.frame_demand <= p.cand_slot_bits[i]) {
              target = p.cands[i];
              found = true;
            } else if (i == p.n_cands - 1) {
              target = p.cands[i];
            }
          }
        }
      } else {
        target = energy_target(p, cur.frame_e, hist, count);
      }
      nearest_bitrate(p, target, br_idx, br_val);
    }

    // padding and the slot
    const int numerator = p.slots_per_kbps * br_val * 1000;
    const int base_size = floor_div(numerator, p.sample_rate);
    const int pad_acc = pad_rem + floor_mod(numerator, p.sample_rate);
    const int padding = pad_acc >= p.sample_rate ? 1 : 0;
    const int next_pad_rem = pad_acc - padding * p.sample_rate;
    const int slot = base_size + padding - 4 - p.crc_size - p.side_size;

    // the reservoir budget
    const int gap = p.aligned ? buffered(fifo, p.K) - stream_len : 0;
    const int res_bits = cur.fin ? 0 : avail * 8;
    int usable = floor_div(res_bits * 9, 10);
    if (p.aligned) usable = min(usable, clampi(gap, 0, p.res_cap) * 8);
    const int total_bits = slot * 8 + usable;
    int per_granule = floor_div(total_bits, p.G);
    if (p.linbits) per_granule = min(per_granule, kPart23Max);
    int max_bits[kMaxGranules];
#pragma unroll
    for (int g = 0; g < kMaxGranules; ++g) max_bits[g] = per_granule;
    if (p.demand_budget) {
      // dsp.demand_budget_bits
      const int share = floor_div(total_bits, p.G);
      int pool = 0, need = 0, demand = 0;
#pragma unroll
      for (int g = 0; g < kMaxGranules; ++g) {
        if (g < p.G) {
          pool += max(share - cur.demand[g], 0);
          need += max(cur.demand[g] - share, 0);
          demand += cur.demand[g];
        }
      }
      const int take = min(pool, need);
      if (demand > 0) {
#pragma unroll
        for (int g = 0; g < kMaxGranules; ++g) {
          const int surplus = max(share - cur.demand[g], 0);
          const int deficit = max(cur.demand[g] - share, 0);
          const int prop = share - floor_div(surplus * take, max(pool, 1)) +
                           floor_div(take * deficit, max(need, 1));
          max_bits[g] = min(prop, kPart23Max);
        }
      }
    }

    // each granule's candidate (dsp.rate_loop_select)
    int frame_bits = 0;
    const long long gran = row * p.G;
#pragma unroll
    for (int g = 0; g < kMaxGranules; ++g) {
      if (g < p.G) {
        const bool open = cur.ev[g] && lane < cur.k_budget[g];
        const unsigned int fits = __ballot_sync(kAll, open && cur.bits[g] <= max_bits[g]);
        const unsigned int opens = __ballot_sync(kAll, open);
        // no fit: the last open candidate (-1 when none is open)
        const int k_sel = fits ? __ffs(fits) - 1 : 31 - __clz(opens);
        const int chosen = __shfl_sync(kAll, cur.bits[g], k_sel & 31);
        const int bits_sel = k_sel >= 0 ? chosen : 0;
        frame_bits += bits_sel;
        if (lane == g) {
          io.k_sel[gran + g] = k_sel;
          io.has_fit[gran + g] = fits != 0u;
          io.bits_sel[gran + g] = bits_sel;
        }
      }
    }
    const int hb = floor_div(frame_bits + 7, 8);

    // the reservoir mirror
    int mdb, sl;
    place(p, stream_len, fifo[0], gap, hb, cur.fin, mdb, sl);
    if (lane == 0) {
      io.br_idx[row] = br_idx;
      io.padding[row] = padding;
      io.mdb[row] = mdb;
      io.slot[row] = slot;
    }

    // the carry, frozen on invalid frames
    const float shifted = __shfl_down_sync(kAll, hist, p.G);
    if (cur.val) {
      stream_len = sl;
      avail = clampi(avail + slot - hb, 0, p.res_cap);
      pad_rem = next_pad_rem;
      shift_in(fifo, p.K, slot);
      if (lane < kHistory) hist = lane < kHistory - p.G ? shifted : cur.gran_e;
      count = min(count + p.G, kHistory);
    }
    if (t + 1 < p.T) cur = next;
  }

  if (lane == 0) {
    io.stream_len_out[b] = stream_len;
    io.avail_out[b] = avail;
    io.pad_rem_out[b] = pad_rem;
    io.vbr_count_out[b] = count;
#pragma unroll
    for (int k = 0; k < kMaxDepth; ++k)
      if (k < p.K) io.slot_fifo_out[(long long)b * p.K + k] = fifo[k];
  }
  if (lane < kHistory) io.vbr_ehist_out[(long long)b * kHistory + lane] = hist;
}

__global__ void __launch_bounds__(kPlacementThreads)
placement_scan_kernel(const __grid_constant__ SwmScanParams p,
                      const __grid_constant__ SwmPlacementIo io) {
  const int b = blockIdx.x * kPlacementThreads + threadIdx.x;
  if (b >= p.B) return;

  int stream_len = io.stream_len_in[b];
  int fifo[kMaxDepth];
#pragma unroll
  for (int k = 0; k < kMaxDepth; ++k)
    fifo[k] = k < p.K ? io.slot_fifo_in[(long long)b * p.K + k] : 0;

  int hb = io.hb[b], slot = io.slot[b];
  bool fin = io.final[b] != 0, val = io.valid[b] != 0;
  for (int t = 0; t < p.T; ++t) {
    const long long row = (long long)t * p.B + b;
    int hb_n = 0, slot_n = 0;
    bool fin_n = false, val_n = false;
    if (t + 1 < p.T) {
      hb_n = io.hb[row + p.B];
      slot_n = io.slot[row + p.B];
      fin_n = io.final[row + p.B] != 0;
      val_n = io.valid[row + p.B] != 0;
    }
    const int gap = p.aligned ? buffered(fifo, p.K) - stream_len : 0;
    int mdb, sl;
    place(p, stream_len, fifo[0], gap, hb, fin, mdb, sl);
    io.mdb[row] = mdb;
    if (val) {
      stream_len = sl;
      shift_in(fifo, p.K, slot);
    }
    hb = hb_n;
    slot = slot_n;
    fin = fin_n;
    val = val_n;
  }

  io.stream_len_out[b] = stream_len;
#pragma unroll
  for (int k = 0; k < kMaxDepth; ++k)
    if (k < p.K) io.slot_fifo_out[(long long)b * p.K + k] = fifo[k];
}

}  // namespace

extern "C" int swm_rate_loop_scan(const void* params, const void* io, void* stream) {
  const SwmScanParams& p = *static_cast<const SwmScanParams*>(params);
  if (p.B <= 0 || p.T <= 0) return 0;
  const int blocks = (p.B + kWarps - 1) / kWarps;
  rate_loop_scan_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      p, *static_cast<const SwmScanIo*>(io));
  return (int)cudaGetLastError();
}

extern "C" int swm_placement_scan(const void* params, const void* io, void* stream) {
  const SwmScanParams& p = *static_cast<const SwmScanParams*>(params);
  if (p.B <= 0 || p.T <= 0) return 0;
  const int blocks = (p.B + kPlacementThreads - 1) / kPlacementThreads;
  placement_scan_kernel<<<blocks, kPlacementThreads, 0, (cudaStream_t)stream>>>(
      p, *static_cast<const SwmPlacementIo*>(io));
  return (int)cudaGetLastError();
}

extern "C" const char* swm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

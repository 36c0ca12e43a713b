// The encoder's chunk-start recompute in one launch for B movies, for
// Hopper (sm_90a).
//
// Replaces the JAX encoder's `do_recompute` (iivision_tpu/encoder.py:539-554
// with `diff_bank` :351-398, XLA in the JAX package, not Pallas) for every
// colour model: the (16, 16) cost bases (window and mono) and the yiq
// model's per-position window costs, one instantiation each (template
// <bool kYiq>).  For the active bank of every movie it computes, per page
// offset o:
//   1. the modelled screen's masked lane: lane bank_lanes(bank)[o & 1] at
//      column c = o >> 1, straight from the bank bytes around it (DHGR: the
//      aux and main bytes of columns 2c-1 .. 2c+2 of the page row; HGR: the
//      main bytes), header and footer zero at the page edges;
//   2. the target lane, read from lanes_tgt[movie, frame] (the frame is an
//      index: no slice is copied);
//   3. both lanes' dot sequences: DHGR's 13-bit lane is its dots, HGR
//      values expand to 21 dots (hgr_to_dots);
//   4. the distance d:
//      - (16, 16) bases: each 4-dot window rotates by the lane's NTSC phase
//        into a colour code, then the diagonal Damerau-Levenshtein distance
//        (diag_dp.cuh) under the cost matrix in shared memory;
//      - yiq: the 7-dot windows w_j = (dots >> j) & 0x7F, j < 7 (DHGR) or
//        15 (HGR), and d = sum_j sub[lane, j, wa_j, wb_j] in int32 over the
//        (n_lanes, L, 128, 128) cost stack (1.8-1.9 MB, read through L2),
//        where `lane` is the screen lane's own index (ops/yiq.lane_subs);
//      zero at the screen holes (offsets whose low 7 bits are 120 or more);
//   5. up = (d == 0 ? 0 : up) + d and dw = d, in place in the int32
//      (B, n_banks, 32, 256) state.
// Exact int32 throughout, equal to the torch form (ops/chunk_start.py
// chunk_start_plain) bit for bit.
//
// Grid (32, B): one block per page of each movie, 256 threads, one per
// offset.  What bounds it: about 0.5 MB per DHGR movie (both banks' bytes,
// the target lanes, up and dw read and written), 0.15 us at 3.35 TB/s, so
// a launch is latency-bound: one dependent chain of L (10 or 18) DP steps
// per thread after the page's bytes are staged in shared memory, or 7-15
// independent L2 reads of the yiq costs.  The design's answer is the
// grain: this one launch replaces about 300 small torch ops (lane
// derivation, lane pixels or windows, the DP or the gather-sum,
// interleave, holes, the up/dw update).

#include <cstdint>
#include <cuda_runtime.h>

#include "diag_dp.cuh"

namespace {

constexpr int kOffsets = 256;
constexpr int kMaxDots = 18;  // HGR's MASKED_DOTS; DHGR has 10

// Each of bits 0..6 controls two dots; bit 6 spills a third dot (bit 14).
__device__ __forceinline__ int double_pixels(int x) {
  int dp = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int bit = (x >> k) & 1;
    dp |= (bit << (2 * k)) | (bit << (2 * k + 1));
  }
  return dp | (((x >> 6) & 1) << 14);
}

// HGR 14-bit masked value -> 21-bit dot sequence (screen.py hgr_to_dots).
__device__ __forceinline__ int hgr_to_dots(int mv, int byte_offset) {
  const int h = (mv & 0b111) << 5;
  const int hp = (h & 0x80) >> 7;
  int res = double_pixels(h & 0x7F) >> (11 - hp);
  int bp, body;
  if (byte_offset == 0) {
    const int b = (mv >> 3) & 0xFF;
    bp = (b & 0x80) >> 7;
    body = b & 0x7F;
  } else {
    bp = (mv >> 3) & 0x01;
    body = (mv >> 4) & 0x7F;
  }
  res &= ~(0x3FFF << (3 + bp));
  res ^= double_pixels(body) << (3 + bp);
  const int f = (mv >> 12) & 0b11;
  const int fp = (mv >> 11) & 0b01;
  res &= ~(0xF << (17 + fp));
  res ^= double_pixels(f) << (17 + fp);
  return res & 0x1FFFFF;
}

// DHGR masked lane `lane` at column c from the page's main / aux rows.
__device__ __forceinline__ int dhgr_lane_at(const int* main_s,
                                            const int* aux_s, int lane,
                                            int c) {
  const int c2 = 2 * c;
  const int a0 = aux_s[c2] & 0x7F, m0 = main_s[c2] & 0x7F;
  const int a1 = aux_s[c2 + 1] & 0x7F, m1 = main_s[c2 + 1] & 0x7F;
  switch (lane) {
    case 0: {
      const int hdr = c > 0 ? (main_s[c2 - 1] & 0x7F) >> 4 : 0;
      return hdr | (a0 << 3) | ((m0 & 0b111) << 10);
    }
    case 1:
      return (a0 >> 4) | (m0 << 3) | ((a1 & 0b111) << 10);
    case 2:
      return (m0 >> 4) | (a1 << 3) | ((m1 & 0b111) << 10);
    default: {
      const int ftr = c < 127 ? aux_s[c2 + 2] & 0b111 : 0;
      return (a1 >> 4) | (m1 << 3) | (ftr << 10);
    }
  }
}

// HGR masked lane `lane` at column c from the page's main row.
__device__ __forceinline__ int hgr_lane_at(const int* main_s, int lane,
                                           int c) {
  const int c2 = 2 * c;
  const int even = main_s[c2], odd = main_s[c2 + 1];
  const int prev_odd = c > 0 ? main_s[c2 - 1] : 0;
  const int next_even = c < 127 ? main_s[c2 + 2] : 0;
  const int hdr = ((prev_odd >> 5) & 0b011) | ((prev_odd >> 5) & 0b100);
  const int ftr = ((next_even >> 7) & 1) | ((next_even & 0b11) << 1);
  const int packed = hdr | (even << 3) | ((odd & 0x80) << 4) |
                     ((odd & 0x7F) << 12) | (ftr << 19);
  return (packed >> (8 * lane)) & 0x3FFF;
}

// A lane value's L colour codes: the 4-dot window at dot i, rotated left
// by the NTSC phase (phase + i) mod 4 (distance.lane_pixels).
__device__ __forceinline__ void lane_codes(int dots, int L, int phase,
                                           uint8_t* out) {
  for (int i = 0; i < L; ++i) {
    int w = (dots >> i) & 0xF;
    const int r = (phase + i) & 3;
    if (r) w = ((w << r) | (w >> (4 - r))) & 0xF;
    out[i] = static_cast<uint8_t>(w);
  }
}

// The yiq distance of two lanes' dot sequences: per-position window costs
// summed, sub the lane's (L, 128, 128) slice.
__device__ __forceinline__ int window_sums(int da, int db, int L,
                                           const int32_t* __restrict__ sub) {
  int d = 0;
  for (int j = 0; j < L; ++j)
    d += __ldg(sub + ((j * 128 + ((da >> j) & 0x7F)) << 7) +
               ((db >> j) & 0x7F));
  return d;
}

// sub: (16, 16) costs, or with kYiq the (n_lanes, L, 128, 128) stack.
template <bool kYiq>
__global__ void __launch_bounds__(kOffsets)
chunk_start_kernel(const int32_t* __restrict__ banks,      // (B, nb, 32, 256)
                   const int32_t* __restrict__ lanes_tgt,  // (B, F, 32, 128, nl)
                   int F, int frame, const int32_t* __restrict__ sub,
                   int dhgr, int bank, int32_t* __restrict__ up,
                   int32_t* __restrict__ dw) {
  __shared__ int sub_s[kYiq ? 1 : 256];
  __shared__ int main_s[kOffsets], aux_s[kOffsets];
  const int page = blockIdx.x, movie = blockIdx.y, t = threadIdx.x;
  const int n_banks = dhgr ? 2 : 1, n_lanes = dhgr ? 4 : 2;
  const size_t row0 = ((size_t)movie * n_banks * 32 + page) * kOffsets;
  if (!kYiq) sub_s[t] = sub[t];
  main_s[t] = banks[row0 + t];
  if (dhgr) aux_s[t] = banks[row0 + 32 * kOffsets + t];
  __syncthreads();

  const int c = t >> 1, odd = t & 1;
  // bank_lanes: DHGR main (1, 3), aux (0, 2); HGR (0, 1)
  const int lane = dhgr ? (bank ? 2 * odd : 1 + 2 * odd) : odd;
  const int cur = dhgr ? dhgr_lane_at(main_s, aux_s, lane, c)
                       : hgr_lane_at(main_s, lane, c);
  const int tgt = lanes_tgt[((((size_t)movie * F + frame) * 32 + page) * 128 +
                             c) * n_lanes + lane];
  const int da = dhgr ? cur : hgr_to_dots(cur, lane);
  const int db = dhgr ? tgt : hgr_to_dots(tgt, lane);
  int d;
  if (kYiq) {
    const int L = dhgr ? 7 : 15;  // 7-dot windows in 13 or 21 dots
    d = window_sums(da, db, L, sub + (size_t)lane * L * 128 * 128);
  } else {
    const int L = dhgr ? 10 : 18;
    // NTSC phase of each lane's first masked bit: DHGR (1, 0, 3, 2), HGR
    // (1, 3)
    const int phase = dhgr ? (lane == 0 ? 1 : lane == 1 ? 0 : lane == 2 ? 3 : 2)
                           : (lane == 0 ? 1 : 3);
    uint8_t a[kMaxDots], b[kMaxDots];
    lane_codes(da, L, phase, a);
    lane_codes(db, L, phase, b);
    d = diag_dp(a, 1, b, 1, L, sub_s);
  }
  if ((t & 127) >= 120) d = 0;  // screen hole: no screen byte here

  const size_t at = ((size_t)movie * n_banks + bank) * 32 * kOffsets +
                    (size_t)page * kOffsets + t;
  up[at] = (d == 0 ? 0 : up[at]) + d;
  dw[at] = d;
}

}  // namespace

extern "C" {

// banks, up, dw: (B, n_banks, 32, 256) int32 (n_banks 2 for DHGR, 1 for
// HGR); up and dw are updated in place at `bank`.  lanes_tgt: (B, F, 32,
// 128, n_lanes) int32, read at `frame`.  sub: (16, 16) int32 costs, or with
// yiq = 1 the (n_lanes, L, 128, 128) int32 window costs (L = 7 for DHGR,
// 15 for HGR).  Returns the launch's cudaError_t.
int iiv_chunk_start(const int32_t* banks, const int32_t* lanes_tgt, int B,
                    int F, int frame, const int32_t* sub, int yiq, int dhgr,
                    int bank, int32_t* up, int32_t* dw, void* stream) {
  if (B < 0 || B > 65535 || frame < 0 || frame >= F || bank < 0 ||
      bank > (dhgr ? 1 : 0))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid(32, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (yiq)
    chunk_start_kernel<true><<<grid, kOffsets, 0, s>>>(
        banks, lanes_tgt, F, frame, sub, dhgr, bank, up, dw);
  else
    chunk_start_kernel<false><<<grid, kOffsets, 0, s>>>(
        banks, lanes_tgt, F, frame, sub, dhgr, bank, up, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

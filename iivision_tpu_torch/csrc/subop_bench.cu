// Kernel C: the sub-op microbenchmark, T sequential sub-ops on every row,
// for Hopper (sm_90a), on the body kernel's warp-per-page sub-op.
//
// Replaces tools/bench_subop_pallas.py make_pallas.kernel (the Pallas TPU
// kernel that holds (B*K, 256) f32 state in VMEM for a fori_loop of T
// `_sub_op_math` steps).  The math is the encoder's sub-op with stand-ins:
// the nonce is a hash of (jj, offset), the cost row is by*0.5 + 1, the
// content is the float target value; there is no table, no nvalid and no
// record.  One sub-op:
//   1. real = any(up > 0), a warp vote;
//   2. primary offset = argmax(up*256 + nonce), first index on ties;
//   3. content = tb[primary];
//   4. three companion rounds: argmax of dw - cost over offsets that are
//      pending, improved by the store and not the primary; a round hits iff
//      that maximum is > 0, and the chosen offset drops out either way;
//   5. gated updates: the primary clears up and dw, companions take the
//      cost as their priority, stored cells take the content.
//
// The design is the body kernel's `run_slot` (body.cu): a warp per row,
// each lane holding 8 offsets (t = 32 i + lane) of up, dw, by and tb in
// registers for all T sub-ops; each argmax a local 8-way scan plus five
// butterfly shuffles, and the three companion rounds the body's own
// device code (warp_argmax.cuh), so this kernel times the instructions
// the encoder's sub-op runs.  No shared memory and no barrier: rows never
// interact, and the four rows of a block run one per warp, one warp per
// SM sub-partition.  The content is read from the owning lane's registers:
// every lane selects its register off0 >> 5 (uniform over the warp), then
// one shuffle from lane off0 & 31.
//
// What bounds it: memory is touched only at the start and the end (7 row
// arrays), and the operations are a few tens per offset and sub-op; the
// time is the dependent chain, T x four argmaxes one after another, each
// 8 compare-and-select steps and five shuffle exchanges deep.  The
// benchmark's 512 rows are 128 blocks on 132 SMs, so rows do not contend
// and a call takes as long as one row's chain: 0.96 us per sub-op on one
// H100 80GB HBM3 at 700 W, about 1,900 cycles, of which the instruction
// sequence accounts for about 1,030 at 4 cycles per dependent ALU
// operation and 24 per shuffle (chip_smoke.py SUBOP_CHAIN_CYCLES).
//
// Exactness: every rounding float op is explicit (__fmul_rn / __fadd_rn /
// __fsub_rn), as XLA evaluates them one at a time; the hash is computed in
// uint32, whose low 16 bits equal those of JAX's wrapping int32; the scale
// is the double 255/65535 rounded to float once, as a Python float reaches
// JAX.  The gated updates of the JAX form (up * (1 - umask) + ...) are
// selects here, which give the same bits for state that stays >= 0.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_argmax.cuh"

namespace {

constexpr int kOffsets = 256;
constexpr int kRowsPerBlock = 4;  // one warp each

__global__ void __launch_bounds__(kRowsPerBlock * 32)
subop_bench_kernel(const float* __restrict__ up_in,
                   const float* __restrict__ dw_in,
                   const float* __restrict__ by_in,
                   const float* __restrict__ tb_in, int R, int T,
                   float* __restrict__ up_out, float* __restrict__ dw_out,
                   float* __restrict__ by_out) {
  constexpr float kNonceScale = static_cast<float>(255.0 / 65535.0);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // a whole warp: the kernel has no block barrier
  const size_t at = (size_t)row * kOffsets + lane;
  float upv[kPerLane], dwv[kPerLane], byv[kPerLane], tbv[kPerLane];
  uint32_t hash_o[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    upv[i] = up_in[at + i * 32];
    dwv[i] = dw_in[at + i * 32];
    byv[i] = by_in[at + i * 32];
    tbv[i] = tb_in[at + i * 32];
    hash_o[i] = static_cast<uint32_t>(i * 32 + lane) * 40503u;
  }

  for (int jj = 0; jj < T; ++jj) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) any |= upv[i] > 0.f;
    const bool real = __any_sync(kFull, any);

    // primary offset: argmax of up*256 + nonce
    const uint32_t hash_j = static_cast<uint32_t>(jj) * 507279793u;
    float bv = -FLT_MAX;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const uint32_t h = (hash_j + hash_o[i]) & 0xffffu;
      const float nonce = __fmul_rn(static_cast<float>(h), kNonceScale);
      const float v = __fadd_rn(__fmul_rn(upv[i], 256.f), nonce);
      if (v > bv) {  // offsets ascend: keeps the first maximal one
        bv = v;
        bi = i * 32 + lane;
      }
    }
    warp_argmax(bv, bi);
    const int off0 = bi;
    // content = tb[off0]: the owning lane's register off0 >> 5
    float mine = tbv[0];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i)
      if ((off0 >> 5) == i) mine = tbv[i];
    const float content = __shfl_sync(kFull, mine, off0 & 31);

    // companions: pending offsets the store improves, three rounds
    float scv[kPerLane], sl[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      scv[i] = __fadd_rn(__fmul_rn(byv[i], 0.5f), 1.f);
      const float score = __fsub_rn(dwv[i], scv[i]);
      sl[i] = (upv[i] > 0.f && score > 0.f && i * 32 + lane != off0) ? score
                                                                    : -1.f;
    }
    int offs[3];
    const unsigned comp = companion_rounds(sl, off0, lane, offs);

    if (real) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        if (i * 32 + lane == off0) {
          upv[i] = 0.f;
          dwv[i] = 0.f;
          byv[i] = content;
        } else if ((comp >> i) & 1u) {
          upv[i] = scv[i];
          byv[i] = content;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    up_out[at + i * 32] = upv[i];
    dw_out[at + i * 32] = dwv[i];
    by_out[at + i * 32] = byv[i];
  }
}

}  // namespace

extern "C" {

// Kernel C: T sub-ops of the microbenchmark on each of R rows.  up, dw, by,
// tb: (R, 256) float32 inputs; up_out, dw_out, by_out: (R, 256) float32
// outputs (the inputs are not written).  Returns the launch's cudaError_t.
int iiv_subop_bench(const float* up, const float* dw, const float* by,
                    const float* tb, int R, int T, float* up_out,
                    float* dw_out, float* by_out, void* stream) {
  if (R < 0 || T < 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  subop_bench_kernel<<<blocks, kRowsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      up, dw, by, tb, R, T, up_out, dw_out, by_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Kernels B and C, for Hopper (sm_90a).
//
// Kernel B: the encoder's sequential sub-op chain on the k selected pages.
// It computes iivision_tpu/encoder.py `sub_op` (the j sequential op
// selections of one scan step on the extracted page rows), which the JAX
// package runs as XLA ops inside its scan, not as a Pallas kernel.  Kernel C
// (below) is the sub-op microbenchmark's kernel, with its own stand-in math.
//
// One block per selected page, 256 threads: thread t owns page offset t.
// The page's up / dw / by / tb rows are staged in shared memory for the
// whole chain.  For each of the j sub-ops:
//   1. has_work = any(up > 0); the op is real iff has_work and its slot
//      jj*k + page_slot < nvalid (padding ops are emitted, never applied);
//   2. primary offset = argmax(up*256 + nonce*255), first index on ties;
//      the products and the sum are rounded separately (__fmul_rn /
//      __fadd_rn), never contracted into an FMA: priorities pass 2^16, so
//      the sum rounds and an FMA would round differently;
//   3. content = tb[primary] (raw byte; only the cost lookup masks it with
//      C-1);
//   4. the store-cost row: thread t reads table[row_t * C + (content & (C-1))]
//      straight from the int16 table (8 MB for DHGR, resident in the 50 MB
//      L2), where row_t = lane*R + target lane value for its offset;
//   5. three companion rounds: argmax of (dw - cost) over offsets that are
//      pending, improved by the store and not the primary; a round hits iff
//      that maximum is > 0, and the chosen offset drops out either way;
//   6. gated updates: the primary clears up and dw, companions take the
//      store's residual cost as their priority, stored cells take the
//      content byte.
// It writes one (page, content, o0, o1, o2, o3) uint8 record per sub-op,
// (j, k, 6) sub-op-major, and the updated rows in place.
//
// What bounds it: per sub-op, four block-wide argmax reductions over 256
// values (warp shuffles, then one pass through shared memory) and one
// scattered 2-byte load per thread.  Work per launch is tiny (k blocks), so
// the launch itself dominates; keeping the j sub-ops inside one launch is
// this design's answer, and whole-step or whole-movie residency is the
// next.  The nonces are inputs: no random numbers are drawn here.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOffsets = 256;  // page offsets = threads per block
constexpr int kWarps = kOffsets / 32;

// (value, index) pair is better if larger, or equal with a lower index:
// the first maximal index, as jnp.argmax returns it.
__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Block-wide argmax of one value per thread; every thread gets the result.
// red_v / red_i hold kWarps + 1 entries.
__device__ __forceinline__ int block_argmax(float v, float* best,
                                            float* red_v, int* red_i) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int i = t;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red_v[lane] : -FLT_MAX;
    i = lane < kWarps ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, i, off);
      if (better(v2, i2, v, i)) {
        v = v2;
        i = i2;
      }
    }
    if (lane == 0) {
      red_v[kWarps] = v;
      red_i[kWarps] = i;
    }
  }
  __syncthreads();
  *best = red_v[kWarps];
  return red_i[kWarps];
}

__global__ void __launch_bounds__(kOffsets)
subop_chain_kernel(float* __restrict__ rows,             // (k, 4, 256)
                   const int32_t* __restrict__ sc_rows,  // (k, 256)
                   const int16_t* __restrict__ table,    // (*, C)
                   int C, const float* __restrict__ nonce,  // (j, k, 256)
                   const int64_t* __restrict__ pages, int k, int j,
                   int nvalid, int pad_content,
                   uint8_t* __restrict__ recs) {  // (j, k, 6)
  __shared__ float up_s[kOffsets], dw_s[kOffsets], by_s[kOffsets],
      tb_s[kOffsets];
  __shared__ float red_v[kWarps + 1];
  __shared__ int red_i[kWarps + 1];
  const int slot = blockIdx.x, t = threadIdx.x;
  float* row = rows + (size_t)slot * 4 * kOffsets;
  up_s[t] = row[t];
  dw_s[t] = row[kOffsets + t];
  by_s[t] = row[2 * kOffsets + t];
  tb_s[t] = row[3 * kOffsets + t];
  const size_t sc_base = (size_t)sc_rows[(size_t)slot * kOffsets + t] * C;
  const int page = static_cast<int>(pages[slot]);
  __syncthreads();

  for (int jj = 0; jj < j; ++jj) {
    const float up = up_s[t];
    const bool has_work = __syncthreads_or(up > 0.f) != 0;
    const bool real = has_work && (jj * k + slot < nvalid);

    const float nz =
        nonce != nullptr ? nonce[((size_t)jj * k + slot) * kOffsets + t] : 0.f;
    const float score0 = __fadd_rn(__fmul_rn(up, 256.f), __fmul_rn(nz, 255.f));
    float best;
    const int off0 = block_argmax(score0, &best, red_v, red_i);
    const int content = static_cast<int>(tb_s[off0]);

    const float sc = static_cast<float>(table[sc_base + (content & (C - 1))]);
    const float score = __fsub_rn(dw_s[t], sc);
    float sl = (up > 0.f && score > 0.f && t != off0) ? score : -1.f;
    int offs[3];
    bool companion = false;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int o = block_argmax(sl, &best, red_v, red_i);
      const bool hit = best > 0.f;
      offs[r] = hit ? o : off0;
      if (t == o) {
        // a later round can pick a hit offset again (every sl at -1 sends
        // argmax to offset 0): it stays a companion
        companion = companion || hit;
        sl = -1.f;
      }
    }

    if (real) {
      if (t == off0) {
        up_s[t] = 0.f;
        dw_s[t] = 0.f;
        by_s[t] = static_cast<float>(content);
      } else if (companion) {
        up_s[t] = sc;
        by_s[t] = static_cast<float>(content);
      }
    }
    if (t == 0) {
      uint8_t* rec = recs + ((size_t)jj * k + slot) * 6;
      rec[0] = static_cast<uint8_t>(real ? page + 32 : 32);
      rec[1] = static_cast<uint8_t>(real ? content : pad_content);
      rec[2] = static_cast<uint8_t>(real ? off0 : 0);
      rec[3] = static_cast<uint8_t>(real ? offs[0] : 0);
      rec[4] = static_cast<uint8_t>(real ? offs[1] : 0);
      rec[5] = static_cast<uint8_t>(real ? offs[2] : 0);
    }
    // each thread only reads back its own up/dw/by entries, and the next
    // sub-op's first block-wide step (__syncthreads_or) orders the rest
  }
  row[t] = up_s[t];
  row[kOffsets + t] = dw_s[t];
  row[2 * kOffsets + t] = by_s[t];
}

// Kernel C: the sub-op microbenchmark, T sequential sub-ops on every row.
//
// Replaces tools/bench_subop_pallas.py make_pallas.kernel (the Pallas TPU
// kernel that holds (B*K, 256) f32 state in VMEM for a fori_loop of T
// `_sub_op_math` steps).  The math differs from kernel B's: the nonce is a
// hash of (jj, offset), the cost row is the stand-in by*0.5 + 1, content is
// the float target value, there is no table, no nvalid and no record.
//
// One block per row, 256 threads: thread t owns offset t and keeps its up,
// dw and by in registers for all T sub-ops; only tb is in shared memory,
// for the content read at the primary offset.  Rows never interact, so the
// T loop runs inside one launch with no grid-wide sync.  What bounds it: a
// sub-op is four dependent block-wide argmaxes (warp shuffles and two
// barriers each), about a microsecond of latency, while the 512 blocks of
// the benchmark's shape fill the card's 132 SMs about four deep; memory is
// touched only at the start and the end.
//
// Exactness: every rounding float op is explicit (__fmul_rn / __fadd_rn /
// __fsub_rn), as XLA evaluates them one at a time; the hash is computed in
// uint32, whose low 16 bits equal those of JAX's wrapping int32; the scale
// is the double 255/65535 rounded to float once, as a Python float reaches
// JAX.  The gated updates of the JAX form (up * (1 - umask) + ...) are
// selects here, which give the same bits for state that stays >= 0.
__global__ void __launch_bounds__(kOffsets)
subop_bench_kernel(const float* __restrict__ up_in,
                   const float* __restrict__ dw_in,
                   const float* __restrict__ by_in,
                   const float* __restrict__ tb_in, int T,
                   float* __restrict__ up_out, float* __restrict__ dw_out,
                   float* __restrict__ by_out) {
  constexpr float kNonceScale = static_cast<float>(255.0 / 65535.0);
  __shared__ float tb_s[kOffsets];
  __shared__ float red_v[kWarps + 1];
  __shared__ int red_i[kWarps + 1];
  const int t = threadIdx.x;
  const size_t at = (size_t)blockIdx.x * kOffsets + t;
  float up = up_in[at], dw = dw_in[at], by = by_in[at];
  tb_s[t] = tb_in[at];
  const uint32_t hash_t = static_cast<uint32_t>(t) * 40503u;
  __syncthreads();

  for (int jj = 0; jj < T; ++jj) {
    const bool real = __syncthreads_or(up > 0.f) != 0;
    const uint32_t h =
        (static_cast<uint32_t>(jj) * 507279793u + hash_t) & 0xffffu;
    const float nonce = __fmul_rn(static_cast<float>(h), kNonceScale);
    const float score0 = __fadd_rn(__fmul_rn(up, 256.f), nonce);
    float best;
    const int off0 = block_argmax(score0, &best, red_v, red_i);
    const float content = tb_s[off0];

    const float sc = __fadd_rn(__fmul_rn(by, 0.5f), 1.f);
    const float score = __fsub_rn(dw, sc);
    float sl = (up > 0.f && score > 0.f && t != off0) ? score : -1.f;
    bool companion = false;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int o = block_argmax(sl, &best, red_v, red_i);
      if (t == o) {
        // a later round can pick a hit offset again (every sl at -1 sends
        // argmax to offset 0): it stays a companion
        companion = companion || best > 0.f;
        sl = -1.f;
      }
    }
    if (real) {
      if (t == off0) {
        up = 0.f;
        dw = 0.f;
        by = content;
      } else if (companion) {
        up = sc;
        by = content;
      }
    }
  }
  up_out[at] = up;
  dw_out[at] = dw;
  by_out[at] = by;
}

}  // namespace

extern "C" {

// rows: (k, 4, 256) float32 [up, dw, by, tb] of the selected pages, updated
// in place (tb is read only); sc_rows: (k, 256) int32 store-cost table row
// per offset; table: int16 (*, C); nonce: (j, k, 256) float32 or NULL for
// the deterministic encoder; pages: (k,) int64; recs: (j, k, 6) uint8.
// Returns the launch's cudaError_t.
int iiv_subop_chain(float* rows, const int32_t* sc_rows, const int16_t* table,
                    int C, const float* nonce, const int64_t* pages, int k,
                    int j, int nvalid, int pad_content, uint8_t* recs,
                    void* stream) {
  if (k < 1 || j < 1 || C < 1 || (C & (C - 1)) != 0)
    return cudaErrorInvalidValue;
  subop_chain_kernel<<<k, kOffsets, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, sc_rows, table, C, nonce, pages, k, j, nvalid, pad_content, recs);
  return static_cast<int>(cudaGetLastError());
}

// Kernel C: T sub-ops of the microbenchmark on each of R rows.  up, dw, by,
// tb: (R, 256) float32 inputs; up_out, dw_out, by_out: (R, 256) float32
// outputs (the inputs are not written).  Returns the launch's cudaError_t.
int iiv_subop_bench(const float* up, const float* dw, const float* by,
                    const float* tb, int R, int T, float* up_out,
                    float* dw_out, float* by_out, void* stream) {
  if (R < 0 || T < 0) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  subop_bench_kernel<<<R, kOffsets, 0, static_cast<cudaStream_t>(stream)>>>(
      up, dw, by, tb, T, up_out, dw_out, by_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Kernel B: the encoder's sequential sub-op chain on the k selected pages,
// for Hopper (sm_90a).
//
// Computes iivision_tpu/encoder.py `sub_op` (the j sequential op selections
// of one scan step on the extracted page rows), which
// tools/bench_subop_pallas.py (make_pallas.kernel) prototyped as a Pallas
// TPU kernel with a stand-in cost row; here the cost row is the real one.
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
        companion = hit;
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

}  // extern "C"

// Kernels B and C, for Hopper (sm_90a).
//
// Kernel B: the encoder's sequential sub-op chain on the k selected pages of
// each of B movies.  It computes iivision_tpu/encoder.py `sub_op` (the j
// sequential op selections of one scan step on the extracted page rows),
// which the JAX package runs as XLA ops inside its scan (batched over movies
// with vmap), not as a Pallas kernel.  Kernel C (below) is the sub-op
// microbenchmark's kernel, with its own stand-in math.
//
// Grid (k, B): one block per selected page of each movie, 256 threads:
// thread t owns page offset t.  The movies share one plan, so the store-cost
// table and nvalid are shared; pages, rows, nonces and the padding byte are
// per movie.  The page's up / dw / by / tb rows are staged in shared memory
// for the whole chain.  For each of the j sub-ops:
//   1. has_work = any(up > 0); the op is real iff has_work and its slot
//      jj*k + page_slot < nvalid (padding ops are emitted, never applied);
//   2. primary offset = argmax(up*256 + nonce*255), first index on ties;
//      the products and the sum are rounded separately (__fmul_rn /
//      __fadd_rn), never contracted into an FMA: priorities pass 2^16, so
//      the sum rounds and an FMA would round differently;
//   3. content: the default rule takes tb[primary] (the raw byte; only the
//      cost lookup masks it with C-1).  The joint variant (encoder.py
//      :583-610, --joint_content) scores every content c as
//        prim[c] = dw[off0] - cost(off0, c)
//        comp[c] = sum of the 3 largest max(dw[t] - cost(t, c), 0) over
//                  offsets t != off0 with up[t] > 0
//      and takes argmax_c(prim + comp), first index on ties.  Every term is
//      an integer below 2^18, exact in float32, so the top three may be
//      found in any order: warp w takes 32 contents (c = 32*g + lane) over a
//      1/P share of the offsets, each lane keeping its top three in
//      registers; the table reads cost(t, c) = table[row(t)*C + c] are
//      contiguous over the warp's lanes.  The P partial triples per content
//      meet in shared memory, then one block argmax over C picks the byte;
//   4. the store-cost row: thread t reads table[row_t * C + (content & (C-1))]
//      straight from the int16 table (8 MB for DHGR, resident in the 50 MB
//      L2), where row_t = lane*R + target lane value for its offset;
//   5. three companion rounds: argmax of (dw - cost) over offsets that are
//      pending, improved by the store and not the primary; a round hits iff
//      that maximum is > 0, and the chosen offset drops out either way;
//   6. gated updates: the primary clears up and dw (the joint variant keeps
//      its residual there instead: up = dw = cost(off0), since it may store a
//      non-target byte, encoder.py:663-676), companions take the store's
//      residual cost as their priority, stored cells take the content byte.
// It writes one (page, content, o0, o1, o2, o3) uint8 record per sub-op,
// (B, j, k, 6) sub-op-major within a movie, and the updated rows in place.
//
// What bounds it: per sub-op, four block-wide argmax reductions over 256
// values (warp shuffles, then one pass through shared memory) and one
// scattered 2-byte load per thread; the joint variant adds 256*C coalesced
// 2-byte table reads and one more argmax.  Work per launch is k*B blocks:
// at B = 1 the launch itself dominates; a batch fills the card with the
// same launch count.  Keeping the j sub-ops inside one launch is this
// design's answer, and whole-step or whole-movie residency is the next.
// The nonces are inputs: no random numbers are drawn here.

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

// Keep the three largest values seen (a >= b >= c; all start at 0, so only
// positive values enter, as the JAX form's where(score > 0, score, 0)).
__device__ __forceinline__ void top3_insert(float v, float& a, float& b,
                                            float& c) {
  if (v > c) {
    if (v > b) {
      c = b;
      if (v > a) {
        b = a;
        a = v;
      } else {
        b = v;
      }
    } else {
      c = v;
    }
  }
}

// Joint content of one sub-op (step 3 above).  Every thread of the block
// calls it and gets the chosen content.  base_s[t] = row(t) * C; tri_s
// holds kWarps * 32 * 3 floats, score_s C floats.
__device__ int joint_content(const float* up_s, const float* dw_s,
                             const int* base_s,
                             const int16_t* __restrict__ table, int C,
                             int off0, float* tri_s, float* score_s,
                             float* red_v, int* red_i) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int groups = C >> 5;           // warps per offset share
  const int shares = kWarps / groups;  // offset shares
  const int g = warp % groups, h = warp / groups;
  const int c = (g << 5) + lane;
  const int span = kOffsets / shares;
  float a = 0.f, b = 0.f, cc = 0.f;
  for (int u = h * span; u < (h + 1) * span; ++u) {
    const float tc = static_cast<float>(table[base_s[u] + c]);
    if (up_s[u] > 0.f && u != off0)
      top3_insert(__fsub_rn(dw_s[u], tc), a, b, cc);
  }
  float* mine = tri_s + (warp * 32 + lane) * 3;
  mine[0] = a;
  mine[1] = b;
  mine[2] = cc;
  __syncthreads();
  if (h == 0) {
    for (int s = 1; s < shares; ++s) {
      const float* other = tri_s + ((s * groups + g) * 32 + lane) * 3;
      top3_insert(other[0], a, b, cc);
      top3_insert(other[1], a, b, cc);
      top3_insert(other[2], a, b, cc);
    }
    const float prim = __fsub_rn(
        dw_s[off0], static_cast<float>(table[base_s[off0] + c]));
    score_s[c] = __fadd_rn(prim, __fadd_rn(__fadd_rn(a, b), cc));
  }
  __syncthreads();
  float best;
  return block_argmax(t < C ? score_s[t] : -FLT_MAX, &best, red_v, red_i);
}

template <bool kJoint>
__global__ void __launch_bounds__(kOffsets)
subop_chain_kernel(float* __restrict__ rows,             // (B, k, 4, 256)
                   const int32_t* __restrict__ sc_rows,  // (B, k, 256)
                   const int16_t* __restrict__ table,    // (*, C)
                   int C, const float* __restrict__ nonce,  // (B, j, k, 256)
                   const int64_t* __restrict__ pages,       // (B, k)
                   const int32_t* __restrict__ pad_content,  // (B,)
                   int k, int j, int nvalid,
                   uint8_t* __restrict__ recs) {  // (B, j, k, 6)
  __shared__ float up_s[kOffsets], dw_s[kOffsets], by_s[kOffsets],
      tb_s[kOffsets];
  __shared__ float red_v[kWarps + 1];
  __shared__ int red_i[kWarps + 1];
  __shared__ int base_s[kJoint ? kOffsets : 1];
  __shared__ float tri_s[kJoint ? kOffsets * 3 : 1];
  __shared__ float score_s[kJoint ? kOffsets : 1];
  const int slot = blockIdx.x, movie = blockIdx.y, t = threadIdx.x;
  const size_t ps = (size_t)movie * k + slot;  // (movie, slot) page index
  float* row = rows + ps * 4 * kOffsets;
  up_s[t] = row[t];
  dw_s[t] = row[kOffsets + t];
  by_s[t] = row[2 * kOffsets + t];
  tb_s[t] = row[3 * kOffsets + t];
  const int base = sc_rows[ps * kOffsets + t] * C;
  if (kJoint) base_s[t] = base;
  const int page = static_cast<int>(pages[ps]);
  const int pad = pad_content[movie];
  __syncthreads();

  for (int jj = 0; jj < j; ++jj) {
    const float up = up_s[t];
    const bool has_work = __syncthreads_or(up > 0.f) != 0;
    const bool real = has_work && (jj * k + slot < nvalid);
    const size_t sub = ((size_t)movie * j + jj) * k + slot;

    const float nz = nonce != nullptr ? nonce[sub * kOffsets + t] : 0.f;
    const float score0 = __fadd_rn(__fmul_rn(up, 256.f), __fmul_rn(nz, 255.f));
    float best;
    const int off0 = block_argmax(score0, &best, red_v, red_i);
    const int content =
        kJoint ? joint_content(up_s, dw_s, base_s, table, C, off0, tri_s,
                               score_s, red_v, red_i)
               : static_cast<int>(tb_s[off0]);

    const float sc = static_cast<float>(table[base + (content & (C - 1))]);
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
        up_s[t] = kJoint ? sc : 0.f;
        dw_s[t] = kJoint ? sc : 0.f;
        by_s[t] = static_cast<float>(content);
      } else if (companion) {
        up_s[t] = sc;
        by_s[t] = static_cast<float>(content);
      }
    }
    if (t == 0) {
      uint8_t* rec = recs + sub * 6;
      rec[0] = static_cast<uint8_t>(real ? page + 32 : 32);
      rec[1] = static_cast<uint8_t>(real ? content : pad);
      rec[2] = static_cast<uint8_t>(real ? off0 : 0);
      rec[3] = static_cast<uint8_t>(real ? offs[0] : 0);
      rec[4] = static_cast<uint8_t>(real ? offs[1] : 0);
      rec[5] = static_cast<uint8_t>(real ? offs[2] : 0);
    }
    // each thread only reads back its own up/dw/by entries until the next
    // sub-op's first block-wide step (__syncthreads_or), which orders the
    // rest (the joint scan reads every offset's up/dw after it)
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

// rows: (B, k, 4, 256) float32 [up, dw, by, tb] of each movie's selected
// pages, updated in place (tb is read only); sc_rows: (B, k, 256) int32
// store-cost table row per offset; table: int16 (*, C), shared by the
// movies; nonce: (B, j, k, 256) float32 or NULL for the deterministic
// encoder; pages: (B, k) int64; pad_content: (B,) int32 padding-op bytes;
// nvalid: real ops of the step (shared); joint: 0 for the default content
// rule, 1 for joint content (C a multiple of 32, at most 256); recs:
// (B, j, k, 6) uint8.  Returns the launch's cudaError_t.
int iiv_subop_chain(float* rows, const int32_t* sc_rows, const int16_t* table,
                    int C, const float* nonce, const int64_t* pages,
                    const int32_t* pad_content, int B, int k, int j,
                    int nvalid, int joint, uint8_t* recs, void* stream) {
  if (B < 0 || k < 1 || j < 1 || C < 1 || (C & (C - 1)) != 0 || B > 65535)
    return cudaErrorInvalidValue;
  if (joint && (C < 32 || C > kOffsets)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid(k, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (joint)
    subop_chain_kernel<true><<<grid, kOffsets, 0, s>>>(
        rows, sc_rows, table, C, nonce, pages, pad_content, k, j, nvalid,
        recs);
  else
    subop_chain_kernel<false><<<grid, kOffsets, 0, s>>>(
        rows, sc_rows, table, C, nonce, pages, pad_content, k, j, nvalid,
        recs);
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

// The warp-wide argmax of the encoder's sub-op, shared by the body kernel
// (body.cu, `run_slot` and `joint_content`) and kernel C, the sub-op
// microbenchmark (subop_bench.cu), so that the microbenchmark times the
// instructions the encoder runs.
//
// A page's 256 offsets live on one warp, lane l holding offsets 32 i + l,
// i < 8.  An argmax over the page is a local scan of the lane's 8 values in
// ascending offset order, keeping the first maximum (`if (v > best)`), then
// `warp_argmax`: five butterfly exchanges, after which every lane holds the
// page's maximum and the first index that reaches it, the tie rule of
// jnp.argmax and torch.argmax.  No shared memory, no block barrier.
// `companion_rounds` is the sub-op's three companion selections on that
// layout.

#pragma once

#include <cfloat>
#include <climits>

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPerLane = 8;  // offsets per lane of a page warp: 256 / 32

// (value, index) pair is better if larger, or equal with a lower index:
// the first maximal index, as jnp.argmax / torch.argmax return it.
__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Warp-wide argmax of one (value, index) per lane; every lane gets it.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

// The sub-op's three companion rounds on one page.  sl: the lane's 8
// companion scores (dw - cost where the offset is pending, improved by the
// store and not the primary; else -1), consumed.  Each round takes the
// page's argmax; it hits iff that maximum is > 0, and the chosen offset
// drops out either way.  offs[r] is round r's offset, or off0 on a miss.
// Returns the lane's companion mask: bit i set iff offset 32 i + lane hit.
__device__ __forceinline__ unsigned companion_rounds(float* sl, int off0,
                                                     int lane, int* offs) {
  unsigned comp = 0;
#pragma unroll
  for (int rr = 0; rr < 3; ++rr) {
    float v = -FLT_MAX;
    int o = INT_MAX;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (sl[i] > v) {
        v = sl[i];
        o = i * 32 + lane;
      }
    warp_argmax(v, o);
    const bool hit = v > 0.f;
    offs[rr] = hit ? o : off0;
    if ((o & 31) == lane) {
      // a later round can pick a hit offset again (every sl at -1 sends
      // argmax to offset 0): it stays a companion
      const int i = o >> 5;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        if (q == i) {
          if (hit) comp |= 1u << q;
          sl[q] = -1.f;
        }
    }
  }
  return comp;
}

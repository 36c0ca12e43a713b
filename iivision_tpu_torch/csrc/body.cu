// The encoder's chunk body in one launch for B movies, for Hopper (sm_90a).
//
// Replaces the JAX encoder's body scan: `step_body` and `sub_op` under it
// (iivision_tpu/encoder.py:567-759, XLA in the JAX package, not Pallas),
// for DHGR and HGR and every colour model, with either content rule: the
// default (the target byte at the primary offset) and the joint rule of
// `--joint_content` (encoder.py:583-610, :663-676), one instantiation each
// (template <bool kJoint>).  One launch runs steps s0 .. s0+Sc-1 of the
// plan.  Each step:
//   1. page scores: max(up) over each page's 256 offsets, times 256, plus
//      255 x the page's nonce (two roundings, as the two torch ops do);
//   2. the k best pages, stably: rank_p = #{q: s_q > s_p} + #{q < p:
//      s_q == s_p}, the order of torch.sort(stable=True) and lax.top_k;
//   3. j sequential sub-ops on each selected page (kernel B's arithmetic,
//      op for op: csrc/subop.cu): primary offset by argmax of up*256 +
//      nonce*255, the content byte, three companion rounds against
//      dw - cost, gated updates, one record per sub-op.
// A step whose plan nvalid is 0 is skipped whole: no state change, no nonce
// draw; its records stay the padding op the caller wrote.
//
// The content byte.  The default rule reads the target byte at the primary
// offset.  The joint rule scores every content c of the page:
//   prim[c] = dw[off0] - cost(off0, c)
//   comp[c] = sum of the three largest positive dw[t] - cost(t, c) over
//             offsets t != off0 with up[t] > 0
// and takes argmax_c(prim + ((a + b) + c)), the first c on ties; the
// primary then keeps its residual (up = dw = cost(off0, content)).  Every
// term is an integer below 2^18, exact in float32, so the top three may be
// found in any order.  Slot r's warp does it alone: it lists the page's
// eligible offsets (up > 0, not the primary) in ascending order in a
// per-warp shared-memory list (table row x C, dw + 2^23), then each lane
// owns four consecutive contents per pass of 128 (one pass for DHGR's
// C = 128, two for HGR's 256) and keeps their top threes in registers;
// each listed offset costs one 8-byte table load per lane (the warp's 32
// loads are the row's 256 contiguous bytes; the int16 table is 8 MB for
// DHGR and sits in L2), eight loads in flight per round.  The costs
// become floats by their bits (0x4B000000 | cost is 2^23 + cost), not by
// int-to-float conversions, and the top three is a branch-free min/max
// insert.  A warp argmax over the lanes' best contents, with the
// first-index tie rule, picks the byte.
//
// Nonces are drawn inside: threefry2x32 (20 rounds, rotations 13/15/26/6
// and 17/29/16/24, key parity 0x1BD11BDA) in native uint32 arithmetic, the
// bits of ops/random.py and jax.random:
//   skey = fold_in(key, s); page nonces uniform(fold_in(skey, 0), (32,));
//   offset nonces of sub-op jj uniform(fold_in(skey, 1 + jj), (k, 256)) at
//   counter r * 256 + t for slot r, offset t;
//   fold_in(key, d) = threefry(key; 0, d); bits = y0 ^ y1 of
//   threefry(key; 0, n); the float is (bits >> 9 | 0x3F800000) - 1.
// The deterministic encoder (keys NULL) uses zeros.
//
// Grid B: one block per movie, 1024 threads (32 warps).  The active bank's
// state lives in dynamic shared memory for the whole body (96 KB, plus
// 64 KB of per-warp offset lists for the joint rule): up and dw as float32
// (converted from the int32 state with __int2float_rn, as torch's
// .to(float32) rounds), by and tb as uint8, and each offset's store-cost
// table row (lane * R + target lane value) as uint16.  Warp p reduces page
// p's maximum; warp 0 ranks; warp r < k then runs slot r's sub-ops on its
// own page, each lane holding 8 offsets (t = 32 i + lane) in registers,
// each argmax a local 8-way scan plus five butterfly shuffles with kernel
// B's tie rule (the first maximal index; warp_argmax.cuh, which kernel C,
// the sub-op microbenchmark, shares).  No block barrier sits inside a
// sub-op chain.  At the end up and dw go back to int32 with __float2int_rz
// (torch's truncation) and by to the bank bytes.
//
// What bounds it: per movie and body about 0.5 MB of traffic (state in and
// out, targets, table reads, records), 0.15 us at 3.35 TB/s, so memory is
// not the limit.  The default rule's floor is the dependent chain: Sc steps
// x (one page reduction + one rank + j x 4 warp argmaxes), each argmax a
// few hundred cycles of shuffles, plus 8 threefry blocks per lane per
// sub-op.  The joint rule adds, per sub-op and page, up to 256 x C table
// reads and top-three inserts on one warp: its floor is that warp's
// instruction stream (about 30 instructions per listed offset and lane per
// pass) and the L2 latency of its table loads, which the eight loads in
// flight and the other slots' warps hide (on an H100, eight in flight
// ran a DHGR k=16 j=4 body 22% faster than four).  A batch fills B SMs;
// one movie runs on one SM.
//
// iiv_threefry_uniform exposes the same threefry to tests: it writes the
// nonces of given keys and steps in ops/random.step_nonces' layout.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_argmax.cuh"

namespace {

constexpr int kPages = 32;
constexpr int kOffsets = 256;
constexpr int kCells = kPages * kOffsets;  // one bank: 8192 bytes
constexpr int kThreads = 1024;             // 32 warps
// dynamic shared memory: up, dw (float), row (uint16), by, tb (uint8)
constexpr int kSmemBytes = kCells * (4 + 4 + 2 + 1 + 1);
// the joint rule's per-warp lists of eligible offsets: (row * C, dw + 2^23)
// as an int2, 256 entries each
constexpr int kListBytes = (kThreads / 32) * kOffsets * (4 + 4);
constexpr int kJointBatch = 8;  // table loads in flight per lane

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax.random's block function).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = rotl32(x1, r0) ^ x0;
    x0 += x1; x1 = rotl32(x1, r1) ^ x0;
    x0 += x1; x1 = rotl32(x1, r2) ^ x0;
    x0 += x1; x1 = rotl32(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

// fold_in(key, d): the key hashed with the counter (0, d).
__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t d) {
  return threefry2x32(key.x, key.y, 0u, d);
}

// uniform(key, .)[n] in [0, 1): the top 23 bits of y0 ^ y1 of the counter
// (0, n) as the mantissa of a float in [1, 2), minus 1.
__device__ __forceinline__ float uniform_at(uint2 key, uint32_t n) {
  const uint2 y = threefry2x32(key.x, key.y, 0u, n);
  return __fsub_rn(__uint_as_float(((y.x ^ y.y) >> 9) | 0x3F800000u), 1.f);
}

// Keep the three largest values seen (a >= b >= c; all start at 0, so only
// positive values enter, as the JAX form's where(score > 0, score, 0)): a
// branch-free insert.
__device__ __forceinline__ void top3_insert(float v, float& a, float& b,
                                            float& c) {
  const float below_a = fminf(a, v);
  a = fmaxf(a, v);
  const float below_b = fminf(b, below_a);
  b = fmaxf(b, below_a);
  c = fmaxf(c, below_b);
}

// 2^23: a float's unit in the last place is 1 from here to 2^24
constexpr float kMagic = 8388608.f;

// The four int16 costs of one 8-byte table load, each as the float
// 2^23 + cost: the bits 0x4B000000 | cost are exactly that float for costs
// 0..32767 (store costs are distances, below 2^15), so no int-to-float
// conversion is issued; (dw + 2^23) - (2^23 + cost) is then dw - cost
// exactly, as every value is an integer below 2^23.
__device__ __forceinline__ void unpack4(uint2 w, float* c) {
  c[0] = __uint_as_float(__byte_perm(w.x, 0x4B000000u, 0x7610u));
  c[1] = __uint_as_float(__byte_perm(w.x, 0x4B000000u, 0x7632u));
  c[2] = __uint_as_float(__byte_perm(w.y, 0x4B000000u, 0x7610u));
  c[3] = __uint_as_float(__byte_perm(w.y, 0x4B000000u, 0x7632u));
}

struct Body {
  int32_t* up;  // (B, n_banks, 32, 256) int32 state, updated at `bank`
  int32_t* dw;
  int32_t* banks;
  const int32_t* lanes_tgt;  // (B, F, 32, 128, n_lanes)
  const int32_t* bytes_tgt;  // (B, F, 2, 32, 256)
  const int16_t* table;      // (n_lanes * R, C)
  const uint32_t* keys;      // (B, 2) or NULL
  const int32_t* nvalid;     // (S,) the plan's step_nvalid
  uint8_t* ops;              // (S, B, j, k, 6) records
  int B, n_banks, bank, F, frame, n_lanes, lane_e, lane_o, R, C, s0, Sc, k,
      j;
};

// The joint content of one sub-op on page P (the header's rule), computed
// by one warp; every lane gets it.  upv / dwv: the lanes' live state
// (offset i * 32 + lane); list: the warp's offset list.
__device__ int joint_content(const Body& a, const uint16_t* row_p,
                             const float* upv, const float* dwv, int off0,
                             int2* list) {
  const int lane = threadIdx.x & 31;
  // eligible offsets, ascending: (row * C, dw + 2^23) of each
  int n = 0;
  float d0 = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int o = i * 32 + lane;
    if (o == off0) d0 = dwv[i];
    const bool e = upv[i] > 0.f && o != off0;
    const unsigned m = __ballot_sync(kFull, e);
    if (e)
      list[n + __popc(m & ((1u << lane) - 1u))] =
          make_int2(static_cast<int>(row_p[o]) * a.C,
                    __float_as_int(__fadd_rn(dwv[i], kMagic)));
    n += __popc(m);
  }
  // dw at the primary, + 2^23
  d0 = __fadd_rn(__shfl_sync(kFull, d0, off0 & 31), kMagic);
  const int row0 = static_cast<int>(row_p[off0]) * a.C;
  __syncwarp();

  float bv = -FLT_MAX;
  int bi = INT_MAX;
  for (int q = 0; q < a.C; q += 4 * 32) {
    // this pass's contents of the lane: q + 4 * lane + m, m < 4
    const int16_t* tq = a.table + q + 4 * lane;
    float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f},
          t3[4] = {0.f, 0.f, 0.f, 0.f};
    int e = 0;
    for (; e + kJointBatch <= n; e += kJointBatch) {
      int2 at[kJointBatch];
      uint2 w[kJointBatch];
#pragma unroll
      for (int x = 0; x < kJointBatch; ++x) {
        at[x] = list[e + x];
        w[x] = *reinterpret_cast<const uint2*>(tq + at[x].x);
      }
#pragma unroll
      for (int x = 0; x < kJointBatch; ++x) {
        float c[4];
        unpack4(w[x], c);
        const float d = __int_as_float(at[x].y);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          top3_insert(__fsub_rn(d, c[m]), t1[m], t2[m], t3[m]);
      }
    }
    for (; e < n; ++e) {
      const int2 at = list[e];
      float c[4];
      unpack4(*reinterpret_cast<const uint2*>(tq + at.x), c);
      const float d = __int_as_float(at.y);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        top3_insert(__fsub_rn(d, c[m]), t1[m], t2[m], t3[m]);
    }
    float c0[4];
    unpack4(*reinterpret_cast<const uint2*>(tq + row0), c0);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float v = __fadd_rn(__fsub_rn(d0, c0[m]),
                                __fadd_rn(__fadd_rn(t1[m], t2[m]), t3[m]));
      if (v > bv) {  // contents ascend within the lane: keeps the first
        bv = v;
        bi = q + 4 * lane + m;
      }
    }
  }
  warp_argmax(bv, bi);
  __syncwarp();  // the list is rewritten by the next sub-op
  return bi;
}

// Slot r's j sub-ops on page P (one warp; kernel B's math per offset).
template <bool kJoint>
__device__ void run_slot(const Body& a, float* up_s, float* dw_s,
                         const uint16_t* row_s, uint8_t* by_s,
                         const uint8_t* tb_s, int movie, int s, int r, int P,
                         int nv, bool seeded, uint2 skey, int pad,
                         int2* list) {
  const int lane = threadIdx.x & 31;
  float* up_p = up_s + P * kOffsets;
  float* dw_p = dw_s + P * kOffsets;
  float upv[kPerLane], dwv[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    upv[i] = up_p[i * 32 + lane];
    dwv[i] = dw_p[i * 32 + lane];
  }
  for (int jj = 0; jj < a.j; ++jj) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) any |= upv[i] > 0.f;
    const bool real = __any_sync(kFull, any) && (jj * a.k + r < nv);

    // primary offset: argmax of up*256 + nonce*255
    const uint2 okey = seeded ? fold_in(skey, 1u + jj) : make_uint2(0u, 0u);
    float bv = -FLT_MAX;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int o = i * 32 + lane;
      const float nz = seeded ? uniform_at(okey, r * kOffsets + o) : 0.f;
      const float v = __fadd_rn(__fmul_rn(upv[i], 256.f), __fmul_rn(nz, 255.f));
      if (v > bv) {  // offsets ascend: keeps the first maximal one
        bv = v;
        bi = o;
      }
    }
    warp_argmax(bv, bi);
    const int off0 = bi;
    const int content =
        kJoint ? joint_content(a, row_s + P * kOffsets, upv, dwv, off0, list)
               : tb_s[P * kOffsets + off0];

    // companions: pending offsets the store improves, three rounds
    float scv[kPerLane], sl[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int o = i * 32 + lane;
      scv[i] = static_cast<float>(
          a.table[(int)row_s[P * kOffsets + o] * a.C + (content & (a.C - 1))]);
      const float score = __fsub_rn(dwv[i], scv[i]);
      sl[i] = (upv[i] > 0.f && score > 0.f && o != off0) ? score : -1.f;
    }
    int offs[3];
    const unsigned comp = companion_rounds(sl, off0, lane, offs);

    if (real) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int o = i * 32 + lane;
        if (o == off0) {
          // the joint rule keeps the primary's residual
          upv[i] = kJoint ? scv[i] : 0.f;
          dwv[i] = kJoint ? scv[i] : 0.f;
          by_s[P * kOffsets + o] = static_cast<uint8_t>(content);
        } else if ((comp >> i) & 1u) {
          upv[i] = scv[i];
          by_s[P * kOffsets + o] = static_cast<uint8_t>(content);
        }
      }
    }
    if (lane == 0) {
      uint8_t* rec =
          a.ops + ((((size_t)s * a.B + movie) * a.j + jj) * a.k + r) * 6;
      rec[0] = static_cast<uint8_t>(real ? P + 32 : 32);
      rec[1] = static_cast<uint8_t>(real ? content : pad);
      rec[2] = static_cast<uint8_t>(real ? off0 : 0);
      rec[3] = static_cast<uint8_t>(real ? offs[0] : 0);
      rec[4] = static_cast<uint8_t>(real ? offs[1] : 0);
      rec[5] = static_cast<uint8_t>(real ? offs[2] : 0);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    up_p[i * 32 + lane] = upv[i];
    dw_p[i * 32 + lane] = dwv[i];
  }
}

template <bool kJoint>
__global__ void __launch_bounds__(kThreads, 1) encode_body_kernel(Body a) {
  extern __shared__ float smem[];
  float* up_s = smem;
  float* dw_s = up_s + kCells;
  uint16_t* row_s = reinterpret_cast<uint16_t*>(dw_s + kCells);
  uint8_t* by_s = reinterpret_cast<uint8_t*>(row_s + kCells);
  uint8_t* tb_s = by_s + kCells;
  // the joint rule's offset lists, kOffsets entries per warp
  int2* list = reinterpret_cast<int2*>(tb_s + kCells);
  __shared__ float score_s[kPages];
  __shared__ int slot_page[kPages];

  const int movie = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const size_t cell0 = ((size_t)movie * a.n_banks + a.bank) * kCells;
  const size_t tb0 = (((size_t)movie * a.F + a.frame) * 2 + a.bank) * kCells;
  const size_t ln0 = ((size_t)movie * a.F + a.frame) * kPages * 128 *
                     a.n_lanes;
  for (int e = t; e < kCells; e += kThreads) {
    up_s[e] = __int2float_rn(a.up[cell0 + e]);
    dw_s[e] = __int2float_rn(a.dw[cell0 + e]);
    by_s[e] = static_cast<uint8_t>(a.banks[cell0 + e]);
    tb_s[e] = static_cast<uint8_t>(a.bytes_tgt[tb0 + e]);
    const int o = e & (kOffsets - 1);
    const int ln = (o & 1) ? a.lane_o : a.lane_e;
    const int tgt = a.lanes_tgt[ln0 + ((size_t)(e >> 8) * 128 + (o >> 1)) *
                                          a.n_lanes + ln];
    row_s[e] = static_cast<uint16_t>(ln * a.R + tgt);
  }
  const bool seeded = a.keys != nullptr;
  const uint2 key = seeded ? make_uint2(a.keys[2 * movie], a.keys[2 * movie + 1])
                           : make_uint2(0u, 0u);
  __syncthreads();
  // the padding op's content: the target byte at page 0, offset 0
  const int pad = tb_s[0];

  for (int s = a.s0; s < a.s0 + a.Sc; ++s) {
    const int nv = a.nvalid[s];
    if (nv == 0) continue;  // a padded step: uniform over the block
    const uint2 skey = seeded ? fold_in(key, (uint32_t)s) : make_uint2(0u, 0u);

    // warp p: page p's score
    const float* u = up_s + warp * kOffsets;
    float m = u[lane];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = fmaxf(m, u[i * 32 + lane]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) {
      float sc = __fmul_rn(m, 256.f);
      if (seeded)
        sc = __fadd_rn(sc, __fmul_rn(uniform_at(fold_in(skey, 0u), warp),
                                     255.f));
      score_s[warp] = sc;
    }
    __syncthreads();
    if (warp == 0) {
      const float sp = score_s[lane];
      int rank = 0;
      for (int q = 0; q < kPages; ++q) {
        const float sq = score_s[q];
        rank += (sq > sp) || (sq == sp && q < lane);
      }
      if (rank < a.k) slot_page[rank] = lane;
    }
    __syncthreads();
    if (warp < a.k)
      run_slot<kJoint>(a, up_s, dw_s, row_s, by_s, tb_s, movie, s, warp,
                       slot_page[warp], nv, seeded, skey, pad,
                       list + warp * kOffsets);
    __syncthreads();
  }

  for (int e = t; e < kCells; e += kThreads) {
    a.up[cell0 + e] = __float2int_rz(up_s[e]);
    a.dw[cell0 + e] = __float2int_rz(dw_s[e]);
    a.banks[cell0 + e] = by_s[e];
  }
}

// The encoder's nonces of steps[i] for every key, step_nonces' layout:
// nonce_p (B, S, 32), nonce_o (B, S, j, k, 256).  Grid (S, B), 256 threads.
__global__ void threefry_uniform_kernel(const uint32_t* __restrict__ keys,
                                        const int32_t* __restrict__ steps,
                                        int S, int k, int j,
                                        float* __restrict__ nonce_p,
                                        float* __restrict__ nonce_o) {
  const int si = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const uint2 skey = fold_in(make_uint2(keys[2 * b], keys[2 * b + 1]),
                             static_cast<uint32_t>(steps[si]));
  const size_t bs = (size_t)b * S + si;
  if (t < kPages) nonce_p[bs * kPages + t] = uniform_at(fold_in(skey, 0u), t);
  for (int jj = 0; jj < j; ++jj) {
    const uint2 okey = fold_in(skey, 1u + jj);
    for (int r = 0; r < k; ++r)
      nonce_o[((bs * j + jj) * k + r) * kOffsets + t] =
          uniform_at(okey, r * kOffsets + t);
  }
}

}  // namespace

extern "C" {

// One chunk body of B movies (see the header).  up, dw, banks: (B, n_banks,
// 32, 256) int32, updated in place at `bank`; lanes_tgt (B, F, 32, 128,
// n_lanes) and bytes_tgt (B, F, 2, 32, 256) int32, read at `frame`; table
// (n_lanes * R, C) int16 with C a power of two; keys (B, 2) uint32 or NULL;
// nvalid (S,) int32; ops (S, B, j, k, 6) uint8.  lane_e / lane_o: the
// bank's lanes for even / odd offsets.  joint: 0 for the default content
// rule, 1 for joint content (C 128 or 256, table 8-byte aligned).  Returns
// a cudaError_t: the shared memory attribute's, else the launch's.
int iiv_encode_body(int32_t* up, int32_t* dw, int32_t* banks, int n_banks,
                    int bank, const int32_t* lanes_tgt,
                    const int32_t* bytes_tgt, int F, int frame, int n_lanes,
                    int lane_e, int lane_o, int R, const int16_t* table,
                    int C, const uint32_t* keys, const int32_t* nvalid,
                    int S, int s0, int Sc, int B, int k, int j, uint8_t* ops,
                    int joint, void* stream) {
  if (B < 0 || k < 1 || k > kPages || j < 1 || C < 1 || (C & (C - 1)) != 0 ||
      bank < 0 || bank >= n_banks || frame < 0 || frame >= F || s0 < 0 ||
      Sc < 0 || s0 + Sc > S || R < 1 || R * n_lanes > 65536)
    return cudaErrorInvalidValue;
  if (joint && ((C != 128 && C != 256) ||
                (reinterpret_cast<uintptr_t>(table) & 7) != 0))
    return cudaErrorInvalidValue;
  if (B == 0 || Sc == 0) return cudaSuccess;
  Body a{up,     dw,      banks,   lanes_tgt, bytes_tgt, table, keys,
         nvalid, ops,     B,       n_banks,   bank,      F,     frame,
         n_lanes, lane_e, lane_o,  R,         C,         s0,    Sc,
         k,      j};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (joint) {
    const int bytes = kSmemBytes + kListBytes;
    const cudaError_t attr = cudaFuncSetAttribute(
        encode_body_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    encode_body_kernel<true><<<B, kThreads, bytes, st>>>(a);
  } else {
    const cudaError_t attr = cudaFuncSetAttribute(
        encode_body_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    encode_body_kernel<false><<<B, kThreads, kSmemBytes, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The body kernel's threefry for tests: keys (B, 2) uint32, steps (S,)
// int32; writes nonce_p (B, S, 32) and nonce_o (B, S, j, k, 256) float32.
int iiv_threefry_uniform(const uint32_t* keys, int B, const int32_t* steps,
                         int S, int k, int j, float* nonce_p, float* nonce_o,
                         void* stream) {
  if (B < 0 || B > 65535 || S < 0 || k < 1 || k > kPages || j < 1)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  threefry_uniform_kernel<<<dim3(S, B), kOffsets, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      keys, steps, S, k, j, nonce_p, nonce_o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

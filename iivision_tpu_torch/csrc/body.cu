// The encoder's chunk body in one launch for B movies, for Hopper (sm_90a),
// with the chunk start's recompute as its prologue.
//
// Replaces the JAX encoder's `chunk_body` (iivision_tpu/encoder.py:482):
// `do_recompute` with `diff_bank` (:540-548, :351-398) under
// lax.cond(recompute, ...) (:553), then the step scan, `step_body` and
// `sub_op` under it (:567-759), all XLA in the JAX package, not Pallas,
// for DHGR and HGR and every colour model, with either content rule: the
// default (the target byte at the primary offset) and the joint rule of
// `--joint_content` (encoder.py:583-610, :663-676), one instantiation each
// (template <bool kJoint>, times the five cluster sizes).  One launch runs
// the recompute, if asked for, then steps s0 .. s0+Sc-1 of the plan.  Each
// step:
//   1. page scores: max(up) over each page's 256 offsets, times 256, plus
//      255 x the page's nonce (two roundings, as the two torch ops do);
//   2. the k best pages, stably: rank_p = #{q: s_q > s_p} + #{q < p:
//      s_q == s_p}, the order of torch.sort(stable=True) and lax.top_k;
//   3. j sequential sub-ops on each selected page (the arithmetic of
//      ops/subop.sub_op_chain_plain, op for op): primary offset by argmax
//      of up*256 + nonce*255, the content byte, three companion rounds
//      against dw - cost, gated updates, one record per sub-op.
// A step whose plan nvalid is 0 is skipped whole: no state change, no nonce
// draw; its records stay the padding op the caller wrote.
//
// The recompute (a uniform argument: 0 none, 1 a (16, 16) cost basis, the
// window and mono models, 2 the yiq model's (n_lanes, L, 128, 128) window
// costs): for the active bank of each movie, per page offset o,
//   1. the modelled screen's masked lane bank_lanes(bank)[o & 1] at column
//      c = o >> 1, from the bank bytes around it (DHGR: the aux and main
//      bytes of columns 2c-1 .. 2c+2 of the page row; HGR: the main
//      bytes), header and footer zero at the page edges;
//   2. the target lane from lanes_tgt[movie, frame];
//   3. the distance d: under a (16, 16) basis the diagonal
//      Damerau-Levenshtein distance of the two lanes' colour codes
//      (diag_dp.cuh; each code is the 4-dot window at dot i rotated by the
//      NTSC phase, lane_codes.cuh, which kernel A's lane-distance entry
//      shares; HGR lanes expand to 21 dots first); under yiq the sum over
//      the 7-dot windows w_j = (dots >> j) & 0x7F, j < 7 (DHGR) or 15
//      (HGR), of sub[lane, j, wa_j, wb_j], read through L2 (1.8-1.9 MB);
//      zero at the screen holes (o & 127 >= 120);
//   4. up = (d == 0 ? 0 : up) + d and dw = d, in int32 (ops/chunk_start.py
//      chunk_start_plain, bit for bit), converted straight into the CTA's
//      shared-memory state: up and dw are not written to HBM between the
//      recompute and the steps.
// The JAX package never split the two; the port ran the recompute as a
// kernel of its own until the body became a cluster, then made it the
// body's prologue, computed where its result is consumed.
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
// per-page shared-memory list (table row x C, dw + 2^23), then each lane
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
// A thread-block cluster per movie.  Cluster sizes c = 1, 2, 4, 8 or 16:
// CTA q of movie b's cluster (block b * c + q) owns the P = 32 / c pages
// q * P .. q * P + P - 1 and runs P warps, warp w on page q * P + w.  The
// CTA keeps its pages' state in dynamic shared memory for the whole body
// (3 KB a page, plus a 2 KB offset list a page for the joint rule): up and
// dw as float32 (converted from the int32 state with __int2float_rn, as
// torch's .to(float32) rounds), the table row (lane * R + target lane
// value) as uint16, by and tb as uint8.  Each step:
//   - warp w reduces its page's maximum, adds the page nonce and writes
//     the score into every CTA of the cluster (distributed shared memory:
//     lane q' stores to CTA q');
//   - one cluster barrier (release / acquire), so every CTA holds all 32
//     scores; the score arrays are double-buffered by the parity of the
//     count of steps run (a padded step runs no barrier), so no CTA
//     overwrites scores a peer still ranks from;
//   - warp w ranks its own page from the local copy (a ballot of the rule
//     above) and, if rank < k, runs slot r = rank on it: r gives the
//     nonce counter, the nvalid gate and the record index.
// A warp touches only its own page's state, so no block barrier and no
// cluster barrier sits inside a sub-op chain.  Each lane holds 8 offsets
// (t = 32 i + lane) in registers during a slot, each argmax a local 8-way
// scan plus five butterfly shuffles with the first-maximal-index rule
// (warp_argmax.cuh, which kernel C, the sub-op microbenchmark, shares).
// At the end up and dw go back to int32 with __float2int_rz (torch's
// truncation) and by to the bank bytes.  A cluster barrier after the
// prologue makes sure every CTA of the cluster runs before a peer stores
// into its shared memory; every store into a peer lands before that
// step's barrier, which the peer passes before it can exit, so no further
// barrier is needed at the end.  On an idle H100 the 16 CTAs of one
// movie's cluster land on 16 SMs without asking for more shared memory
// than their pages need; a batch's clusters share SMs where they must.
//
// What bounds it: per movie and body about 0.5 MB of traffic (state in and
// out, targets, table reads, records), 0.15 us at 3.35 TB/s, so memory is
// not the limit.  A seeded body's int32 work is its nonce draws: per step
// run, 2 + 32 + 257 k j threefry blocks of about 79 instructions (the
// rotation one funnel shift; `threefry2x32` below) and 3 bit operations
// per uniform; about 6.7 M at k=32 j=10.  With one CTA per movie all of
// it issued on one SM (about 52 us at 64 int32 lanes and 1.98 GHz); the
// cluster spreads the slots, and so the draws, over c SMs.  The rest is
// the dependent chain: Sc steps x (one page reduction + a barrier + one
// rank + j x 4 warp argmaxes).  The joint rule adds, per sub-op and page,
// up to 256 x C table reads and top-three inserts on one warp: its floor
// is that warp's instruction stream (about 30 instructions per listed
// offset and lane per pass) and the L2 latency of its table loads, which
// the eight loads in flight and the other slots' warps hide (on an H100,
// eight in flight ran a DHGR k=16 j=4 body 22% faster than four).
//
// The recompute on this card.  As a launch of its own (grid (32, B), a
// thread per offset) it was latency-bound: 0.0032 ms for one movie whose
// bytes take 0.15 us, and a second launch a step for the host.  As the
// prologue (numbers: one H100 80GB HBM3 at 700 W; `python3 chip_smoke.py
// --variants` times this file against each variant in PROLOGUE_VARIANTS,
// in prologue us = a recomputing body less the same body without it):
//   - cluster residency: it runs on the SMs the body's cluster holds (16
//     at B = 1), so there is no launch and no drain between two kernels,
//     and up and dw go from registers into shared memory, never through
//     HBM;
//   - staging: both banks' page rows as uint8 and the (16, 16) basis, in
//     the space of up_s and dw_s, which the recompute fills last, so a
//     CTA asks for no more dynamic shared memory.  The rows come in with
//     plain loads, all in flight at once (they are int32 in HBM and bytes
//     here); a 1-D bulk async copy was not tried;
//   - a thread owns kPerLane cells, all on one lane (the offsets' parity
//     is t's), and runs their DP chains kChains side by side: four and
//     eight chains measured alike, two 0.3-0.6 us slower.  Past four the
//     DP is bound by instruction issue on the two warps an SM holds at
//     c = 16;
//   - each colour code follows from the one before it (lane_code_next,
//     four operations where lane_code takes about ten): 3.0 us against
//     3.8 for a DHGR (32, 10) body, 3.0 against 4.4 at (16, 4) B = 32, 4.0
//     against 9.4 on HGR at B = 32;
//   - no load waits behind a branch: each path's loads sit in an unrolled
//     loop of its own, the basis's beside the rows'.  One loop with the
//     uniform `if (recompute)` inside had cost the body without the
//     recompute 3.5 us (`--sweep`, on that first form);
//   - yiq's window sums stay a loop over the windows with the thread's 8
//     loads in flight: unrolling it saved 2.5 us of sums at B = 32 but
//     took 254 registers and made the B = 32 body 16% slower.  The sums
//     are bound by L2 gathers (1.8 M random words at B = 32);
//   - tensor cores do not apply: an integer DP of dependent table lookups
//     and a gather-sum hold no product for wgmma.
// The prologue costs 2.9-3.3 us at DHGR (32, 10) B = 1 and (16, 4) B = 32,
// 3.9-4.3 us on HGR (18-step chains and the dot expansion), 4.3 us for yiq
// at B = 1 and 14.2-15.0 us at B = 32; 1.6-1.9 us of it at B = 1 is not
// the DP (the staging's round trip, the lane assembly, two block
// barriers).  Registers: 112-122 a thread at c >= 2 (the body alone took
// 80 and 96-100), no spill; c = 1 keeps 64 and spills 12 bytes (16
// joint).  With them the card holds 62 clusters at c = 4 and 8, not 92;
// the chooser's c = 16 up to 58 movies is unchanged.
//
// iiv_threefry_uniform exposes the same threefry to tests: it writes the
// nonces of given keys and steps in ops/random.step_nonces' layout.

#include <atomic>
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "diag_dp.cuh"
#include "lane_codes.cuh"
#include "warp_argmax.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPages = 32;
constexpr int kOffsets = 256;
constexpr int kCells = kPages * kOffsets;  // one bank: 8192 bytes
// dynamic shared memory per page: up, dw (float), row (uint16), by, tb
// (uint8)
constexpr int kPageBytes = kOffsets * (4 + 4 + 2 + 1 + 1);
// the joint rule's per-page list of eligible offsets: (row * C, dw + 2^23)
// as an int2, 256 entries
constexpr int kListBytes = kOffsets * (4 + 4);
constexpr int kJointBatch = 8;  // table loads in flight per lane
// the recompute's independent chains a thread runs side by side (of its
// kPerLane cells)
constexpr int kChains = 4;

// a CTA's dynamic shared memory for `pages` pages
constexpr int smem_bytes(bool joint, int pages) {
  return pages * (kPageBytes + (joint ? kListBytes : 0));
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

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

// DHGR masked lane `lane` at column c from one page's staged main / aux
// rows (screen.py masked_lane_at).
__device__ __forceinline__ int dhgr_lane_at(const uint8_t* main_r,
                                            const uint8_t* aux_r, int lane,
                                            int c) {
  const int c2 = 2 * c;
  const int a0 = aux_r[c2] & 0x7F, m0 = main_r[c2] & 0x7F;
  const int a1 = aux_r[c2 + 1] & 0x7F, m1 = main_r[c2 + 1] & 0x7F;
  switch (lane) {
    case 0: {
      const int hdr = c > 0 ? (main_r[c2 - 1] & 0x7F) >> 4 : 0;
      return hdr | (a0 << 3) | ((m0 & 0b111) << 10);
    }
    case 1:
      return (a0 >> 4) | (m0 << 3) | ((a1 & 0b111) << 10);
    case 2:
      return (m0 >> 4) | (a1 << 3) | ((m1 & 0b111) << 10);
    default: {
      const int ftr = c < 127 ? aux_r[c2 + 2] & 0b111 : 0;
      return (a1 >> 4) | (m1 << 3) | (ftr << 10);
    }
  }
}

// HGR masked lane `lane` at column c from one page's staged main row.
__device__ __forceinline__ int hgr_lane_at(const uint8_t* main_r, int lane,
                                           int c) {
  const int c2 = 2 * c;
  const int even = main_r[c2], odd = main_r[c2 + 1];
  const int prev_odd = c > 0 ? main_r[c2 - 1] : 0;
  const int next_even = c < 127 ? main_r[c2 + 2] : 0;
  const int hdr = ((prev_odd >> 5) & 0b011) | ((prev_odd >> 5) & 0b100);
  const int ftr = ((next_even >> 7) & 1) | ((next_even & 0b11) << 1);
  const int packed = hdr | (even << 3) | ((odd & 0x80) << 4) |
                     ((odd & 0x7F) << 12) | (ftr << 19);
  return (packed >> (8 * lane)) & 0x3FFF;
}

// The dots of cell e's two lanes (lane ln): the modelled screen's, from
// its page row among the staged rows (main at rows, aux kCellsCta bytes
// on), and the target lane value tgt's.
__device__ __forceinline__ void cell_dots(const uint8_t* rows, int cells,
                                          int e, int ln, int tgt, bool dhgr,
                                          int& da, int& db) {
  const uint8_t* main_r = rows + (e & ~(kOffsets - 1));
  const int c = (e & (kOffsets - 1)) >> 1;
  const int cur = dhgr ? dhgr_lane_at(main_r, main_r + cells, ln, c)
                       : hgr_lane_at(main_r, ln, c);
  da = dhgr ? cur : hgr_to_dots(cur, ln);
  db = dhgr ? tgt : hgr_to_dots(tgt, ln);
}

// kChains diagonal DPs side by side over L colour codes of one lane (one
// NTSC phase): each code follows from the one before it when the step
// needs it (lane_code_next), so no code array sits in registers, and the
// chains' cost lookups sub[a * 16 + b] in shared memory overlap.
__device__ __forceinline__ void diag_dp_chains(const int* da, const int* db,
                                               int phase, int L,
                                               const int* sub, int* d) {
  int ap[kChains], bp[kChains], d_m2[kChains], xa[kChains], xb[kChains];
#pragma unroll
  for (int x = 0; x < kChains; ++x) {
    ap[x] = lane_code(da[x], 0, phase);
    bp[x] = lane_code(db[x], 0, phase);
    xa[x] = (da[x] ^ (da[x] >> 4)) << phase;
    xb[x] = (db[x] ^ (db[x] >> 4)) << phase;
    d_m2[x] = 0;
    d[x] = sub[ap[x] * 16 + bp[x]];
  }
  for (int k = 1; k < L; ++k) {
#pragma unroll
    for (int x = 0; x < kChains; ++x)
      diag_dp_step(d_m2[x], d[x], ap[x], bp[x],
                   lane_code_next(ap[x], xa[x], k, phase),
                   lane_code_next(bp[x], xb[x], k, phase), sub);
  }
}

// N yiq window sums side by side, d = sum_w sub_l[w, wa_w, wb_w] over one
// lane's (L, 128, 128) costs: the N loads of a window independent.
template <int N>
__device__ __forceinline__ void window_sums(const int* da, const int* db,
                                            const int32_t* sub_l, int L,
                                            int* d) {
#pragma unroll
  for (int x = 0; x < N; ++x) d[x] = 0;
  for (int w = 0; w < L; ++w) {
#pragma unroll
    for (int x = 0; x < N; ++x)
      d[x] += __ldg(sub_l + ((w * 128 + ((da[x] >> w) & 0x7F)) << 7) +
                    ((db[x] >> w) & 0x7F));
  }
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
  int32_t* smid;             // (B * c,) each CTA's SM, or NULL
  const int32_t* sub;        // the recompute's costs, or NULL
  int B, n_banks, bank, F, frame, n_lanes, lane_e, lane_o, R, C, s0, Sc, k,
      j, recompute;
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

// Slot r's j sub-ops on page P (one warp; the plain sub-op chain's math
// per offset).  up_p .. tb_p: the page's state in shared memory.
template <bool kJoint>
__device__ void run_slot(const Body& a, float* up_p, float* dw_p,
                         const uint16_t* row_p, uint8_t* by_p,
                         const uint8_t* tb_p, int movie, int s, int r, int P,
                         int nv, bool seeded, uint2 skey, int pad,
                         int2* list) {
  const int lane = threadIdx.x & 31;
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
    const int content = kJoint
                            ? joint_content(a, row_p, upv, dwv, off0, list)
                            : tb_p[off0];

    // companions: pending offsets the store improves, three rounds
    float scv[kPerLane], sl[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int o = i * 32 + lane;
      scv[i] = static_cast<float>(
          a.table[(int)row_p[o] * a.C + (content & (a.C - 1))]);
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
          by_p[o] = static_cast<uint8_t>(content);
        } else if ((comp >> i) & 1u) {
          upv[i] = scv[i];
          by_p[o] = static_cast<uint8_t>(content);
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

// One CTA of a movie's cluster: kWarps pages, a warp each (the header).
// The cluster's size is the instantiation's, fixed at compile time, so a
// plain launch makes the clusters: the launch loop's host time carries no
// launch attribute for the runtime to read.  __launch_bounds__ lets a CTA
// of fewer warps hold more registers a thread (64 at 32 warps, 128 at 16,
// 255 below).
template <bool kJoint, int kWarps>
__global__ void __cluster_dims__(kPages / kWarps, 1, 1)
    __launch_bounds__(kWarps * 32, 1) encode_body_kernel(Body a) {
  constexpr int kCellsCta = kWarps * kOffsets;
  constexpr int kCluster = kPages / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  float* up_s = reinterpret_cast<float*>(smem);
  float* dw_s = up_s + kCellsCta;
  uint16_t* row_s = reinterpret_cast<uint16_t*>(dw_s + kCellsCta);
  uint8_t* by_s = reinterpret_cast<uint8_t*>(row_s + kCellsCta);
  uint8_t* tb_s = by_s + kCellsCta;
  // the joint rule's offset lists, kOffsets entries per page
  int2* list = reinterpret_cast<int2*>(tb_s + kCellsCta);
  // every page's score of a step, double-buffered (the header)
  __shared__ float score_s[2][kPages];

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int movie = blockIdx.x / kCluster, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int page = q * kWarps + warp;  // this warp's page
  // the CTA's cells: pages q * kWarps .. of the bank, kCellsCta of them
  const size_t cell0 = ((size_t)movie * a.n_banks + a.bank) * kCells +
                       (size_t)q * kCellsCta;
  const size_t tb0 = (((size_t)movie * a.F + a.frame) * 2 + a.bank) * kCells;
  const size_t ln0 = ((size_t)movie * a.F + a.frame) * kPages * 128 *
                     a.n_lanes;
  // kPerLane cells a thread at every cluster size, e = i * 32 kWarps + t,
  // unrolled so that their loads are in flight together; each path has a
  // loop of its own, so that no load waits behind a branch.  A thread's
  // cells share the parity of t, and so the lane.
  const int ln = (t & 1) ? a.lane_o : a.lane_e;
  if (!a.recompute) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = i * kWarps * 32 + t;
      up_s[e] = __int2float_rn(a.up[cell0 + e]);
      dw_s[e] = __int2float_rn(a.dw[cell0 + e]);
      by_s[e] = static_cast<uint8_t>(a.banks[cell0 + e]);
      const int g = q * kCellsCta + e;  // the cell in the bank
      tb_s[e] = static_cast<uint8_t>(a.bytes_tgt[tb0 + g]);
      const int tgt = a.lanes_tgt[ln0 + ((size_t)(g >> 8) * 128 +
                                         ((g & (kOffsets - 1)) >> 1)) *
                                            a.n_lanes + ln];
      row_s[e] = static_cast<uint16_t>(ln * a.R + tgt);
    }
  } else {
    // The recompute.  Its staging lives in the space of up_s and dw_s,
    // which it fills last: both banks' page rows as uint8 (main, then aux)
    // and the (16, 16) basis.  The targets and the old up stay in
    // registers until the new state is known.
    uint8_t* const rows_s = reinterpret_cast<uint8_t*>(up_s);
    int* const sub_s = reinterpret_cast<int*>(dw_s);
    const bool dhgr = a.n_banks == 2;
    // the other bank's row (HGR has none: its own again, into the unused
    // slot, so that the loop holds no branch)
    const int ob = dhgr ? 1 - a.bank : 1;
    const size_t other =
        dhgr ? ((size_t)movie * 2 + ob) * kCells + (size_t)q * kCellsCta
             : cell0;
    // the basis: its loads issued first, beside the rows', with no branch
    // (the yiq costs hold far more than 256 words; those are not used)
    constexpr int kSubLoads = (256 + kWarps * 32 - 1) / (kWarps * 32);
    int sub_r[kSubLoads];
#pragma unroll
    for (int i = 0; i < kSubLoads; ++i) {
      const int x = i * kWarps * 32 + t;
      sub_r[i] = x < 256 ? a.sub[x] : 0;
    }
    int tgt[kPerLane], up_n[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = i * kWarps * 32 + t;
      const uint8_t by = static_cast<uint8_t>(a.banks[cell0 + e]);
      by_s[e] = by;
      rows_s[a.bank * kCellsCta + e] = by;
      rows_s[ob * kCellsCta + e] = static_cast<uint8_t>(a.banks[other + e]);
      up_n[i] = a.up[cell0 + e];
      const int g = q * kCellsCta + e;
      tb_s[e] = static_cast<uint8_t>(a.bytes_tgt[tb0 + g]);
      tgt[i] = a.lanes_tgt[ln0 + ((size_t)(g >> 8) * 128 +
                                  ((g & (kOffsets - 1)) >> 1)) *
                                     a.n_lanes + ln];
      row_s[e] = static_cast<uint16_t>(ln * a.R + tgt[i]);
    }
#pragma unroll
    for (int i = 0; i < kSubLoads; ++i) {
      const int x = i * kWarps * 32 + t;
      if (x < 256) sub_s[x] = sub_r[i];
    }
    __syncthreads();  // the rows and the basis are staged

    const int phase = lane_phase(dhgr, ln);
    int d[kPerLane];
    if (a.recompute == 2) {
      // yiq: every cell's window loads in flight together, through L2
      int da[kPerLane], db[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        cell_dots(rows_s, kCellsCta, i * kWarps * 32 + t, ln, tgt[i], dhgr,
                  da[i], db[i]);
      const int L = dhgr ? 7 : 15;
      window_sums<kPerLane>(da, db, a.sub + (size_t)ln * L * 128 * 128, L,
                            d);
    } else {
#pragma unroll
      for (int i0 = 0; i0 < kPerLane; i0 += kChains) {
        int da[kChains], db[kChains];
#pragma unroll
        for (int x = 0; x < kChains; ++x)
          cell_dots(rows_s, kCellsCta, (i0 + x) * kWarps * 32 + t, ln,
                    tgt[i0 + x], dhgr, da[x], db[x]);
        diag_dp_chains(da, db, phase, dhgr ? 10 : 18, sub_s, d + i0);
      }
    }
    __syncthreads();  // every thread is done with the staging
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int e = i * kWarps * 32 + t;
      // a screen hole: no screen byte at this offset
      const int dd = (e & 127) >= 120 ? 0 : d[i];
      up_s[e] = __int2float_rn((dd == 0 ? 0 : up_n[i]) + dd);
      dw_s[e] = __int2float_rn(dd);
    }
  }
  if (a.smid != nullptr && t == 0) a.smid[blockIdx.x] = sm_id();
  const bool seeded = a.keys != nullptr;
  const uint2 key = seeded ? make_uint2(a.keys[2 * movie], a.keys[2 * movie + 1])
                           : make_uint2(0u, 0u);
  // the padding op's content: the target byte at page 0, offset 0
  const int pad = static_cast<uint8_t>(a.bytes_tgt[tb0]);
  float* const up_p = up_s + warp * kOffsets;
  cluster.sync();  // the state is loaded and every CTA of the cluster runs

  int run = 0;  // steps run: the parity picks the score buffer
  for (int s = a.s0; s < a.s0 + a.Sc; ++s) {
    const int nv = a.nvalid[s];
    if (nv == 0) continue;  // a padded step: uniform over the cluster
    const uint2 skey = seeded ? fold_in(key, (uint32_t)s) : make_uint2(0u, 0u);

    // this warp's page score, into every CTA's buffer
    float m = up_p[lane];
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = fmaxf(m, up_p[i * 32 + lane]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float sc = __fmul_rn(m, 256.f);
    if (seeded)
      sc = __fadd_rn(sc, __fmul_rn(uniform_at(fold_in(skey, 0u), page),
                                   255.f));
    float* const buf = score_s[run & 1];
    if (lane < kCluster) cluster.map_shared_rank(buf, lane)[page] = sc;
    __syncwarp();
    cluster.sync();

    // rank_p = #{q: s_q > s_p} + #{q < p: s_q == s_p}
    const float sq = buf[lane], sp = buf[page];
    const int r =
        __popc(__ballot_sync(kFull, sq > sp || (sq == sp && lane < page)));
    if (r < a.k)
      run_slot<kJoint>(a, up_p, dw_s + warp * kOffsets,
                       row_s + warp * kOffsets, by_s + warp * kOffsets,
                       tb_s + warp * kOffsets, movie, s, r, page, nv, seeded,
                       skey, pad, list + warp * kOffsets);
    __syncwarp();
    ++run;
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = i * kWarps * 32 + t;
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

// The kernel's shared-memory attribute (and, past 8 CTAs a cluster, the
// non-portable cluster size), set once per device: they stay set for the
// function in that device's context, and each call costs host time on
// the launch loop.
template <bool kJoint, int kWarps>
cudaError_t set_attributes() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(encode_body_kernel<kJoint, kWarps>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(kJoint, kWarps));
  if (e == cudaSuccess && kPages / kWarps > 8)
    e = cudaFuncSetAttribute(encode_body_kernel<kJoint, kWarps>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// Launch the body kernel on clusters of kPages / kWarps CTAs, one per
// movie; or, with max_clusters != NULL, report
// cudaOccupancyMaxActiveClusters for that configuration instead.
template <bool kJoint, int kWarps>
cudaError_t launch_body(const Body& a, cudaStream_t st, int* max_clusters) {
  constexpr int kCluster = kPages / kWarps;
  cudaError_t e = set_attributes<kJoint, kWarps>();
  if (e != cudaSuccess) return e;
  if (max_clusters) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kWarps * 32);
    cfg.dynamicSmemBytes = smem_bytes(kJoint, kWarps);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(
        max_clusters, encode_body_kernel<kJoint, kWarps>, &cfg);
  }
  encode_body_kernel<kJoint, kWarps>
      <<<a.B * kCluster, kWarps * 32, smem_bytes(kJoint, kWarps), st>>>(a);
  return cudaGetLastError();
}

template <bool kJoint>
cudaError_t launch_cluster(const Body& a, int cluster, cudaStream_t st,
                           int* max_clusters) {
  switch (cluster) {
    case 1: return launch_body<kJoint, 32>(a, st, max_clusters);
    case 2: return launch_body<kJoint, 16>(a, st, max_clusters);
    case 4: return launch_body<kJoint, 8>(a, st, max_clusters);
    case 8: return launch_body<kJoint, 4>(a, st, max_clusters);
    case 16: return launch_body<kJoint, 2>(a, st, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

bool legal_cluster(int c) {
  return c == 1 || c == 2 || c == 4 || c == 8 || c == 16;
}

}  // namespace

extern "C" {

// One chunk body of B movies (see the header).  up, dw, banks: (B, n_banks,
// 32, 256) int32, updated in place at `bank`; lanes_tgt (B, F, 32, 128,
// n_lanes) and bytes_tgt (B, F, 2, 32, 256) int32, read at `frame`; table
// (n_lanes * R, C) int16 with C a power of two; keys (B, 2) uint32 or NULL;
// nvalid (S,) int32; ops (S, B, j, k, 6) uint8.  lane_e / lane_o: the
// bank's lanes for even / odd offsets.  joint: 0 for the default content
// rule, 1 for joint content (C 128 or 256, table 8-byte aligned).
// cluster: CTAs per movie, 1, 2, 4, 8 or 16.  smid: NULL, or (B * cluster,)
// int32 that receives each CTA's SM.  recompute: 0 none; 1 the chunk
// start under the (16, 16) int32 costs `sub`; 2 under the yiq model's
// (n_lanes, L, 128, 128) int32 window costs `sub` (L = 7 for DHGR, 15 for
// HGR); a recompute takes DHGR's (n_banks, n_lanes) = (2, 4) or HGR's
// (1, 2).  Returns a cudaError_t: an attribute's, else the launch's.
int iiv_encode_body(int32_t* up, int32_t* dw, int32_t* banks, int n_banks,
                    int bank, const int32_t* lanes_tgt,
                    const int32_t* bytes_tgt, int F, int frame, int n_lanes,
                    int lane_e, int lane_o, int R, const int16_t* table,
                    int C, const uint32_t* keys, const int32_t* nvalid,
                    int S, int s0, int Sc, int B, int k, int j, uint8_t* ops,
                    int joint, int cluster, int32_t* smid,
                    const int32_t* sub, int recompute, void* stream) {
  if (B < 0 || k < 1 || k > kPages || j < 1 || C < 1 || (C & (C - 1)) != 0 ||
      bank < 0 || bank >= n_banks || frame < 0 || frame >= F || s0 < 0 ||
      Sc < 0 || s0 + Sc > S || R < 1 || R * n_lanes > 65536 ||
      !legal_cluster(cluster) || B > (1 << 30) / cluster)
    return cudaErrorInvalidValue;
  if (joint && ((C != 128 && C != 256) ||
                (reinterpret_cast<uintptr_t>(table) & 7) != 0))
    return cudaErrorInvalidValue;
  if (recompute < 0 || recompute > 2 || (recompute && sub == nullptr) ||
      (recompute && !((n_banks == 2 && n_lanes == 4) ||
                      (n_banks == 1 && n_lanes == 2))))
    return cudaErrorInvalidValue;
  if (B == 0 || (Sc == 0 && !recompute)) return cudaSuccess;
  Body a{up,     dw,      banks,   lanes_tgt, bytes_tgt, table, keys,
         nvalid, ops,     smid,    sub,       B,         n_banks, bank,
         F,      frame,   n_lanes, lane_e,    lane_o,    R,     C,
         s0,     Sc,      k,       j,         recompute};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      joint ? launch_cluster<true>(a, cluster, st, nullptr)
            : launch_cluster<false>(a, cluster, st, nullptr));
}

// cudaOccupancyMaxActiveClusters of the body kernel (rule `joint`) on the
// current device for each cluster size 1, 2, 4, 8, 16: out[0..4].
int iiv_body_max_clusters(int joint, int* out) {
  const Body a{};
  for (int i = 0; i < 5; ++i) {
    const cudaError_t e =
        joint ? launch_cluster<true>(a, 1 << i, nullptr, out + i)
              : launch_cluster<false>(a, 1 << i, nullptr, out + i);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
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

// Kernel A: the diagonal weighted Damerau-Levenshtein distance between
// NTSC colour-code strings, for Hopper (sm_90a).
//
// Replaces iivision_tpu/ops/editdist.py:_editdist_kernel_factory (the Pallas
// TPU kernel launched by pallas_distance), and computes the elementwise forms
// of iivision_tpu/ops/distance.py:dist_lane_pairs and dist_pixel_pairs.
//
// The recurrence is the diagonal reduction of the weighted
// Damerau-Levenshtein distance (csrc/diag_dp.cuh):
//   D[0] = C[a0, b0]
//   D[k] = min(D[k-1] + C[ak, bk], D[k-2] + 1 if a_k == b_{k-1} and
//              a_{k-1} == b_k),  D[-1] = 0.
// Every value is an integer below 2^16, so float32 or int32 registers give
// exactly the float32 result of the TPU kernel.  The TPU kernel built each
// step from 16-wide one-hot matmuls because its only fast unit is the MXU;
// here a step is one shared-memory cost lookup and a few ALU operations.
//
// Three entries:
//
// - editdist_tile: all pairs of two code sets, (n_a, n_b) uint16.  What
//   bounds it: the function's bound is its uint16 stores, 0.040 ms for a
//   DHGR lane (8192^2) and 0.16 ms for an HGR lane (16384^2); its float32
//   operations (an add, two compares and a min per step, on the n(n+1)/2
//   pairs of the symmetric path) take 0.020 and 0.144 ms at the card's
//   float32 peak.  But a step issues several instructions per pair (cost
//   address, load, add, the transposition test, min), so instruction issue
//   is what limits the kernel, and the design cuts the instructions of a
//   step:
//   * register blocking: a thread runs one A string against 8 consecutive
//     B strings, whose codes it keeps in registers, packed one byte per
//     code (code x 4, a byte offset into a cost row); the A string is the
//     same across the warp, so its per-step work (the cost row, the swapped
//     pair to test) is shared by the 8 pairs.  A step of one pair is then a
//     byte extract, an address add, one shared-memory load of the cost, a
//     float add, one byte permute and one compare for the transposition
//     (b's bytes (b_{k-1}, b_k, b_k, b_k) against the A side's (a_k,
//     a_{k-1}, a_{k-1}, a_{k-1}), so no masking), and a predicated add and
//     min;
//   * compile-time string lengths (10 for DHGR, 18 for HGR, the lengths
//     of the LUTs: one instantiation each) so the loop over steps unrolls
//     with no guard and every byte select is a constant; a caller with
//     another length adds an instantiation (the elementwise dist_pairs
//     takes any length up to 32);
//   * coalesced stores: a lane's 8 distances are one 16-byte store, a
//     warp's 32 lanes one 512-byte row segment; a block (8 warps) covers a
//     256 x 256 tile, 32 rows per warp;
//   * symmetry: when the wrapper passes the same code set twice and the
//     cost matrix is symmetric (each block checks it in shared memory),
//     D(a, b) = D(b, a) (the transposition test is symmetric too), so only
//     tiles on or above the diagonal run, and an off-diagonal tile also
//     writes its transpose: each 32-row strip goes through shared memory
//     and out as 64-byte row segments.  The DP work of a LUT lane halves;
//     the stores stay the whole matrix;
//   * no spills: the B codes are staged once per block in shared memory
//     and a row runs as two groups of 4 pairs, so a group's unrolled steps
//     keep their codes and loads in registers (64 registers at L = 10, 80
//     at L = 18).
// - lane_dist: elementwise pairs of masked lane values -> int32, one thread
//   per pair: the store-cost build and the quality scorer (the elementwise
//   form of iivision_tpu/ops/distance.py:dist_lane_pairs for a (16, 16)
//   cost basis, whose lane_pixels and dist_pixel_pairs XLA fuses).  The
//   function needs 12 bytes per pair (two lane values in, one distance
//   out), so the kernel reads exactly those, neighbouring threads on
//   neighbouring words, and derives both strings' colour codes in registers
//   (lane_codes.cuh, the chunk-start kernel's own device code): nothing of
//   length L ever reaches memory.  The mode, and with it L (10 or 18), is
//   compiled in, so the recurrence unrolls with every code in a register.
//   Each side comes as a (rows, cols) view with its own two strides, so a
//   lane sliced out of a (..., n_lanes) array or a column broadcast along
//   a row is read in place.  What bounds it: at the store-cost build's 2^20
//   pairs the bytes take 0.0025-0.0038 ms and the int32 operations (per
//   step a shift and a mask for each code, then an add, two compares and a
//   min) 0.0050 ms at L = 10 and 0.0090 ms at L = 18; the rotates, HGR's
//   dot expansion and the shared-memory cost lookups (random codes collide
//   on banks) come on top, so instruction issue is the limit: 0.0161 ms
//   (DHGR) and 0.0296 ms (HGR) on one H100 80GB HBM3 at 700 W.  At the
//   scorer's 65,536 pairs a launch costs more than the work (0.0031 ms).
// - dist_pairs: elementwise pairs of (..., L) code strings -> int32, one
//   thread per pair, any L up to 32: the counterpart of dist_pixel_pairs
//   for callers that hold codes.  Its loads are strided by L words per
//   thread and are left so (0.0372 ms at 2^20 pairs and L = 10 on the same
//   card, 2.3x lane_dist, against 0.0263 ms for its 84 MB at the memory
//   rate): the port's paths go through lane_dist.
//   (The encoder's chunk-start diff runs the same recurrence inside
//   chunk_start.cu.)

#include <cstdint>
#include <cuda_runtime.h>

#include "diag_dp.cuh"
#include "lane_codes.cuh"

namespace {

constexpr int kMaxL = 32;       // longest string dist_pairs accepts
constexpr int kPairs = 8;       // B strings per thread: one 16-byte store
constexpr int kGroup = 4;       // of which one group's steps run unrolled
constexpr int kWarps = 8;       // A rows per pass: one per warp
constexpr int kTile = 32 * kPairs;        // 256 columns and rows per block
constexpr int kPasses = kTile / kWarps;   // 32 rows per warp
constexpr int kStrip = 32;      // rows per transposed write (4 passes)

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's 256 x 256 tile (tile row blockIdx.y, column blockIdx.x);
// on the symmetric path (`same`: a == b and n_a == n_b, and a symmetric
// cost matrix) only tiles with blockIdx.y <= blockIdx.x run, and those
// above the diagonal also write their transpose.  L: the string length,
// compiled in; costs are read from a float copy of sub in shared memory.
template <int L>
__global__ void __launch_bounds__(kWarps * 32, 2)
editdist_tile_kernel(const int32_t* __restrict__ a, int n_a,
                     const int32_t* __restrict__ b, int n_b,
                     const int32_t* __restrict__ sub, int same,
                     uint16_t* __restrict__ out) {
  constexpr int kWords = (L + 3) / 4;  // 4 code bytes per word
  __shared__ float sub_s[256];
  __shared__ int a_s[kTile * L];  // the tile's A codes x 4, row-major
  // the tile's B codes: string jc + p of lane l (jc = j0 + 8 l), word q at
  // b_s[(p * kWords + q) * 32 + l], so a warp's loads are conflict-free
  __shared__ uint32_t b_s[kPairs * kWords * 32];
  __shared__ __align__(16) uint16_t strip_s[kStrip * kTile];
  const int ti = blockIdx.y, tj = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cost = sub[t];
  sub_s[t] = static_cast<float>(cost);
  // the symmetric path: one code set on both sides (the host's flag) and
  // a symmetric cost matrix, checked here so that the host never waits
  // for the card
  const bool symmetric =
      __syncthreads_and(cost == sub[(t & 15) * 16 + (t >> 4)]) && same;
  if (symmetric && ti > tj) return;
  const bool mirror = symmetric && ti < tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int rows = min(kTile, n_a - i0);
  for (int e = t; e < rows * L; e += kWarps * 32) {
    const int r = e / L;
    a_s[r * L + (e - r * L)] = (a[(size_t)i0 * L + e] & 15) * 4;
  }
  // warp w packs string w of every lane; columns past n_b stay zero and
  // are not stored
  const int jc = j0 + kPairs * lane;
  {
    uint32_t w[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[q] = 0u;
    if (jc + warp < n_b) {
      const int32_t* bs = b + (size_t)(jc + warp) * L;
#pragma unroll
      for (int k = 0; k < L; ++k)
        w[k >> 2] |= static_cast<uint32_t>((bs[k] & 15) * 4) << (8 * (k & 3));
    }
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      b_s[(warp * kWords + q) * 32 + lane] = w[q];
  }
  __syncthreads();

  const char* sub_b = reinterpret_cast<const char*>(sub_s);
  for (int pass = 0; pass < kPasses; ++pass) {
    const int rl = pass * kWarps + warp, i = i0 + rl;
    if (i < n_a) {  // uniform over the warp
      const int* ar = a_s + rl * L;
      float d[kPairs];  // the row's distances
#pragma unroll 1
      for (int g = 0; g < kPairs; g += kGroup) {
        // the group's B strings, in registers for the unrolled steps
        uint32_t bw[kGroup][kWords];
#pragma unroll
        for (int p = 0; p < kGroup; ++p)
#pragma unroll
          for (int q = 0; q < kWords; ++q)
            bw[p][q] = b_s[((g + p) * kWords + q) * 32 + lane];
        float d1[kGroup], d2[kGroup];
        int ak = ar[0];
        const char* row = sub_b + ak * 16;  // sub_s[a][.] at a * 64 bytes
#pragma unroll
        for (int p = 0; p < kGroup; ++p) {
          d1[p] = *reinterpret_cast<const float*>(
              row + __byte_perm(bw[p][0], 0u, 0x4440u));
          d2[p] = 0.f;
        }
#pragma unroll
        for (int k = 1; k < L; ++k) {
          const int ap = ak;
          ak = ar[k];
          row = sub_b + ak * 16;
          // the transposition test, one compare: b's bytes (b_{k-1}, b_k,
          // b_k, b_k) against (a_k, a_{k-1}, a_{k-1}, a_{k-1})
          const uint32_t sw = static_cast<uint32_t>(ak) +
                              static_cast<uint32_t>(ap) * 0x01010100u;
          const uint32_t sel_b = 0x4440u | (k & 3);
          const uint32_t sel_pair = (4u + (k & 3)) * 0x1110u | ((k - 1) & 3);
#pragma unroll
          for (int p = 0; p < kGroup; ++p) {
            const uint32_t bk = __byte_perm(bw[p][k >> 2], 0u, sel_b);
            float dk = d1[p] + *reinterpret_cast<const float*>(row + bk);
            const uint32_t pr =
                __byte_perm(bw[p][(k - 1) >> 2], bw[p][k >> 2], sel_pair);
            if (pr == sw) dk = fminf(dk, d2[p] + 1.f);
            d2[p] = d1[p];
            d1[p] = dk;
          }
        }
#pragma unroll
        for (int p = 0; p < kGroup; ++p) d[g + p] = d1[p];
      }
      uint32_t h[kPairs / 2];
#pragma unroll
      for (int q = 0; q < kPairs / 2; ++q)
        h[q] = static_cast<uint32_t>(__float2int_rn(d[2 * q])) |
               (static_cast<uint32_t>(__float2int_rn(d[2 * q + 1])) << 16);
      const uint4 v = make_uint4(h[0], h[1], h[2], h[3]);
      uint16_t* o = out + (size_t)i * n_b + jc;
      if (jc + kPairs <= n_b && aligned16(o)) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
#pragma unroll
        for (int p = 0; p < kPairs; ++p)
          if (jc + p < n_b)
            o[p] = static_cast<uint16_t>(__float2int_rn(d[p]));
      }
      if (mirror)
        *reinterpret_cast<uint4*>(strip_s + (rl % kStrip) * kTile +
                                  kPairs * lane) = v;
    }
    if (mirror && (pass + 1) % (kStrip / kWarps) == 0) {
      // the strip's rows is .. is+31, transposed: thread t writes row
      // j0 + t of out at columns is .. is+31 (n_a == n_b here)
      __syncthreads();
      const int jt = j0 + t;
      const int is = i0 + (pass + 1) * kWarps - kStrip;
      if (jt < n_a && is < n_a) {
        uint16_t* o = out + (size_t)jt * n_a + is;
        if (is + kStrip <= n_a && aligned16(o)) {
          uint32_t w[kStrip / 2];
#pragma unroll
          for (int q = 0; q < kStrip / 2; ++q)
            w[q] = static_cast<uint32_t>(strip_s[(2 * q) * kTile + t]) |
                   (static_cast<uint32_t>(strip_s[(2 * q + 1) * kTile + t])
                    << 16);
#pragma unroll
          for (int q = 0; q < kStrip / 8; ++q)
            reinterpret_cast<uint4*>(o)[q] =
                make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
        } else {
          for (int r = 0; r < kStrip && is + r < n_a; ++r)
            o[r] = strip_s[r * kTile + t];
        }
      }
      __syncthreads();
    }
  }
}

__global__ void dist_pairs_kernel(const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ b, long long n,
                                  int L, const int32_t* __restrict__ sub,
                                  int32_t* __restrict__ out) {
  __shared__ int sub_s[256];
  for (int e = threadIdx.x; e < 256; e += blockDim.x) sub_s[e] = sub[e];
  __syncthreads();
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) out[p] = diag_dp(a + p * L, 1, b + p * L, 1, L, sub_s);
}

// Pair p = r * cols + c reads a[r * a_rs + c * a_cs] and b likewise.
template <bool kDhgr>
__global__ void __launch_bounds__(256)
lane_dist_kernel(const int32_t* __restrict__ a, long long a_rs,
                 long long a_cs, const int32_t* __restrict__ b,
                 long long b_rs, long long b_cs, unsigned n, unsigned cols,
                 int lane, const int32_t* __restrict__ sub,
                 int32_t* __restrict__ out) {
  constexpr int L = kDhgr ? 10 : 18;
  __shared__ int sub_s[256];
  sub_s[threadIdx.x] = sub[threadIdx.x];
  __syncthreads();
  const unsigned p = blockIdx.x * 256u + threadIdx.x;
  if (p >= n) return;
  const unsigned r = p / cols, c = p - r * cols;
  const int va = a[r * a_rs + c * a_cs], vb = b[r * b_rs + c * b_cs];
  const int da = kDhgr ? va : hgr_to_dots(va, lane);
  const int db = kDhgr ? vb : hgr_to_dots(vb, lane);
  const int phase = lane_phase(kDhgr, lane);
  int ap = lane_code(da, 0, phase), bp = lane_code(db, 0, phase);
  int d_m2 = 0, d_m1 = sub_s[ap * 16 + bp];
#pragma unroll
  for (int k = 1; k < L; ++k)
    diag_dp_step(d_m2, d_m1, ap, bp, lane_code(da, k, phase),
                 lane_code(db, k, phase), sub_s);
  out[p] = d_m1;
}

}  // namespace

extern "C" {

// out[i, j] = D(a[i], b[j]) for a (n_a, L), b (n_b, L) int32 codes, L 10
// or 18; out is (n_a, n_b) uint16, row-major.  sub: (16, 16) int32.
// same: 1 only when a and b are the same codes (n_a == n_b); the kernel
// then takes the symmetric path if sub is symmetric.  Returns the launch's
// cudaError_t.
int iiv_editdist_tile(const int32_t* a, int n_a, const int32_t* b, int n_b,
                      int L, const int32_t* sub, int same, uint16_t* out,
                      void* stream) {
  if ((L != 10 && L != 18) || n_a < 0 || n_b < 0 || (same && n_a != n_b))
    return cudaErrorInvalidValue;
  if (n_a == 0 || n_b == 0) return cudaSuccess;
  const dim3 grid((n_b + kTile - 1) / kTile, (n_a + kTile - 1) / kTile);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 10)
    editdist_tile_kernel<10><<<grid, kWarps * 32, 0, s>>>(
        a, n_a, b, n_b, sub, same, out);
  else
    editdist_tile_kernel<18><<<grid, kWarps * 32, 0, s>>>(
        a, n_a, b, n_b, sub, same, out);
  return static_cast<int>(cudaGetLastError());
}

// out[p] = D(a[p], b[p]) for n pairs of (L,) int32 code strings.
int iiv_dist_pairs(const int32_t* a, const int32_t* b, long long n, int L,
                   const int32_t* sub, int32_t* out, void* stream) {
  if (L < 1 || L > kMaxL || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  dist_pairs_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, b, n, L, sub,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

// out[r * cols + c] = D(lane value a[r * a_rs + c * a_cs], lane value
// b[r * b_rs + c * b_cs]) for rows x cols pairs (fewer than 2^31) of masked
// values of lane `lane` (13-bit DHGR, lanes 0..3; 14-bit HGR, lanes 0..1),
// under the (16, 16) int32 costs sub.  Strides count int32 elements.
int iiv_lane_dist(const int32_t* a, long long a_rs, long long a_cs,
                  const int32_t* b, long long b_rs, long long b_cs,
                  long long rows, long long cols, int dhgr, int lane,
                  const int32_t* sub, int32_t* out, void* stream) {
  if (rows < 0 || cols < 0 || lane < 0 || lane >= (dhgr ? 4 : 2))
    return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  if (rows > (1ll << 31) / cols) return cudaErrorInvalidValue;
  const long long n = rows * cols;
  if (n >= (1ll << 31)) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dhgr)
    lane_dist_kernel<true><<<blocks, 256, 0, s>>>(
        a, a_rs, a_cs, b, b_rs, b_cs, static_cast<unsigned>(n),
        static_cast<unsigned>(cols), lane, sub, out);
  else
    lane_dist_kernel<false><<<blocks, 256, 0, s>>>(
        a, a_rs, a_cs, b, b_rs, b_cs, static_cast<unsigned>(n),
        static_cast<unsigned>(cols), lane, sub, out);
  return static_cast<int>(cudaGetLastError());
}

const char* iiv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Kernel A: the diagonal weighted Damerau-Levenshtein distance between
// NTSC colour-code strings, for Hopper (sm_90a).
//
// Replaces iivision_tpu/ops/editdist.py:_editdist_kernel_factory (the Pallas
// TPU kernel launched by pallas_distance), and computes the elementwise form
// of iivision_tpu/ops/distance.py:dist_pixel_pairs.
//
// The recurrence (diag_dp, csrc/diag_dp.cuh) is the diagonal reduction of
// the weighted Damerau-Levenshtein distance; every value is an integer
// below 2^16, so int32 registers give exactly the float32 result of the TPU
// kernel.  The TPU kernel built each step from 16-wide one-hot matmuls
// because its only fast unit is the MXU; here each step is one
// shared-memory cost lookup and a compare, so there are no one-hots at all.
//
// Two entries share the recurrence (diag_dp):
//
// - editdist_tile: all pairs of two code sets, one thread per (i, j) pair.
//   A block stages its rows of A and B codes (as bytes, transposed so
//   neighbouring threads read neighbouring bytes) and the cost matrix in
//   shared memory, and writes uint16.  What bounds it: a full DHGR table is
//   4 x 8192^2 uint16 = 512 MB of output stores, ~0.16 ms at 3.35 TB/s, and
//   2.7e8 pairs x L steps of shared-memory lookups, compares and adds,
//   which on this simple form take longer than the stores; consecutive
//   threads write consecutive uint16s so every warp's stores coalesce.
// - dist_pairs: elementwise pairs (..., L) -> int32, one thread per pair:
//   the store-cost build and the quality scorer.  (The encoder's chunk-start
//   diff runs the same recurrence inside chunk_start.cu.)

#include <cstdint>
#include <cuda_runtime.h>

#include "diag_dp.cuh"

namespace {

constexpr int kMaxL = 32;   // longest string accepted (DHGR 10, HGR 18)
constexpr int kTileN = 64;  // B strings (columns) per block: threadIdx.x
constexpr int kTileM = 8;   // A strings (rows) per block: threadIdx.y

__global__ void editdist_tile_kernel(const int32_t* __restrict__ a, int n_a,
                                     const int32_t* __restrict__ b, int n_b,
                                     int L, const int32_t* __restrict__ sub,
                                     uint16_t* __restrict__ out) {
  __shared__ int sub_s[256];
  __shared__ uint8_t a_s[kMaxL * kTileM];  // a_s[k * kTileM + row]
  __shared__ uint8_t b_s[kMaxL * kTileN];  // b_s[k * kTileN + col]
  const int tid = threadIdx.y * kTileN + threadIdx.x;
  const int nthreads = kTileN * kTileM;
  const int i0 = blockIdx.y * kTileM, j0 = blockIdx.x * kTileN;
  for (int e = tid; e < 256; e += nthreads) sub_s[e] = sub[e];
  // read the block's code rows in memory order, store them transposed
  for (int e = tid; e < kTileN * L; e += nthreads) {
    const int r = e / L, k = e - r * L, col = j0 + r;
    b_s[k * kTileN + r] =
        col < n_b ? static_cast<uint8_t>(b[(size_t)col * L + k] & 15) : 0;
  }
  for (int e = tid; e < kTileM * L; e += nthreads) {
    const int r = e / L, k = e - r * L, row = i0 + r;
    a_s[k * kTileM + r] =
        row < n_a ? static_cast<uint8_t>(a[(size_t)row * L + k] & 15) : 0;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i < n_a && j < n_b) {
    const int d = diag_dp(a_s + threadIdx.y, kTileM, b_s + threadIdx.x, kTileN,
                          L, sub_s);
    out[(size_t)i * n_b + j] = static_cast<uint16_t>(d);
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

}  // namespace

extern "C" {

// out[i, j] = D(a[i], b[j]) for a (n_a, L), b (n_b, L) int32 codes; out is
// (n_a, n_b) uint16, row-major.  sub: (16, 16) int32.  Returns the launch's
// cudaError_t.
int iiv_editdist_tile(const int32_t* a, int n_a, const int32_t* b, int n_b,
                      int L, const int32_t* sub, uint16_t* out,
                      void* stream) {
  if (L < 1 || L > kMaxL || n_a < 0 || n_b < 0) return cudaErrorInvalidValue;
  if (n_a == 0 || n_b == 0) return cudaSuccess;
  const dim3 block(kTileN, kTileM);
  const dim3 grid((n_b + kTileN - 1) / kTileN, (n_a + kTileM - 1) / kTileM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  editdist_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, n_a, b, n_b, L, sub, out);
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

const char* iiv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The diagonal weighted Damerau-Levenshtein recurrence shared by kernel A
// (editdist.cu) and the body kernel's recompute prologue (body.cu).
//
// For strings a, b of equal length L over 16 colour codes, with a symmetric
// 16x16 integer cost matrix C:
//
//   D[0] = C[a0, b0]
//   D[k] = min(D[k-1] + C[ak, bk],
//              D[k-2] + 1   if a_k == b_{k-1} and a_{k-1} == b_k),  D[-1] = 0
//
// Every value is an integer below 2^16, so int32 registers give exactly the
// float32 result of the JAX package.

#pragma once

// One step of the recurrence: (d_m2, d_m1) = (D[k-2], D[k-1]) and (ap, bp)
// the codes at k-1 come in, (D[k-1], D[k]) and the codes at k go out.  sub
// is the row-major 16x16 cost matrix; codes are 0..15.
__device__ __forceinline__ void diag_dp_step(int& d_m2, int& d_m1, int& ap,
                                             int& bp, int ak, int bk,
                                             const int* sub) {
  int dk = d_m1 + sub[ak * 16 + bk];
  if (ak == bp && ap == bk) dk = min(dk, d_m2 + 1);
  d_m2 = d_m1;
  d_m1 = dk;
  ap = ak;
  bp = bk;
}

// The recurrence over codes a[k * sa], b[k * sb], k < L; sub is the
// row-major 16x16 cost matrix (in shared memory).  Codes are masked to
// 4 bits so no input can index outside it.
template <typename T>
__device__ __forceinline__ int diag_dp(const T* a, int sa, const T* b, int sb,
                                       int L, const int* sub) {
  int ap = a[0] & 15, bp = b[0] & 15;
  int d_m2 = 0, d_m1 = sub[ap * 16 + bp];
  for (int k = 1; k < L; ++k)
    diag_dp_step(d_m2, d_m1, ap, bp, a[k * sa] & 15, b[k * sb] & 15, sub);
  return d_m1;
}

// From a masked lane value to its NTSC colour codes, shared by the body
// kernel's recompute prologue (body.cu) and kernel A's lane-distance entry
// (editdist.cu): the device form of screen.py `hgr_to_dots` and of
// ops/distance.py `lane_pixels`.  Both derive each code when their
// recurrence step needs it, so no code array sits in registers.
//
// A DHGR lane's 13-bit masked value is its dot sequence; an HGR lane's
// 14-bit value expands to 21 dots.  The colour code at dot i is the 4-dot
// window (dots >> i) & 15 rotated left by the NTSC phase (phase + i) mod 4,
// for i < 10 (DHGR) or 18 (HGR).

#pragma once

#include <cstdint>

// Each of bits 0..6 controls two dots; bit 6 spills a third dot (bit 14).
__device__ __forceinline__ int double_pixels(int x) {
  int dp = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int bit = (x >> k) & 1;
    dp |= (bit << (2 * k)) | (bit << (2 * k + 1));
  }
  return dp | (((x >> 6) & 1) << 14);
}

// HGR 14-bit masked value -> 21-bit dot sequence (screen.py hgr_to_dots).
__device__ __forceinline__ int hgr_to_dots(int mv, int byte_offset) {
  const int h = (mv & 0b111) << 5;
  const int hp = (h & 0x80) >> 7;
  int res = double_pixels(h & 0x7F) >> (11 - hp);
  int bp, body;
  if (byte_offset == 0) {
    const int b = (mv >> 3) & 0xFF;
    bp = (b & 0x80) >> 7;
    body = b & 0x7F;
  } else {
    bp = (mv >> 3) & 0x01;
    body = (mv >> 4) & 0x7F;
  }
  res &= ~(0x3FFF << (3 + bp));
  res ^= double_pixels(body) << (3 + bp);
  const int f = (mv >> 12) & 0b11;
  const int fp = (mv >> 11) & 0b01;
  res &= ~(0xF << (17 + fp));
  res ^= double_pixels(f) << (17 + fp);
  return res & 0x1FFFFF;
}

// NTSC phase of each lane's first masked bit: DHGR (1, 0, 3, 2), HGR
// (1, 3).
__device__ __forceinline__ int lane_phase(bool dhgr, int lane) {
  return dhgr ? (lane == 0 ? 1 : lane == 1 ? 0 : lane == 2 ? 3 : 2)
              : (lane == 0 ? 1 : 3);
}

// The colour code at dot i: the 4-dot window there, rotated left by the
// NTSC phase (phase + i) mod 4 (distance.lane_pixels).
__device__ __forceinline__ int lane_code(int dots, int i, int phase) {
  int w = (dots >> i) & 0xF;
  const int r = (phase + i) & 3;
  if (r) w = ((w << r) | (w >> (4 - r))) & 0xF;
  return w;
}

// The code at dot k from the code at dot k - 1.  A dot n sits at bit
// (n + phase) & 3 of every code that holds it, so code k is code k - 1
// with dot k - 1 replaced by dot k + 3, at the same bit.  x is the lane's
// (dots ^ (dots >> 4)) << phase, whose bit k - 1 + phase is that change.
// Four operations a code where lane_code takes about ten; equal to
// lane_code(dots, k, phase) for k >= 1.
__device__ __forceinline__ int lane_code_next(int code, int x, int k,
                                              int phase) {
  const int n = k - 1 + phase;
  return code ^ ((x >> (n & ~3)) & (1 << (n & 3)));
}

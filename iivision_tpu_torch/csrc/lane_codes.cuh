// From a masked lane value to its NTSC colour codes, shared by the
// chunk-start kernel (chunk_start.cu) and kernel A's lane-distance entry
// (editdist.cu): the device form of screen.py `hgr_to_dots` and of
// ops/distance.py `lane_pixels`.
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

// A lane value's L colour codes.
__device__ __forceinline__ void lane_codes(int dots, int L, int phase,
                                           uint8_t* out) {
  for (int i = 0; i < L; ++i)
    out[i] = static_cast<uint8_t>(lane_code(dots, i, phase));
}

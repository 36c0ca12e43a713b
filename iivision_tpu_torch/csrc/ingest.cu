// Device ingest for Hopper (sm_90a): a batch of RGB source frames -> the
// encoder's targets (masked lanes and screen bytes), in one launch.
//
// Replaces no TPU kernel.  The JAX package's batch ingest
// (iivision_tpu/parallel/mesh.py:ingest_movies_batch, `_jitted_batch_ingest`)
// is jnp code that XLA fuses into a few programs; the port's plain form is
// the torch chain of parallel/mesh.py:ingest_chunk (ops/resize.resize_batch,
// ops/dither.quantize_ordered / quantize_hgr, dhgr_codes_to_memory,
// encoder.prepare_targets), some 120-150 small launches a movie, which
// leaves the card waiting on the host.  This kernel computes the same
// function, value for value, with no host round trip.
//
// One template, encode_ingest<Mode>: a block owns the 24 screen rows of 4
// memory pages of one frame (rows y with y & 7 == y0 make pages 4 y0 ..
// 4 y0 + 3), so a page's bytes, and with them its lanes, never leave the
// block.  It walks its rows `rows_per_step` at a time, each stage spread
// over the block's threads and ended by a barrier:
//
// - resize: PIL's Lanczos-3 geometry as banded taps (ops/resize.resize_taps:
//   the nonzero entries of the dense resize_matrix, float32 weights held as
//   float64), the vertical pass first into a float64 row in shared memory,
//   then the horizontal pass, as the chain's two float64 einsums order
//   them; then round half to even, clamp to 0..255 and uint8.  Both axes'
//   taps run, an axis whose size does not change included;
// - quantize: the Bayer perturbation, sRGB to Lab and the nearest palette
//   entry (first index on ties), in the float32 operations of
//   ops/dither._nearest and srgb_to_lab, one operation at a time
//   (__fmul_rn / __fadd_rn, so nothing contracts into an FMA that torch's
//   separate kernels do not run) and powf for the two powers, as torch's
//   pow.  A division by a Python scalar is ATen's on a card: a product with
//   the scalar's reciprocal as a float; a division by a tensor is IEEE
//   division.  16 colours for DHGR, the 6 HGR colours for HGR;
// - pack: DHGR codes to 560 dots to 7-bit aux / main bytes; HGR the
//   palette-bit and majority fit of dither.hgr_dots_to_bytes; both through
//   the rows_to_memory interleave into the block's banks in shared memory;
// - targets: from the banks, bytes_tgt (2, 32, 256) int32 (HGR's one bank
//   twice) and the masked lanes of screen.dhgr_masked_lanes /
//   hgr_masked_lanes, (32, 128, 4) or (32, 128, 2) int32.
//
// What bounds it: a 10 s movie (150 frames of 192x280) reads 24 MB and
// writes 20 MB (0.013 ms at 3.35 TB/s); its nonzero float64 taps, 1.8 M
// FMAs a frame, take 0.016 ms at the card's 33.5 TFLOP/s float64, the
// bound; the Lab math (six powf and n palette scores a pixel) comes on
// top.  Right and simple first: coalesced word loads of the source rows
// through L1/L2, no TMA, no tensor cores.  On an H100 at 700 W a round of
// 32 such movies takes 9.1-9.5 ms, 5.4% of its bound; cutting the stages
// out one at a time shows the time spread over all of them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kOutW = 140;
constexpr int kRows = 24;  // screen rows of a block: 4 pages
constexpr int kBlockPages = 4;
constexpr int kThreads = 256;
constexpr int kMaxPalette = 16;
constexpr float kStrength = 24.0f;  // the ordered dither's perturbation

// The float32 constants of ops/dither.srgb_to_lab as ATen uses them on a
// card: a Python scalar becomes a float, and a division by it a product
// with its reciprocal, taken in double and rounded to float (probed on an
// H100 under PyTorch 2.11 / CUDA 12.8: 1.0 / 1.055 rounds to another float
// than 1.0f / 1.055f, and only the former gives torch's quotients).
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kInv1292 = static_cast<float>(1.0 / 12.92);
constexpr float kInv1055 = static_cast<float>(1.0 / 1.055);
constexpr float kInv116 = static_cast<float>(1.0 / 116.0);
constexpr float kLinCut = static_cast<float>(0.04045);
constexpr float kLinOff = static_cast<float>(0.055);
constexpr float kGamma = static_cast<float>(2.4);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kEps = static_cast<float>(216.0 / 24389.0);
constexpr float kKappa = static_cast<float>(24389.0 / 27.0);

enum class Mode { kDhgr, kHgr };

// Everything a launch reads besides the frames and the tap tables travels
// by value in the kernel's parameters, so the palette scores and the XYZ
// matrix are constant-bank operands of the arithmetic and no load.
struct Ingest {
  const uint8_t* rgb;    // (n_frames, h_in, w_in, 3)
  const int32_t* h_idx;  // (192, kh) source row of each vertical tap
  const double* h_w;     // (192, kh)
  const int32_t* w_idx;  // (140, kw) source column of each horizontal tap
  const double* w_w;     // (140, kw)
  int32_t* lanes;        // (n_frames, 32, 128, n_lanes)
  int32_t* bytes;        // (n_frames, 2, 32, 256)
  int n_frames, h_in, w_in, kh, kw, rows_per_step;
  int whole_words;             // rows start on 4-byte boundaries
  float bayer[64];             // (8, 8) thresholds
  float xyz[12];               // (3, 3) sRGB -> XYZ rows, the (3,) white
  float pal[4 * kMaxPalette];  // (4, n): -2 L, -2 a, -2 b, |p|^2
  int codes[kMaxPalette];      // (n,) colour code of each palette entry
};

// Palette entries a mode's quantizer picks from.
template <Mode kMode>
constexpr int kPaletteSize = kMode == Mode::kHgr ? 6 : 16;

// Row r (0..23) of the block for y0, in screen order: row y = 8 r + y0 =
// 64 y2 + 16 y1hi + 8 y1lo + y0 sits in page 4 y0 + y1hi (`page` counts
// y1hi from the block's first) at offset 128 y1lo + 40 y2 + x (`base` +
// x), as dither.rows_to_memory lays it.
struct Row {
  int y, page, base;
};

__device__ __forceinline__ Row block_row(int y0, int r) {
  const int y = 8 * r + y0;
  return Row{y, (y >> 4) & 3, 128 * ((y >> 3) & 1) + 40 * (y >> 6)};
}

// A byte as a double, exactly, by integer moves and one float64 add (the
// conversion unit's I2F.F64 issues at a quarter of the FMA rate).
__device__ __forceinline__ double byte_to_double(uint32_t v) {
  return __hiloint2double(0x43300000, static_cast<int>(v)) -
         4503599627370496.0;  // 2^52
}

// rint(x) clamped to 0..255, for |x| < 2^51: adding 1.5 * 2^52 rounds to
// an integer, half to even, and leaves it in the low word.
__device__ __forceinline__ int round_to_byte(double x) {
  const int v = __double2loint(x + 6755399441055744.0);
  return min(max(v, 0), 255);
}

// Index of the palette entry nearest in Lab to one perturbed pixel:
// dither._nearest on srgb_to_lab, operation for operation.
template <int kN>
__device__ __forceinline__ int nearest(const uint8_t* px, float off,
                                       const Ingest& a) {
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = fminf(
        fmaxf(__fadd_rn(static_cast<float>(px[c]), off), 0.0f), 255.0f);
    const float v = __fmul_rn(p, kInv255);
    lin[c] = v <= kLinCut
                 ? __fmul_rn(v, kInv1292)
                 : powf(__fmul_rn(__fadd_rn(v, kLinOff), kInv1055), kGamma);
  }
  float f[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float s = __fadd_rn(
        __fadd_rn(__fmul_rn(lin[0], a.xyz[3 * j]),
                  __fmul_rn(lin[1], a.xyz[3 * j + 1])),
        __fmul_rn(lin[2], a.xyz[3 * j + 2]));
    const float t = __fdiv_rn(s, a.xyz[9 + j]);
    f[j] = t > kEps ? powf(fmaxf(t, 0.0f), kThird)
                    : __fmul_rn(__fadd_rn(__fmul_rn(t, kKappa), 16.0f),
                                kInv116);
  }
  const float L = __fsub_rn(__fmul_rn(f[1], 116.0f), 16.0f);
  const float A = __fmul_rn(__fsub_rn(f[0], f[1]), 500.0f);
  const float B = __fmul_rn(__fsub_rn(f[1], f[2]), 200.0f);
  int best = 0;
  float best_score = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float score = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(L, a.pal[k]),
                            __fmul_rn(A, a.pal[kN + k])),
                  __fmul_rn(B, a.pal[2 * kN + k])),
        a.pal[3 * kN + k]);
    if (k == 0 || score < best_score) {
      best = k;
      best_score = score;
    }
  }
  return best;
}

// Dot n (0..560) of a row of 140 colour codes: bit n & 3 of code n >> 2;
// dot 560, past the row, is 0.
__device__ __forceinline__ int dot(const uint8_t* codes, int n) {
  return n < 4 * kOutW ? (codes[n >> 2] >> (n & 3)) & 1 : 0;
}

// dither.hgr_dots_to_bytes for byte column b of one row.
__device__ __forceinline__ int hgr_byte(const uint8_t* codes, int b) {
  int data0 = 0, cost0 = 0, data1 = 0, cost1 = dot(codes, 14 * b);
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const int a0 = dot(codes, 14 * b + 2 * i);
    const int b0 = dot(codes, 14 * b + 2 * i + 1);
    const int d0 = a0 + b0 == 1 ? a0 : (a0 + b0 > 1);
    cost0 += (a0 != d0) + (b0 != d0);
    data0 |= d0 << i;
    const int a1 = dot(codes, 14 * b + 2 * i + 1);
    const int b1 = dot(codes, 14 * b + 2 * i + 2);
    const int d1 = a1 + b1 == 1 ? a1 : (a1 + b1 > 1);
    cost1 += (a1 != d1) + (b1 != d1);
    data1 |= d1 << i;
  }
  return cost1 < cost0 ? data1 | 0x80 : data0;
}

template <Mode kMode>
__global__ void __launch_bounds__(kThreads)
    encode_ingest(const __grid_constant__ Ingest a) {
  constexpr bool kHgr = kMode == Mode::kHgr;
  constexpr int kRowBytes = kHgr ? 40 : 80;  // bytes a row packs
  __shared__ uint8_t main_s[kBlockPages * 256];
  __shared__ uint8_t aux_s[kHgr ? 1 : kBlockPages * 256];
  __shared__ float off_s[8];
  extern __shared__ __align__(16) unsigned char dyn[];

  const int tid = threadIdx.x;
  const int frame = blockIdx.x >> 3;
  const int y0 = blockIdx.x & 7;  // every row of the block has y & 7 == y0
  const int rs = a.rows_per_step;
  const int W3 = a.w_in * 3;
  const int groups = (W3 + 3) >> 2;  // a vertical thread's 4 columns
  double* tmp = reinterpret_cast<double*>(dyn);       // (rs, W3)
  uint8_t* px = dyn + sizeof(double) * rs * W3;       // (rs, 140, 3)
  uint8_t* row_codes = px + rs * kOutW * 3;           // (rs, 140)
  const uint8_t* src = a.rgb + static_cast<size_t>(frame) * a.h_in * W3;

  for (int i = tid; i < kBlockPages * 256; i += kThreads) {
    main_s[i] = 0;  // the holes stay 0
    if (!kHgr) aux_s[i] = 0;
  }
  if (tid < 8)  // (threshold - 0.5) * strength, as _nearest adds it
    off_s[tid] = __fmul_rn(__fsub_rn(a.bayer[8 * y0 + tid], 0.5f),
                           kStrength);
  __syncthreads();

  for (int r0 = 0; r0 < kRows; r0 += rs) {
    // vertical taps: tmp[r, w * 3 + c] for output row y of step row r,
    // four neighbouring columns a thread
    for (int i = tid; i < rs * groups; i += kThreads) {
      const int r = i / groups, j = 4 * (i - r * groups);
      const int y = block_row(y0, r0 + r).y;
      const int32_t* idx = a.h_idx + y * a.kh;
      const double* w = a.h_w + y * a.kh;
      double acc[4] = {0.0, 0.0, 0.0, 0.0};
      for (int k = 0; k < a.kh; ++k) {
        const uint8_t* s = src + idx[k] * W3 + j;
        uint32_t v;
        if (a.whole_words) {
          v = *reinterpret_cast<const uint32_t*>(s);
        } else {
          v = 0;
          for (int q = 0; q < 4 && j + q < W3; ++q) v |= s[q] << (8 * q);
        }
        const double wk = w[k];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = fma(wk, byte_to_double((v >> (8 * q)) & 0xFF), acc[q]);
      }
      double* out = tmp + r * W3 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < W3) out[q] = acc[q];
    }
    __syncthreads();
    // horizontal taps, a pixel's three channels a thread, then round,
    // clamp and uint8
    for (int i = tid; i < rs * kOutW; i += kThreads) {
      const int r = i / kOutW, p = i - r * kOutW;
      const int32_t* idx = a.w_idx + p * a.kw;
      const double* w = a.w_w + p * a.kw;
      const double* row = tmp + r * W3;
      double acc[3] = {0.0, 0.0, 0.0};
      for (int k = 0; k < a.kw; ++k) {
        const double wk = w[k];
        const double* t = row + 3 * idx[k];
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = fma(wk, t[c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        px[3 * i + c] = static_cast<uint8_t>(round_to_byte(acc[c]));
    }
    __syncthreads();
    for (int i = tid; i < rs * kOutW; i += kThreads) {
      const int x = i % kOutW;
      const int k =
          nearest<kPaletteSize<kMode>>(px + 3 * i, off_s[x & 7], a);
      row_codes[i] = static_cast<uint8_t>(a.codes[k]);
    }
    __syncthreads();
    for (int i = tid; i < rs * kRowBytes; i += kThreads) {
      const int r = i / kRowBytes, b = i - r * kRowBytes;
      const Row row = block_row(y0, r0 + r);
      const uint8_t* codes = row_codes + r * kOutW;
      if (kHgr) {
        main_s[row.page * 256 + row.base + b] =
            static_cast<uint8_t>(hgr_byte(codes, b));
      } else {
        int v = 0;
#pragma unroll
        for (int k = 0; k < 7; ++k) v |= dot(codes, 7 * b + k) << k;
        // even bytes of the 80 are aux columns, odd ones main
        uint8_t* bank = (b & 1) ? main_s : aux_s;
        bank[row.page * 256 + row.base + (b >> 1)] = static_cast<uint8_t>(v);
      }
    }
    // each buffer's next write, a step on, comes two barriers after its
    // last read here, so the step needs no fourth barrier
  }
  __syncthreads();

  // bytes_tgt: bank 0 main, bank 1 aux (HGR: main again), the block's 4
  // pages contiguous in each
  const size_t fb = static_cast<size_t>(frame) * 2 * 32 * 256;
  for (int i = tid; i < kBlockPages * 256; i += kThreads) {
    const size_t at = fb + static_cast<size_t>(4 * y0) * 256 + i;
    a.bytes[at] = main_s[i];
    a.bytes[at + 32 * 256] = kHgr ? main_s[i] : aux_s[i];
  }
  // masked lanes of each (page, column)
  for (int i = tid; i < kBlockPages * 128; i += kThreads) {
    const int pl = i >> 7, col = i & 127;
    const uint8_t* m = main_s + pl * 256;
    const size_t at =
        ((static_cast<size_t>(frame) * 32 + 4 * y0 + pl) * 128 + col);
    if (kHgr) {
      const int even = m[2 * col], odd = m[2 * col + 1];
      const int prev_odd = col > 0 ? m[2 * col - 1] : 0;
      const int next_even = col < 127 ? m[2 * col + 2] : 0;
      const int hdr = (prev_odd >> 5) & 7;
      const int ftr = ((next_even >> 7) & 1) | ((next_even & 3) << 1);
      const int packed = hdr | (even << 3) | ((odd & 0x80) << 4) |
                         ((odd & 0x7F) << 12) | (ftr << 19);
      reinterpret_cast<int2*>(a.lanes)[at] =
          make_int2(packed & 0x3FFF, (packed >> 8) & 0x3FFF);
    } else {
      const uint8_t* x = aux_s + pl * 256;
      const int a0 = x[2 * col] & 0x7F, m0 = m[2 * col] & 0x7F;
      const int a1 = x[2 * col + 1] & 0x7F, m1 = m[2 * col + 1] & 0x7F;
      const int hdr = col > 0 ? (m[2 * col - 1] & 0x7F) >> 4 : 0;
      const int ftr = col < 127 ? x[2 * col + 2] & 7 : 0;
      reinterpret_cast<int4*>(a.lanes)[at] =
          make_int4(hdr | (a0 << 3) | ((m0 & 7) << 10),
                    (a0 >> 4) | (m0 << 3) | ((a1 & 7) << 10),
                    (m0 >> 4) | (a1 << 3) | ((m1 & 7) << 10),
                    (a1 >> 4) | (m1 << 3) | (ftr << 10));
    }
  }
}

size_t dynamic_smem(int w_in, int rows_per_step) {
  return static_cast<size_t>(rows_per_step) *
         (sizeof(double) * 3 * w_in + 4 * kOutW);
}

template <Mode kMode>
cudaError_t launch(const Ingest& a, cudaStream_t st) {
  // the banks and the Bayer offsets, static, come on top of the rows
  constexpr size_t kStatic =
      (kMode == Mode::kHgr ? 1 : 2) * kBlockPages * 256 + 8 * sizeof(float);
  const size_t smem = dynamic_smem(a.w_in, a.rows_per_step);
  if (smem + kStatic > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_ingest<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  encode_ingest<kMode><<<a.n_frames * 8, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ingest n_frames RGB frames (n_frames, h_in, w_in, 3) uint8 into lanes
// (n_frames, 32, 128, 4 | 2) and bytes (n_frames, 2, 32, 256) int32.
// h_idx / h_w: (192, kh) vertical taps, w_idx / w_w: (140, kw) horizontal
// taps (int32 source index, float64 weight), on the device.  In host
// memory, copied into the launch's parameters: bayer (8, 8), xyz (12,) and
// pal (4, n_pal) float32, codes (n_pal,) int32, n_pal 16 for DHGR (hgr 0)
// and 6 for HGR (hgr 1).  rows_per_step: 1, 2, 3, 4, 6, 8, 12 or 24 screen
// rows resized at once.  Returns a cudaError_t: the shared-memory
// attribute's, else the launch's.
int iiv_ingest_batch(const uint8_t* rgb, int n_frames, int h_in, int w_in,
                     const int32_t* h_idx, const double* h_w, int kh,
                     const int32_t* w_idx, const double* w_w, int kw,
                     const float* bayer, const float* xyz, const float* pal,
                     const int32_t* codes, int n_pal, int hgr,
                     int rows_per_step, int32_t* lanes, int32_t* bytes,
                     void* stream) {
  if (n_frames < 0 || n_frames > (1 << 27) || h_in < 1 || w_in < 1 ||
      kh < 1 || kw < 1 || (hgr != 0 && hgr != 1) ||
      n_pal != (hgr ? kPaletteSize<Mode::kHgr>
                    : kPaletteSize<Mode::kDhgr>) ||
      rows_per_step < 1 || kRows % rows_per_step != 0 ||
      dynamic_smem(w_in, rows_per_step) > 200 * 1024)
    return cudaErrorInvalidValue;
  if (n_frames == 0) return cudaSuccess;
  const int whole_words =
      (3 * w_in) % 4 == 0 && reinterpret_cast<uintptr_t>(rgb) % 4 == 0;
  Ingest a{rgb,      h_idx, h_w,  w_idx, w_w, lanes,         bytes,
           n_frames, h_in,  w_in, kh,    kw,  rows_per_step, whole_words};
  memcpy(a.bayer, bayer, sizeof(a.bayer));
  memcpy(a.xyz, xyz, sizeof(a.xyz));
  memcpy(a.pal, pal, 4 * n_pal * sizeof(float));
  memcpy(a.codes, codes, n_pal * sizeof(int32_t));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hgr ? launch<Mode::kHgr>(a, st)
                              : launch<Mode::kDhgr>(a, st));
}

}  // extern "C"

// PIL-exact Lanczos resampling (fixed-point, batched over frames).
//
// Re-implements the integer convolution of Pillow's Resample.c 8bpc path
// (PRECISION_BITS = 32-8-2 = 22, round-half-away coefficient quantization,
// uint8 intermediate between the horizontal and vertical passes) so the
// host resize drops the per-frame Image.fromarray/asarray RGBX round trip
// and runs one native call per batch.  Coefficients (bounds + kk) are
// precomputed on the Python side (ops/resize.py _pil_coeffs) with the same
// double-precision filter math Pillow uses; this file only does the
// integer inner loops, bit-identical to PIL by construction (tested in
// tests/test_resize.py against Image.resize on random frames).
//
// Reference counterpart: the reference transcoder resizes every frame with
// PIL at frame_grabber.py:75; there is no native resize there at all.

#include <cstdint>
#include <cstring>

static const int PRECISION_BITS = 32 - 8 - 2;

static inline uint8_t clip8(int32_t in) {
    if (in <= 0) return 0;
    int32_t v = in >> PRECISION_BITS;
    return v > 255 ? 255 : (uint8_t)v;
}

extern "C" {

// Horizontal pass: (N, h, w_in, 3) uint8 -> (N, h, w_out, 3) uint8.
// bounds: (w_out, 2) int32 {xmin, xmax}; kk: (w_out, ksize) int32.
void resample_h_u8(const uint8_t* in, int64_t n_rows, int32_t w_in,
                   int32_t w_out, const int32_t* bounds, const int32_t* kk,
                   int32_t ksize, uint8_t* out) {
    const int32_t half = 1 << (PRECISION_BITS - 1);
    for (int64_t r = 0; r < n_rows; r++) {
        const uint8_t* row = in + r * (int64_t)w_in * 3;
        uint8_t* orow = out + r * (int64_t)w_out * 3;
        for (int32_t xx = 0; xx < w_out; xx++) {
            const int32_t xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
            const int32_t* k = kk + (int64_t)xx * ksize;
            int32_t s0 = half, s1 = half, s2 = half;
            const uint8_t* p = row + (int64_t)xmin * 3;
            for (int32_t x = 0; x < xmax; x++) {
                const int32_t kv = k[x];
                s0 += p[0] * kv;
                s1 += p[1] * kv;
                s2 += p[2] * kv;
                p += 3;
            }
            orow[3 * xx] = clip8(s0);
            orow[3 * xx + 1] = clip8(s1);
            orow[3 * xx + 2] = clip8(s2);
        }
    }
}

// Vertical pass: (N, h_in, w, 3) uint8 -> (N, h_out, w, 3) uint8.
// The accumulator runs over a whole output row (w*3 contiguous int32),
// which auto-vectorizes.
void resample_v_u8(const uint8_t* in, int64_t n_images, int32_t h_in,
                   int32_t h_out, int32_t w, const int32_t* bounds,
                   const int32_t* kk, int32_t ksize, int32_t* scratch,
                   uint8_t* out) {
    const int32_t half = 1 << (PRECISION_BITS - 1);
    const int64_t rowlen = (int64_t)w * 3;
    for (int64_t im = 0; im < n_images; im++) {
        const uint8_t* src = in + im * (int64_t)h_in * rowlen;
        uint8_t* dst = out + im * (int64_t)h_out * rowlen;
        for (int32_t yy = 0; yy < h_out; yy++) {
            const int32_t ymin = bounds[2 * yy], ymax = bounds[2 * yy + 1];
            const int32_t* k = kk + (int64_t)yy * ksize;
            for (int64_t i = 0; i < rowlen; i++) scratch[i] = half;
            for (int32_t y = 0; y < ymax; y++) {
                const int32_t kv = k[y];
                const uint8_t* row = src + (int64_t)(ymin + y) * rowlen;
                for (int64_t i = 0; i < rowlen; i++)
                    scratch[i] += row[i] * kv;
            }
            uint8_t* orow = dst + (int64_t)yy * rowlen;
            for (int64_t i = 0; i < rowlen; i++) orow[i] = clip8(scratch[i]);
        }
    }
}

}  // extern "C"

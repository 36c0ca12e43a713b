// Native host-side frame ingestion: ordered-dither quantize + screen packing.
//
// The decode path is host-resident (video decoders emit host RAM), so the
// quantize-and-pack step in front of the host->device transfer runs here in
// C++: it shrinks the transfer ~6x (8KB screen banks per frame instead of
// RGB) and runs at memory speed on one core - the Python/numpy formulation
// of the same math was gather- and temporary-bound (~0.45s per 150 frames;
// this file does it in ~40ms).
//
// Semantics mirror ops/dither.py exactly:
//  - quantize: Bayer-perturbed nearest-palette-in-Lab, evaluated through a
//    fused (bayer_cell, r>>3, g>>3, b>>3) -> code LUT built by the Python
//    side (dither._host_fused_lut);
//  - dhgr_pack == dither.dhgr_codes_to_memory: pixel x's 4-bit code fills
//    dots 4x..4x+3 LSB-first, dots pack 7-per-byte alternating AUX/MAIN
//    (reference screen.py:819-947), rows map to (page, offset) via the HGR
//    address interleave (reference screen.py:16-69);
//  - hgr_fit == dither.hgr_dots_to_bytes + rows_to_memory: per screen byte,
//    the palette bit + 7 data bits that minimise dot mismatches against the
//    desired 560-dot row (ties prefer palette off; each data bit is the
//    majority of its dot pair, ties to the first dot).

#include <cstdint>
#include <cstring>

namespace {

const int W = 140, H = 192;

// (page, offset) for screen row y (reference screen.py:16-30):
// y = y2*64 + y1*8 + y0 -> page = y0*4 + (y1>>1), offset_base = (y1&1)*128
// + y2*40.
inline void row_addr(int y, int* page, int* off_base) {
    int y2 = y / 64, y1 = (y % 64) / 8, y0 = y % 8;
    *page = y0 * 4 + (y1 >> 1);
    *off_base = (y1 & 1) * 128 + y2 * 40;
}

}  // namespace

extern "C" {

// rgb: (F, 192, 140, 3) uint8; lut: (64 << (3*bits)) uint8 fused bayer LUT
// keyed [cell][r>>(8-bits)][g>>(8-bits)][b>>(8-bits)]; out: (F, 192, 140)
// uint8 colour codes.  bits = channel bin resolution (6 -> 16MB LUT; the
// finer bins cut borderline-pixel divergence vs the exact device quantizer
// roughly in half per extra bit).
void quantize_fused(const uint8_t* rgb, int64_t F, const uint8_t* lut,
                    int bits, uint8_t* out) {
    const int shift = 8 - bits;
    for (int64_t f = 0; f < F; f++) {
        for (int y = 0; y < H; y++) {
            int cy = (y & 7) << 3;
            const uint8_t* row = rgb + ((f * H + y) * W) * 3;
            uint8_t* orow = out + (f * H + y) * W;
            for (int x = 0; x < W; x++) {
                uint32_t cell = (uint32_t)(cy | (x & 7)) << (3 * bits);
                uint32_t key = cell
                    | ((uint32_t)(row[x * 3 + 0] >> shift) << (2 * bits))
                    | ((uint32_t)(row[x * 3 + 1] >> shift) << bits)
                    | (uint32_t)(row[x * 3 + 2] >> shift);
                orow[x] = lut[key];
            }
        }
    }
}

// codes: (F, 192, 140) uint8 -> main/aux: (F, 32, 256) uint8 each.
void dhgr_pack(const uint8_t* codes, int64_t F, uint8_t* main_out,
               uint8_t* aux_out) {
    memset(main_out, 0, (size_t)F * 32 * 256);
    memset(aux_out, 0, (size_t)F * 32 * 256);
    for (int64_t f = 0; f < F; f++) {
        for (int y = 0; y < H; y++) {
            const uint8_t* c = codes + (f * H + y) * W;
            int page, off_base;
            row_addr(y, &page, &off_base);
            uint8_t* mrow = main_out + (f * 32 + page) * 256 + off_base;
            uint8_t* arow = aux_out + (f * 32 + page) * 256 + off_base;
            // 7 codes (28 dots) -> 4 screen bytes AUX,MAIN,AUX,MAIN
            for (int g = 0; g < 20; g++) {
                const uint8_t* cg = c + g * 7;
                uint32_t w = 0;
                for (int k = 0; k < 7; k++)
                    w |= (uint32_t)(cg[k] & 0xF) << (4 * k);
                arow[g * 2 + 0] = w & 0x7F;
                mrow[g * 2 + 0] = (w >> 7) & 0x7F;
                arow[g * 2 + 1] = (w >> 14) & 0x7F;
                mrow[g * 2 + 1] = (w >> 21) & 0x7F;
            }
        }
    }
}

// codes: (F, 192, 140) uint8 HGR colour codes -> main: (F, 32, 256) uint8.
void hgr_fit(const uint8_t* codes, int64_t F, uint8_t* main_out) {
    memset(main_out, 0, (size_t)F * 32 * 256);
    for (int64_t f = 0; f < F; f++) {
        for (int y = 0; y < H; y++) {
            const uint8_t* c = codes + (f * H + y) * W;
            int page, off_base;
            row_addr(y, &page, &off_base);
            uint8_t* mrow = main_out + (f * 32 + page) * 256 + off_base;
            // desired dots: 561 bits (dot 560 = 0 pad for the last byte's
            // palette-on fit), dot d = bit (d & 3) of code[d >> 2]
            uint8_t dots[561];
            for (int x = 0; x < W; x++) {
                uint8_t v = c[x] & 0xF;
                dots[4 * x + 0] = v & 1;
                dots[4 * x + 1] = (v >> 1) & 1;
                dots[4 * x + 2] = (v >> 2) & 1;
                dots[4 * x + 3] = (v >> 3) & 1;
            }
            dots[560] = 0;
            for (int b = 0; b < 40; b++) {
                const uint8_t* g = dots + b * 14;
                int data0 = 0, cost0 = 0, data1 = 0, cost1 = g[0];
                for (int k = 0; k < 7; k++) {
                    // palette off: pair (2k, 2k+1)
                    int a = g[2 * k], bb = g[2 * k + 1];
                    int s = a + bb;
                    int bit = (s == 1) ? a : (s > 1);
                    data0 |= bit << k;
                    cost0 += (a != bit) + (bb != bit);
                    // palette on: pair (2k+1, 2k+2)
                    a = g[2 * k + 1]; bb = g[2 * k + 2];
                    s = a + bb;
                    bit = (s == 1) ? a : (s > 1);
                    data1 |= bit << k;
                    cost1 += (a != bit) + (bb != bit);
                }
                mrow[b] = (cost1 < cost0) ? (uint8_t)(data1 | 0x80)
                                          : (uint8_t)data0;
            }
        }
    }
}

}  // extern "C"

// --- `.a2m` byte emission (mirror of stream/emit_fast.py) --------------------
//
// flat_ops: (n, 6) int32 [page, content, o0..o3]; levels: (n,) int32 in
// -15..16; lut: (32 duty, 32 page) int32 opcode addresses.  Writes header +
// 7-byte tick records + 4-byte ACKs every 2KB segment (291 ops first, 292
// after; DHGR alternates the $54/$55 soft-switch byte) + terminate + zero
// padding.  out must hold emit_size(n) bytes; returns bytes written.

extern "C" int64_t emit_stream(
        const int32_t* flat_ops, const int32_t* levels, int64_t n,
        const int32_t* lut, int32_t ack_addr, int32_t term_addr,
        int32_t mode_byte, int32_t dhgr,
        int32_t ops_first_frame, int32_t ops_per_frame,
        uint8_t* out, int64_t out_cap) {
    // Capacity is checked BEFORE each write region: if the Python-side
    // size formula ever drifts from this emission cadence the result must
    // be a clean -1, not a heap overflow discovered after the fact.
    int64_t p = 0;
    if (out_cap < 7) return -1;
    for (int i = 0; i < 6; i++) out[p++] = 0xFF;
    out[p++] = (uint8_t)mode_byte;

    int64_t pos = 0, seg = 0;
    int aux = 0;
    while (pos < n) {
        int64_t cap = (seg == 0) ? ops_first_frame : ops_per_frame;
        int64_t take = (cap < n - pos) ? cap : n - pos;
        if (p + take * 7 + (take == cap ? 4 : 0) > out_cap) return -1;
        for (int64_t i = pos; i < pos + take; i++) {
            const int32_t* op = flat_ops + i * 6;
            int32_t duty = levels[i] + 15;           // 0..31
            int32_t addr = lut[duty * 32 + (op[0] - 32)];
            out[p++] = (uint8_t)(addr >> 8);
            out[p++] = (uint8_t)(addr & 0xFF);
            out[p++] = (uint8_t)(op[1] & 0xFF);
            out[p++] = (uint8_t)(op[2] & 0xFF);
            out[p++] = (uint8_t)(op[3] & 0xFF);
            out[p++] = (uint8_t)(op[4] & 0xFF);
            out[p++] = (uint8_t)(op[5] & 0xFF);
        }
        pos += take;
        if (take == cap) {
            if (dhgr) aux = !aux;
            out[p++] = (uint8_t)(ack_addr >> 8);
            out[p++] = (uint8_t)(ack_addr & 0xFF);
            out[p++] = aux ? 0x55 : 0x54;
            out[p++] = 0xFF;
        }
        seg++;
    }
    if (p + 2 > out_cap) return -1;
    out[p++] = (uint8_t)(term_addr >> 8);
    out[p++] = (uint8_t)(term_addr & 0xFF);
    int64_t pad = (2048 - (p % 2048)) % 2048;
    if (p + pad > out_cap) return -1;
    for (int64_t i = 0; i < pad; i++) out[p++] = 0;
    return p;
}

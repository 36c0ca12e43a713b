"""Ingest, plain: RGB frames -> target screen banks (main, aux), on the two
paths the port runs (frozen from iivision_tpu_torch's `ops/resize`,
`ops/dither`, `parallel/mesh.ingest_chunk` and `frames` host path).

- `ingest_device`: the batch path.  The Lanczos-3 resize as two float64
  einsums with PIL's geometry, chunk by chunk of `INGEST_CHUNK` frames of
  one movie, then the ordered dither in float32 (a Bayer perturbation and
  the nearest palette colour in Lab), then the DHGR dot packing or the
  HGR palette-bit fit.  control=True resizes in float32.
- `ingest_host`: the solo path.  Pillow's fixed-point Lanczos (int32
  sums of coefficients with 22 fraction bits, a uint8 intermediate
  between passes) in int64 numpy, then the fused ordered-dither LUT
  (channels binned to 6 bits, Lab of the bin centres in float64), then
  the DHGR packing.  The control resizes with int16 coefficients (14
  fraction bits) and builds the LUT's Lab in float32.
"""

import math

import numpy as np
import torch

from benchmark.reference import palettes
from benchmark.reference.palettes import Palette
from benchmark.reference.video_mode import VideoMode

TARGET_W, TARGET_H = 140, 192
INGEST_CHUNK = 256  # frames per device ingest step, as the port chunks
_A = 3.0  # Lanczos support
_PRECISION_BITS = 22  # Pillow's 8bpc fixed point
_CONTROL_BITS = 14  # int16 coefficients
FUSED_LUT_BITS = 6
STRENGTH = 24.0  # the ordered dither's perturbation
HGR_COLOURS = (0b0000, 0b0011, 0b0110, 0b1001, 0b1100, 0b1111)
_BIT_WEIGHTS = [1 << k for k in range(7)]


def bayer_matrix(n: int = 8) -> np.ndarray:
    m = np.array([[0.0]])
    while m.shape[0] < n:
        m = np.block([[4 * m + 0, 4 * m + 2], [4 * m + 3, 4 * m + 1]])
    return (m + 0.5) / (m.size)


# -- the device path ----------------------------------------------------------

def _lanczos3(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < _A, np.sinc(x) * np.sinc(x / _A), 0.0)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 dense resampling matrix, PIL's geometry (the
    kernel widened by the scale when downscaling, taps outside the image
    excluded and the rest renormalized)."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = _A * fscale
    centers = (np.arange(n_out) + 0.5) * scale
    lo = np.floor(centers - support).astype(np.int64)
    hi = np.ceil(centers + support).astype(np.int64)
    width = int((hi - lo).max())
    taps = lo[:, None] + np.arange(width)[None, :]
    w = _lanczos3((taps + 0.5 - centers[:, None]) / fscale)
    w = np.where((taps < hi[:, None]) & (taps >= 0) & (taps < n_in), w, 0.0)
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    idx = np.clip(taps, 0, n_in - 1)
    m = np.zeros((n_out, n_in), dtype=np.float64)
    np.add.at(m, (np.repeat(np.arange(n_out), width), idx.ravel()),
              w.astype(np.float64).ravel())
    return m.astype(np.float32)


def resize_batch(frames: torch.Tensor, h_out: int, w_out: int,
                 control: bool = False) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., h_out, w_out, 3) uint8: out = A_h @
    img @ A_w.T per channel in float64 (float32 for the control), then
    round and clip."""
    dt = torch.float32 if control else torch.float64
    dev = frames.device
    ah = torch.as_tensor(resize_matrix(frames.shape[-3], h_out),
                         device=dev).to(dt)
    aw = torch.as_tensor(resize_matrix(frames.shape[-2], w_out),
                         device=dev).to(dt)
    y = torch.einsum("oh,...hwc->...owc", ah, frames.to(dt))
    y = torch.einsum("pw,...owc->...opc", aw, y)
    return y.round().clamp(0.0, 255.0).to(torch.uint8)


def _combine3(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 3) @ (3, n) as explicit float32 products and sums."""
    return (x[..., 0:1] * m[0] + x[..., 1:2] * m[1]) + x[..., 2:3] * m[2]


def srgb_to_lab_torch(rgb255: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 sRGB in 0..255 -> CIE Lab (D65), float32."""
    dev = rgb255.device
    v = rgb255 / 255.0
    lin = torch.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
    m = torch.as_tensor(palettes._SRGB_TO_XYZ.T, dtype=torch.float32,
                        device=dev)
    t = _combine3(lin, m) / torch.as_tensor(
        palettes._D65_WHITE, dtype=torch.float32, device=dev)
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    f = torch.where(t > eps, t.clamp(min=0.0) ** (1.0 / 3.0),
                    (kappa * t + 16.0) / 116.0)
    return torch.stack([116.0 * f[..., 1] - 16.0,
                        500.0 * (f[..., 0] - f[..., 1]),
                        200.0 * (f[..., 1] - f[..., 2])], dim=-1)


def _palette_lab(palette: Palette) -> np.ndarray:
    return palettes.srgb_to_lab(palettes.palette_rgb_array(palette))


def nearest_codes(rgb: torch.Tensor, lab_pal: torch.Tensor) -> torch.Tensor:
    """Index of the nearest colour of lab_pal (n, 3) to each
    Bayer-perturbed pixel of (..., H, W, 3) RGB: argmin of -2 x.p + |p|^2,
    first index on ties."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    bayer = torch.as_tensor(bayer_matrix(8), dtype=torch.float32,
                            device=rgb.device)
    tiled = bayer.tile((h // 8 + 1, w // 8 + 1))[:h, :w]
    pert = rgb.to(torch.float32) + (tiled[..., None] - 0.5) * STRENGTH
    lab = srgb_to_lab_torch(pert.clamp(0.0, 255.0))
    score = _combine3(lab, -2.0 * lab_pal.T) + (lab_pal ** 2).sum(dim=-1)
    return torch.argmin(score, dim=-1)


def rows_to_memory(by: torch.Tensor) -> torch.Tensor:
    """(..., 192, 40) screen-byte rows -> (..., 32, 256): the HGR address
    interleave plus the 8 hole bytes of each 120-byte half-page."""
    lead = tuple(by.shape[:-2])
    a = by.reshape(lead + (3, 4, 2, 8, 40))
    a = torch.movedim(a, (-2, -4, -3, -5, -1), (-5, -4, -3, -2, -1))
    a = a.reshape(lead + (8, 4, 2, 120))
    pad = torch.zeros(lead + (8, 4, 2, 8), dtype=by.dtype, device=by.device)
    return torch.cat([a, pad], dim=-1).reshape(lead + (32, 256))


def _pack7(bits: torch.Tensor) -> torch.Tensor:
    w = torch.as_tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (bits * w).sum(dim=-1)


def _code_dots(codes: torch.Tensor) -> torch.Tensor:
    """(..., 140) colour codes -> (..., 560) dots: dot 4x+k = bit k of code
    x."""
    c = codes.to(torch.int32)
    return torch.stack([(c >> k) & 1 for k in range(4)],
                       dim=-1).reshape(c.shape[:-1] + (TARGET_W * 4,))


def dhgr_pack(codes: torch.Tensor):
    """(..., 192, 140) colour codes -> (main, aux) (..., 32, 256) uint8:
    7 dots a byte, alternating AUX and MAIN columns."""
    bits = _code_dots(codes)
    by = _pack7(bits.reshape(bits.shape[:-1] + (80, 7))).to(torch.uint8)
    return rows_to_memory(by[..., 1::2]), rows_to_memory(by[..., 0::2])


def hgr_fit(codes: torch.Tensor) -> torch.Tensor:
    """(..., 192, 140) HGR colour codes -> (..., 32, 256) uint8 main: per
    byte the palette bit with fewer dot mismatches (ties: palette off),
    each data bit the majority of its dot pair."""
    d = _code_dots(codes)
    pad = torch.cat([d, torch.zeros(d.shape[:-1] + (1,), dtype=torch.int32,
                                    device=d.device)], dim=-1)
    grp = pad[..., :560].reshape(pad.shape[:-1] + (40, 14))

    def fit(a, b):
        s = a + b
        data = torch.where(s == 1, a, (s > 1).to(torch.int32))
        cost = ((a != data).to(torch.int32)
                + (b != data).to(torch.int32)).sum(dim=-1)
        return data, cost

    data0, cost0 = fit(grp[..., 0::2], grp[..., 1::2])
    win1 = pad[..., 1:561].reshape(pad.shape[:-1] + (40, 14))
    data1, cost1 = fit(win1[..., 0::2], win1[..., 1::2])
    cost1 = cost1 + grp[..., 0]  # the uncovered dot under palette-on
    byte = torch.where(cost1 < cost0, _pack7(data1) | 0x80, _pack7(data0))
    return rows_to_memory(byte.to(torch.uint8))


def ingest_chunk(rgb: torch.Tensor, mode: VideoMode, palette: Palette,
                 control: bool = False):
    """(C, H, W, 3) uint8 frames -> (main, aux) (C, 32, 256) uint8 on the
    frames' device; aux is main for HGR."""
    if rgb.shape[1:3] != (TARGET_H, TARGET_W):
        rgb = resize_batch(rgb, TARGET_H, TARGET_W, control)
    lab = _palette_lab(palette)
    if mode == VideoMode.DHGR:
        pal = torch.as_tensor(lab, dtype=torch.float32, device=rgb.device)
        return dhgr_pack(nearest_codes(rgb, pal).to(torch.int32))
    pal = torch.as_tensor(lab[list(HGR_COLOURS)], dtype=torch.float32,
                          device=rgb.device)
    codes = torch.as_tensor(HGR_COLOURS, dtype=torch.int32,
                            device=rgb.device)
    main = hgr_fit(codes[nearest_codes(rgb, pal)])
    return main, main


def ingest_device(rgb: torch.Tensor, mode: VideoMode, palette: Palette,
                  control: bool = False):
    """One movie's (F, H, W, 3) uint8 frames on its device -> (main, aux)
    (F, 32, 256) uint8, chunk by chunk from its first frame."""
    parts = [ingest_chunk(rgb[f:f + INGEST_CHUNK], mode, palette, control)
             for f in range(0, rgb.shape[0], INGEST_CHUNK)]
    return (torch.cat([m for m, _ in parts]),
            torch.cat([a for _, a in parts]))


# -- the host path ------------------------------------------------------------

def pil_coeffs(n_in: int, n_out: int, bits: int = _PRECISION_BITS):
    """Pillow's fixed-point coefficients of one axis (Resample.c
    precompute_coeffs and normalize_coeffs_8bpc, in double precision,
    rounded half away from zero at 2^bits): (bounds (n_out, 2) {min,
    count}, kk (n_out, ksize) int64)."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = _A * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((n_out, 2), np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    inv = 1.0 / fscale
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        k = [0.0] * xmax
        ww = 0.0
        for x in range(xmax):
            ax = abs((x + xmin - center + 0.5) * inv)
            if ax >= _A:
                w = 0.0
            elif ax == 0.0:
                w = 1.0
            else:
                px = math.pi * ax
                w = (math.sin(px) / px) * (math.sin(px / _A) / (px / _A))
            k[x] = w
            ww += w
        for x in range(xmax):
            v = k[x] / ww * (1 << bits)
            kk[xx, x] = int(v - 0.5) if v < 0 else int(v + 0.5)
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _resample_axis(a: np.ndarray, axis: int, n_out: int,
                   bits: int) -> np.ndarray:
    """One fixed-point pass along `axis` of a uint8 array: the sum of
    pixel x coefficient starts at half a unit, clips below at 0, shifts by
    `bits` and clips at 255.  The sums run as a float64 product with the
    coefficients laid out densely, which is exact: every partial sum is an
    integer below 2^31."""
    n_in = a.shape[axis]
    bounds, kk = pil_coeffs(n_in, n_out, bits)
    dense = np.zeros((n_out, n_in), np.float64)
    for o, (lo, n) in enumerate(bounds):
        dense[o, lo:lo + n] = kk[o, :n]
    x = np.moveaxis(a, axis, -1).astype(np.float64)
    acc = (x @ dense.T).astype(np.int64) + (1 << (bits - 1))
    out = np.where(acc <= 0, 0, np.minimum(acc >> bits, 255))
    return np.moveaxis(out.astype(np.uint8), -1, axis)


def resize_host(frames: np.ndarray, h_out: int, w_out: int,
                control: bool = False) -> np.ndarray:
    """(..., H, W, 3) uint8 -> (..., h_out, w_out, 3): horizontal then
    vertical pass, as Pillow orders them."""
    bits = _CONTROL_BITS if control else _PRECISION_BITS
    out = np.asarray(frames, np.uint8)
    if out.shape[-2] != w_out:
        out = _resample_axis(out, out.ndim - 2, w_out, bits)
    if out.shape[-3] != h_out:
        out = _resample_axis(out, out.ndim - 3, h_out, bits)
    return out


def _srgb_to_lab_np(rgb255: np.ndarray, dtype) -> np.ndarray:
    """palettes.srgb_to_lab computed in `dtype` throughout."""
    v = np.asarray(rgb255, dtype=dtype) / dtype(255.0)
    lin = np.where(v <= dtype(0.04045), v / dtype(12.92),
                   ((v + dtype(0.055)) / dtype(1.055)) ** dtype(2.4))
    xyz = lin @ palettes._SRGB_TO_XYZ.T.astype(dtype)
    t = xyz / palettes._D65_WHITE.astype(dtype)
    eps, kappa = dtype(216.0 / 24389.0), dtype(24389.0 / 27.0)
    f = np.where(t > eps, np.cbrt(t), (kappa * t + dtype(16.0))
                 / dtype(116.0))
    return np.stack([dtype(116.0) * f[..., 1] - dtype(16.0),
                     dtype(500.0) * (f[..., 0] - f[..., 1]),
                     dtype(200.0) * (f[..., 1] - f[..., 2])], axis=-1)


def lut_codes(keys: np.ndarray, palette: Palette,
              control: bool = False) -> np.ndarray:
    """The fused ordered-dither LUT at `keys` ([cell, r, g, b], channels
    binned to 6 bits, 24 bits a key): the nearest of the 16 palette codes
    in Lab to the bin-centre RGB perturbed by Bayer cell `cell`'s
    threshold.  The LUT is evaluated one cell at a time, as the port
    builds it whole, so each entry is the same float64 arithmetic."""
    dt = np.float32 if control else np.float64
    n = 1 << FUSED_LUT_BITS
    pal = _srgb_to_lab_np(palettes.palette_rgb_array(palette), dt)
    bayer = bayer_matrix(8).reshape(64)
    step = 256 // n
    keys = np.asarray(keys, np.int64)
    cells = keys >> (3 * FUSED_LUT_BITS)
    out = np.empty(len(keys), np.uint8)
    for cell in np.unique(cells):
        sel = np.flatnonzero(cells == cell)
        k = keys[sel]
        rgb = np.stack([(k >> (2 * FUSED_LUT_BITS)) & (n - 1),
                        (k >> FUSED_LUT_BITS) & (n - 1), k & (n - 1)],
                       axis=-1) * step + (step - 1) / 2.0
        pert = np.clip(rgb + (bayer[cell] - 0.5) * STRENGTH, 0.0, 255.0)
        lab = _srgb_to_lab_np(pert, dt)
        d = (dt(-2.0) * lab @ pal.T) + np.sum(pal ** 2, axis=1)
        out[sel] = np.argmin(d, axis=1)
    return out


def ingest_host(rgb: np.ndarray, mode: VideoMode, palette: Palette,
                control: bool = False):
    """One movie's (F, H, W, 3) uint8 frames (every encoded one) -> (main,
    aux) (F, 32, 256) uint8 numpy; DHGR only, as the solo cells run."""
    if mode != VideoMode.DHGR:
        raise ValueError("the host path's reference covers DHGR")
    rs = np.concatenate([resize_host(rgb[f:f + 64], TARGET_H, TARGET_W,
                                     control)
                         for f in range(0, len(rgb), 64)]).astype(np.uint32)
    shift = 8 - FUSED_LUT_BITS
    yy = np.arange(TARGET_H)[:, None]
    xx = np.arange(TARGET_W)[None, :]
    cell = (((yy & 7) << 3) | (xx & 7)).astype(np.uint32) \
        << (3 * FUSED_LUT_BITS)
    key = (cell | ((rs[..., 0] >> shift) << (2 * FUSED_LUT_BITS))
           | ((rs[..., 1] >> shift) << FUSED_LUT_BITS) | (rs[..., 2] >> shift))
    uniq, inv = np.unique(key, return_inverse=True)
    codes = lut_codes(uniq, palette, control)[inv].reshape(key.shape)
    main, aux = dhgr_pack(torch.from_numpy(codes.astype(np.int32)))
    return main.numpy(), aux.numpy()

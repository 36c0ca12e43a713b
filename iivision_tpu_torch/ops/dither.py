"""Device quantization and screen-memory packing in torch (counterpart of
iivision_tpu/ops/dither.py: the ordered, HGR and mono quantizers and the
dot packing).

The JAX forms pick numpy or jax.numpy with `screen._xp`, which knows no
torch, so they are written again here on tensors:

- `quantize_ordered` / `quantize_hgr`: a Bayer threshold perturbation, then
  the nearest palette colour in Lab space.  Float32, as in the JAX package.
  torch has no `cbrt` (`t ** (1/3)` stands in) and its `pow` rounds
  differently from XLA's, so the Lab argmin can flip on near-ties: tests
  pin the share of pixels whose code differs from the JAX function.  The
  palette score is written out as three products and sums per entry, not
  as a matmul, so it is true float32 on any device and under any TF32
  setting;
- `quantize_mono`, `rows_to_memory`, `dhgr_dots_to_memory`,
  `dhgr_codes_to_memory`, `hgr_desired_dots`, `hgr_dots_to_bytes`,
  `hgr_bytes_to_memory`: integer-only, bit-exact.

The host quantizers in front of the host ingest (`quantize_ordered_host`,
`dhgr_pack_host`, `quantize_hgr_host`, `quantize_error_diffusion`) are
numpy and C++ (sim/csrc/ingest_fast.cpp, dither.cpp), copied from the JAX
module with the same names, as are the Bayer matrix, the palettes' Lab
values and the HGR colour sets.
"""

import functools
import os
from typing import Optional

import numpy as np
import torch

from iivision_tpu_torch import palettes
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode

DHGR_W, DHGR_H = 140, 192
MONO_W = 560  # full dot resolution of one scanline (DHGR and HGR alike)
# HGR nominal colours reachable per palette bit (codes in HGR code space):
# palette off: black, violet, green, white; on: black, med_blue, orange,
# white
HGR_COLOURS_P0 = (0b0000, 0b0011, 0b1100, 0b1111)
HGR_COLOURS_P1 = (0b0000, 0b0110, 0b1001, 0b1111)
# channel bin resolution of the host fused LUT (16 MB table)
FUSED_LUT_BITS = 6


def _bayer_matrix(n: int = 8) -> np.ndarray:
    m = np.array([[0.0]])
    while m.shape[0] < n:
        m = np.block([[4 * m + 0, 4 * m + 2], [4 * m + 3, 4 * m + 1]])
    return (m + 0.5) / (m.size)  # (n, n) in (0, 1)


@functools.lru_cache(None)
def _palette_lab(palette: Palette) -> np.ndarray:
    return palettes.srgb_to_lab(palettes.palette_rgb_array(palette))


def _lut_cache_path(tag: str) -> str:
    root = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "iivision_tpu")
    return os.path.join(root, "quantize_lut_%s.npy" % tag)


@functools.lru_cache(None)
def _host_fused_lut(palette: Palette, codes: Optional[tuple] = None,
                    strength: float = 24.0,
                    bits: int = FUSED_LUT_BITS) -> np.ndarray:
    """(64 << (3*bits),) uint8 fused quantize LUT: entry [cell, r, g, b]
    (channels binned to `bits`) is the nearest palette code (among
    `codes`, or all 16) in Lab space to the bin-centre RGB perturbed by
    Bayer cell `cell`'s threshold.  Disk-cached in the user cache."""
    n = 1 << bits
    tag = "fused%d_%s_%s_%g" % (
        bits, palette.name,
        "all" if codes is None else "".join("%x" % c for c in codes),
        strength)
    path = _lut_cache_path(tag)
    if os.path.exists(path):
        return np.load(path)
    lab_pal = _palette_lab(palette).astype(np.float64)
    sel = np.arange(16) if codes is None else np.asarray(codes)
    pal = lab_pal[sel]
    bayer = _bayer_matrix(8).reshape(64)
    step = 256 // n
    bins = np.arange(n) * step + (step - 1) / 2.0
    r, g, b = np.meshgrid(bins, bins, bins, indexing="ij")
    rgb = np.stack([r, g, b], axis=-1).reshape(-1, 3)  # (n^3, 3)
    lut = np.empty((64, n * n * n), np.uint8)
    for cell in range(64):
        off = (bayer[cell] - 0.5) * strength
        pert = np.clip(rgb + off, 0.0, 255.0)
        lab = palettes.srgb_to_lab(pert)
        d = (-2.0 * lab @ pal.T) + np.sum(pal ** 2, axis=1)
        lut[cell] = sel[np.argmin(d, axis=1)]
    lut = lut.reshape(-1)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".%d.tmp" % os.getpid()
        with open(tmp, "wb") as f:
            np.save(f, lut)
        os.replace(tmp, path)
    except OSError:
        pass
    return lut


def quantize_ordered_host(rgb: np.ndarray, palette: Palette,
                          strength: float = 24.0) -> np.ndarray:
    """Host ordered-dither quantizer (C++ fused LUT): (..., 192, 140, 3)
    uint8 -> (..., 192, 140) uint8 codes."""
    from iivision_tpu_torch.sim import native

    return native.quantize_fused(np.ascontiguousarray(rgb, np.uint8),
                                 _host_fused_lut(palette, None, strength))


def dhgr_pack_host(codes: np.ndarray):
    """(..., 192, 140) codes -> (main, aux) (..., 32, 256) uint8 (C++),
    bit-identical to `dhgr_codes_to_memory`."""
    from iivision_tpu_torch.sim import native

    return native.dhgr_pack(np.ascontiguousarray(codes, np.uint8))


def quantize_hgr_host(rgb: np.ndarray, palette: Palette) -> np.ndarray:
    """Host HGR quantizer: 6-colour fused-LUT dither + C++ dot fitting,
    (..., 192, 140, 3) uint8 -> (..., 32, 256) uint8 main."""
    from iivision_tpu_torch.sim import native

    hgr_codes = tuple(sorted(set(HGR_COLOURS_P0) | set(HGR_COLOURS_P1)))
    codes = native.quantize_fused(np.ascontiguousarray(rgb, np.uint8),
                                  _host_fused_lut(palette, hgr_codes))
    return native.hgr_fit(codes)


def quantize_error_diffusion(rgb: np.ndarray, palette: Palette,
                             kernel: str = "buckels") -> np.ndarray:
    """Error-diffusion quantization on the host (C++): serpentine float
    diffusion ('floyd', 'buckels', 'atkinson', 'jarvis') or bmp2dhr's
    raster mechanics ('d1'..'d9').  rgb: (192, 140, 3).  Returns (192, 140)
    int32 colour codes."""
    from iivision_tpu_torch.sim import native

    if kernel.startswith("d") and kernel[1:].isdigit():
        d = int(kernel[1:])
        if not 1 <= d <= 9:
            raise ValueError("unknown bmp2dhr dither %r (d1..d9)" % kernel)
        return native.dither_bmp2dhr(
            np.ascontiguousarray(np.clip(rgb, 0, 255), dtype=np.uint8),
            palettes.palette_rgb_array(palette).astype(np.uint8), d)
    return native.dither(np.ascontiguousarray(rgb, dtype=np.float32),
                         palettes.palette_rgb_array(palette), kernel)


_BIT_WEIGHTS = [1 << k for k in range(7)]


def _bayer_tile(h: int, w: int, device) -> torch.Tensor:
    bayer = torch.as_tensor(_bayer_matrix(8), dtype=torch.float32,
                            device=device)
    return bayer.tile((h // 8 + 1, w // 8 + 1))[:h, :w]


def _combine3(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 3) @ (3, n) as explicit float32 products and sums."""
    return (x[..., 0:1] * m[0] + x[..., 1:2] * m[1]) + x[..., 2:3] * m[2]


def srgb_to_lab(rgb255: torch.Tensor) -> torch.Tensor:
    """(..., 3) float32 sRGB in 0..255 -> (..., 3) CIE Lab (D65)."""
    dev = rgb255.device
    v = rgb255 / 255.0
    lin = torch.where(v <= 0.04045, v / 12.92,
                      ((v + 0.055) / 1.055) ** 2.4)
    m = torch.as_tensor(palettes._SRGB_TO_XYZ.T, dtype=torch.float32,
                        device=dev)
    xyz = _combine3(lin, m)
    t = xyz / torch.as_tensor(palettes._D65_WHITE, dtype=torch.float32,
                              device=dev)
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    f = torch.where(t > eps, t.clamp(min=0.0) ** (1.0 / 3.0),
                    (kappa * t + 16.0) / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def _nearest(rgb: torch.Tensor, lab_pal: torch.Tensor,
             strength: float) -> torch.Tensor:
    """Index into lab_pal (n, 3) of the nearest colour in Lab space to each
    Bayer-perturbed pixel of (..., H, W, 3) RGB: argmin of -2 x.p + |p|^2,
    first index on ties."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    tiled = _bayer_tile(h, w, rgb.device)
    pert = rgb.to(torch.float32) + (tiled[..., None] - 0.5) * strength
    lab = srgb_to_lab(pert.clamp(0.0, 255.0))
    score = _combine3(lab, -2.0 * lab_pal.T) + (lab_pal ** 2).sum(dim=-1)
    return torch.argmin(score, dim=-1)


def quantize_ordered(rgb: torch.Tensor, palette: Palette,
                     strength: float = 24.0) -> torch.Tensor:
    """Ordered-dither quantization of (..., 192, 140, 3) RGB to (..., 192,
    140) int32 colour codes (HGR code space)."""
    lab_pal = torch.as_tensor(_palette_lab(palette), dtype=torch.float32,
                              device=rgb.device)
    return _nearest(rgb, lab_pal, strength).to(torch.int32)


def quantize_hgr(rgb: torch.Tensor, palette: Palette) -> torch.Tensor:
    """HGR quantization: ordered dither over the 6 HGR colours, then the
    desired-dot fit of palette and data bits.  (..., 192, 140, 3) RGB ->
    (..., 32, 256) uint8 main memory."""
    codes6 = sorted(set(HGR_COLOURS_P0) | set(HGR_COLOURS_P1))
    lab_pal = torch.as_tensor(_palette_lab(palette)[codes6],
                              dtype=torch.float32, device=rgb.device)
    pick = _nearest(rgb, lab_pal, 24.0)
    codes = torch.as_tensor(codes6, dtype=torch.int32, device=rgb.device)
    dots = hgr_desired_dots(codes[pick])
    return hgr_bytes_to_memory(hgr_dots_to_bytes(dots))


def quantize_mono(rgb: torch.Tensor, mode: VideoMode):
    """Monochrome-monitor quantizer: integer Rec.601 luma of (..., 192, 560,
    3) RGB against an 8x8 Bayer threshold at full dot resolution, then the
    mode's byte packing.  Returns (main, aux), (main, None) for HGR."""
    v = rgb.to(torch.int32)
    luma = 77 * v[..., 0] + 150 * v[..., 1] + 29 * v[..., 2]  # 0..65280
    bay = np.round(_bayer_matrix(8) * 65280.0).astype(np.int32)
    h, w = rgb.shape[-3], rgb.shape[-2]
    thr = torch.as_tensor(np.tile(bay, (h // 8 + 1, w // 8 + 1))[:h, :w],
                          device=rgb.device)
    dots = (luma > thr).to(torch.uint8)
    if mode == VideoMode.DHGR:
        return dhgr_dots_to_memory(dots)
    return hgr_bytes_to_memory(hgr_dots_to_bytes(dots)), None


def rows_to_memory(by: torch.Tensor) -> torch.Tensor:
    """(..., 192, 40) screen-byte rows -> (..., 32, 256) memory map: the
    HGR address interleave as an axis permutation plus the 8 hole bytes
    that pad each 120-byte half-page to 128."""
    lead = tuple(by.shape[:-2])
    a = by.reshape(lead + (3, 4, 2, 8, 40))  # [y2][y1hi][y1lo][y0][x]
    a = torch.movedim(a, (-2, -4, -3, -5, -1), (-5, -4, -3, -2, -1))
    a = a.reshape(lead + (8, 4, 2, 120))
    pad = torch.zeros(lead + (8, 4, 2, 8), dtype=by.dtype, device=by.device)
    return torch.cat([a, pad], dim=-1).reshape(lead + (32, 256))


def _pack7(bits: torch.Tensor) -> torch.Tensor:
    """(..., n, 7) 0/1 ints -> (..., n) int64 bytes, LSB first."""
    w = torch.as_tensor(_BIT_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (bits * w).sum(dim=-1)


def dhgr_dots_to_memory(dots: torch.Tensor):
    """(..., 192, 560) 0/1 dots -> (main, aux) (..., 32, 256) uint8, 7 dots
    per byte alternating AUX/MAIN columns."""
    bits = dots.to(torch.int32)
    by = _pack7(bits.reshape(bits.shape[:-1] + (80, 7))).to(torch.uint8)
    return rows_to_memory(by[..., 1::2]), rows_to_memory(by[..., 0::2])


def _code_dots(codes: torch.Tensor) -> torch.Tensor:
    """(..., 140) colour codes -> (..., 560) dots: dot 4x+k = bit k of code
    x."""
    c = codes.to(torch.int32)
    return torch.stack([(c >> k) & 1 for k in range(4)],
                       dim=-1).reshape(c.shape[:-1] + (DHGR_W * 4,))


def dhgr_codes_to_memory(codes: torch.Tensor):
    """(..., 192, 140) colour codes -> (main, aux) (..., 32, 256) uint8."""
    return dhgr_dots_to_memory(_code_dots(codes))


def hgr_desired_dots(codes: torch.Tensor) -> torch.Tensor:
    """(..., 192, 140) colour codes -> desired (..., 192, 560) dots on the
    14M grid (the DHGR dot expansion)."""
    return _code_dots(codes)


def hgr_dots_to_bytes(dots: torch.Tensor) -> torch.Tensor:
    """Fit screen bytes (palette bit + 7 data bits) to desired dot rows:
    each byte picks the palette bit with fewer dot mismatches (ties prefer
    palette off), data bits the majority of their dot pair.  (..., 192,
    560) -> (..., 192, 40) uint8."""
    d = dots.to(torch.int32)
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
    # the uncovered dot 14b under palette-on counts as a mismatch if set
    cost1 = cost1 + grp[..., 0]
    byte0 = _pack7(data0)
    byte1 = _pack7(data1) | 0x80
    return torch.where(cost1 < cost0, byte1, byte0).to(torch.uint8)


def hgr_bytes_to_memory(by: torch.Tensor) -> torch.Tensor:
    """(..., 192, 40) screen bytes -> (..., 32, 256) main memory map."""
    return rows_to_memory(by)


def frame_to_memory(rgb, mode: VideoMode, palette: Palette,
                    dither: str = "ordered", *, device):
    """One RGB frame (192, 140, 3) -> (main, aux | None) (32, 256) uint8
    memory maps on `device`: the device quantizers for the ordered dither,
    the host error diffusion (C++) for any other."""
    if mode == VideoMode.DHGR:
        if dither == "ordered":
            codes = quantize_ordered(torch.as_tensor(rgb, device=device),
                                     palette)
        else:
            codes = torch.as_tensor(
                quantize_error_diffusion(np.asarray(rgb), palette,
                                         kernel=dither), device=device)
        return dhgr_codes_to_memory(codes)
    return quantize_hgr(torch.as_tensor(rgb, device=device), palette), None

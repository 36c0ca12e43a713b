"""The NTSC composite (YIQ) colour model (counterpart of
iivision_tpu/ops/yiq.py).

Each dot position is decoded from a 7-dot window: luma by a low-pass, chroma
by quadrature demodulation, with the luma affine and the complex chroma
gain calibrated by least squares so that solid 4-dot patterns reproduce the
16 palette colours.  Distances between decoded pixels are
integer-truncated CIEDE2000.  The decode, calibration and per-position
cost matrices (`lane_subs`) are numpy, built once per (mode, palette); the
window codes the encoder derives per chunk (`lane_windows`) are torch.
"""

import functools

import numpy as np
import torch

from iivision_tpu_torch import palettes
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.screen import spec_for_mode
from iivision_tpu_torch.video_mode import VideoMode, require_mode

WIN = 7  # dots per decoded pixel: 3-dot halos bound the usable support
# luma low-pass (sharper) and chroma low-pass (wider), both unit-sum
W_Y = np.array([0.0, 1.0, 2.0, 2.0, 2.0, 1.0, 0.0]) / 8.0
W_C = np.sin(np.pi * (np.arange(WIN) + 1) / (WIN + 1)) ** 2
W_C = W_C / W_C.sum()
_COS = np.array([1.0, 0.0, -1.0, 0.0])
_SIN = np.array([0.0, 1.0, 0.0, -1.0])
# FCC NTSC YIQ -> RGB
_YIQ_TO_RGB = np.array([[1.0, 0.956, 0.621],
                        [1.0, -0.272, -0.647],
                        [1.0, -1.106, 1.703]])
_RGB_TO_YIQ = np.linalg.inv(_YIQ_TO_RGB)


def _decode_raw(bits, centre_phase):
    """bits: (..., 7) 0/1 dots; dot k sits at carrier phase (centre_phase
    + k - 3) mod 4.  Returns raw (Y, I, Q) before calibration."""
    ph = (centre_phase + np.arange(WIN) - 3) % 4
    y = bits @ W_Y
    i = bits @ (W_C * _COS[ph]) * 2.0
    q = bits @ (W_C * _SIN[ph]) * 2.0
    return y, i, q


@functools.lru_cache(None)
def _calibration(palette: Palette):
    """Least-squares (luma affine, complex chroma gain) anchoring solid
    4-dot patterns to the 16 palette colours."""
    rgb = palettes.palette_rgb_array(palette).astype(np.float64) / 255.0
    yiq_t = rgb @ _RGB_TO_YIQ.T  # (16, 3) target Y/I/Q
    ys, cs = [], []
    for code in range(16):
        bits = np.array([(code >> ((0 + k - 3) % 4)) & 1
                         for k in range(WIN)], np.float64)
        y, i, q = _decode_raw(bits, 0)
        ys.append(y)
        cs.append(i + 1j * q)
    ys = np.asarray(ys)
    cs = np.asarray(cs)
    ct = yiq_t[:, 1] + 1j * yiq_t[:, 2]
    A = np.stack([ys, np.ones(16)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, yiq_t[:, 0], rcond=None)
    denom = float(np.sum(np.abs(cs) ** 2))
    g = complex(np.sum(ct * np.conj(cs)) / denom) if denom > 0 else 0j
    return float(a), float(b), g


def decode_windows(codes, centre_phase: int, palette: Palette):
    """7-bit window codes -> calibrated sRGB in [0, 255] (..., 3)."""
    codes = np.asarray(codes)
    bits = ((codes[..., None] >> np.arange(WIN)) & 1).astype(np.float64)
    y, i, q = _decode_raw(bits, centre_phase)
    a, b, g = _calibration(palette)
    yy = a * y + b
    c = g * (i + 1j * q)
    yiq = np.stack([yy, c.real, c.imag], axis=-1)
    rgb = np.clip(yiq @ _YIQ_TO_RGB.T, 0.0, 1.0)
    return rgb * 255.0


@functools.lru_cache(None)
def pair_lut(palette: Palette) -> np.ndarray:
    """(4, 128, 128) int32: CIEDE2000 between decoded 7-bit windows at each
    centre phase (integer-truncated)."""
    out = np.zeros((4, 128, 128), np.int32)
    for p in range(4):
        lab = palettes.srgb_to_lab(decode_windows(np.arange(128), p,
                                                  palette))
        d = palettes.delta_e_cie2000(lab[:, None, :], lab[None, :, :])
        out[p] = d.astype(np.int32)
    return out


def n_pixels(mode: VideoMode) -> int:
    """Centred 7-dot pixels that fit in a lane's dot sequence (13 DHGR
    dots, 21 HGR dots)."""
    return (13 if require_mode(mode) == VideoMode.DHGR else 21) - 6


@functools.lru_cache(None)
def lane_subs(mode: VideoMode, palette: Palette) -> np.ndarray:
    """(n_lanes, L, 128, 128) float32 per-position pair-cost matrices:
    pixel j (centre dot j+3) sits at carrier phase (PHASES[lane] + j + 3)
    mod 4."""
    spec = spec_for_mode(mode)
    lut = pair_lut(palette)
    L = n_pixels(mode)
    subs = np.zeros((int(spec.N_LANES), L, 128, 128), np.float32)
    for lane in range(int(spec.N_LANES)):
        for j in range(L):
            subs[lane, j] = lut[(spec.PHASES[lane] + j + 3) % 4]
    return subs


def lane_windows(vals: torch.Tensor, mode: VideoMode,
                 lane: int) -> torch.Tensor:
    """(...) masked lane values -> (..., L) int32 7-bit centred window
    codes; window j covers dots [j, j+6] of the lane's dot sequence."""
    dots = spec_for_mode(mode).to_dots(vals.to(torch.int32), lane)
    return torch.stack([(dots >> j) & 0x7F for j in range(n_pixels(mode))],
                       dim=-1)

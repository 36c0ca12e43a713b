"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/palettes.py, which this package never imports.

RGB palettes and the CIE2000 colour metric (the port's copy of
iivision_tpu/palettes.py).

Palette RGB values are BMP2DHR's NTSC and KEGS32/IIGS palettes; palette ids
(NTSC=5, IIGS=0) appear in data-table filenames.  RGB tables are keyed by
the HGR 4-bit colour codes.  CIE2000 follows Sharma et al. 2005, with the
Lindbloom sRGB matrix and the D65 2-degree white point.
"""

import enum
from typing import Dict

import numpy as np

from benchmark.reference.colours import HGRColours

C = HGRColours


class Palette(enum.Enum):
    """BMP2DHR palette numbers (part of the file naming ABI)."""
    UNKNOWN = -1
    IIGS = 0
    NTSC = 5


def require_palette(palette) -> "Palette":
    """`palette` if it is this package's Palette; TypeError otherwise."""
    if not isinstance(palette, Palette):
        raise TypeError("the reference takes its own Palette "
                        "(benchmark.reference.palettes.Palette), got %r of %s"
                        % (palette, type(palette).__module__))
    return palette


NTSC_RGB: Dict[HGRColours, tuple] = {
    C.BLACK: (0, 0, 0),
    C.MAGENTA: (148, 12, 125),
    C.BROWN: (99, 77, 0),
    C.ORANGE: (249, 86, 29),
    C.DARK_GREEN: (51, 111, 0),
    C.GREY1: (126, 126, 126),
    C.GREEN: (67, 200, 0),
    C.YELLOW: (221, 206, 23),
    C.DARK_BLUE: (32, 54, 212),
    C.VIOLET: (188, 55, 255),
    C.GREY2: (126, 126, 126),
    C.PINK: (255, 129, 236),
    C.MED_BLUE: (7, 168, 225),
    C.LIGHT_BLUE: (158, 172, 255),
    C.AQUA: (93, 248, 133),
    C.WHITE: (255, 255, 255),
}

IIGS_RGB: Dict[HGRColours, tuple] = {
    C.BLACK: (0, 0, 0),
    C.MAGENTA: (221, 0, 51),
    C.BROWN: (136, 85, 34),
    C.ORANGE: (255, 102, 0),
    C.DARK_GREEN: (0, 119, 0),
    C.GREY1: (85, 85, 85),
    C.GREEN: (0, 221, 0),
    C.YELLOW: (255, 255, 0),
    C.DARK_BLUE: (0, 0, 153),
    C.VIOLET: (221, 0, 221),
    C.GREY2: (170, 170, 170),
    C.PINK: (255, 153, 136),
    C.MED_BLUE: (34, 34, 255),
    C.LIGHT_BLUE: (102, 170, 255),
    C.AQUA: (0, 255, 153),
    C.WHITE: (255, 255, 255),
}

PALETTE_RGB: Dict[Palette, Dict[HGRColours, tuple]] = {
    Palette.NTSC: NTSC_RGB,
    Palette.IIGS: IIGS_RGB,
}


def palette_rgb_array(palette: Palette) -> np.ndarray:
    """(16, 3) float array of RGB values indexed by HGR colour code."""
    rgb = PALETTE_RGB[palette]
    out = np.zeros((16, 3), dtype=np.float64)
    for colour, v in rgb.items():
        out[colour.value] = v
    return out


_SRGB_TO_XYZ = np.array([
    [0.412424, 0.357579, 0.180464],
    [0.212656, 0.715158, 0.072186],
    [0.019332, 0.119193, 0.950444],
])
_D65_WHITE = np.array([0.95047, 1.00000, 1.08883])


def srgb_to_lab(rgb255: np.ndarray) -> np.ndarray:
    """Convert (..., 3) sRGB values in 0..255 to CIELAB (D65/2-deg)."""
    v = np.asarray(rgb255, dtype=np.float64) / 255.0
    lin = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
    xyz = lin @ _SRGB_TO_XYZ.T
    t = xyz / _D65_WHITE
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    f = np.where(t > eps, np.cbrt(t), (kappa * t + 16.0) / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def delta_e_cie2000(lab1: np.ndarray, lab2: np.ndarray) -> np.ndarray:
    """CIEDE2000 colour difference, broadcast over leading dimensions of
    (..., 3) Lab inputs."""
    lab1 = np.asarray(lab1, dtype=np.float64)
    lab2 = np.asarray(lab2, dtype=np.float64)
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]

    kL = kC = kH = 1.0
    C1 = np.hypot(a1, b1)
    C2 = np.hypot(a2, b2)
    Cbar = (C1 + C2) / 2.0
    G = 0.5 * (1.0 - np.sqrt(Cbar ** 7 / (Cbar ** 7 + 25.0 ** 7)))
    a1p = (1.0 + G) * a1
    a2p = (1.0 + G) * a2
    C1p = np.hypot(a1p, b1)
    C2p = np.hypot(a2p, b2)
    h1p = np.degrees(np.arctan2(b1, a1p)) % 360.0
    h2p = np.degrees(np.arctan2(b2, a2p)) % 360.0

    dLp = L2 - L1
    dCp = C2p - C1p
    dh = h2p - h1p
    dhp = np.where(np.abs(dh) <= 180.0, dh,
                   np.where(dh > 180.0, dh - 360.0, dh + 360.0))
    # hue difference is undefined (zero) when either chroma is zero
    dhp = np.where((C1p * C2p) == 0.0, 0.0, dhp)
    dHp = 2.0 * np.sqrt(C1p * C2p) * np.sin(np.radians(dhp) / 2.0)

    Lbp = (L1 + L2) / 2.0
    Cbp = (C1p + C2p) / 2.0
    hsum = h1p + h2p
    habs = np.abs(h1p - h2p)
    hbp = np.where(
        (C1p * C2p) == 0.0, hsum,
        np.where(habs <= 180.0, hsum / 2.0,
                 np.where(hsum < 360.0, (hsum + 360.0) / 2.0,
                          (hsum - 360.0) / 2.0)))

    T = (1.0
         - 0.17 * np.cos(np.radians(hbp - 30.0))
         + 0.24 * np.cos(np.radians(2.0 * hbp))
         + 0.32 * np.cos(np.radians(3.0 * hbp + 6.0))
         - 0.20 * np.cos(np.radians(4.0 * hbp - 63.0)))
    dtheta = 30.0 * np.exp(-(((hbp - 275.0) / 25.0) ** 2))
    RC = 2.0 * np.sqrt(Cbp ** 7 / (Cbp ** 7 + 25.0 ** 7))
    SL = 1.0 + (0.015 * (Lbp - 50.0) ** 2) / np.sqrt(20.0 + (Lbp - 50.0) ** 2)
    SC = 1.0 + 0.045 * Cbp
    SH = 1.0 + 0.015 * Cbp * T
    RT = -np.sin(np.radians(2.0 * dtheta)) * RC

    return np.sqrt(
        (dLp / (kL * SL)) ** 2
        + (dCp / (kC * SC)) ** 2
        + (dHp / (kH * SH)) ** 2
        + RT * (dCp / (kC * SC)) * (dHp / (kH * SH)))


def diff_matrix(palette: Palette) -> np.ndarray:
    """16x16 int32 matrix of CIE2000 distances between palette colours,
    indexed by HGR 4-bit colour codes and truncated to integers."""
    lab = srgb_to_lab(palette_rgb_array(palette))
    d = delta_e_cie2000(lab[:, None, :], lab[None, :, :])
    return d.astype(np.int32)

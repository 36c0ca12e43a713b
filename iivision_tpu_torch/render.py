"""Render (D)HGR screen memory to RGB via the NTSC colour model (the port's
copy of iivision_tpu/render.py: numpy on the host, same names).

The inverse of ops/dither.py, so encoded streams can be visualised and
scored (PSNR, `quality.stream_psnr`) against source frames.

DHGR: pixel x of a row occupies dots 4x..4x+3 at NTSC phase 0, so its colour
code is simply the 4-bit window of the 560-dot row stream.  HGR: each data
bit drives two 14M dots (palette bit delays by one); colours are computed
per dot with the sliding window and averaged in pairs down to 280 px.
"""

import numpy as np

from iivision_tpu_torch import palettes, screen
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode


def _row_dots_dhgr(main, aux):
    """(..., 32, 256) banks -> (..., 192, 80) 7-bit dot groups in row order."""
    page = screen.X_Y_TO_PAGE.astype(np.int32)
    offset = screen.X_Y_TO_OFFSET.astype(np.int32)
    flat = page * 256 + offset  # (192, 40)
    m = main.reshape(main.shape[:-2] + (32 * 256,))[..., flat] & 0x7F
    a = aux.reshape(aux.shape[:-2] + (32 * 256,))[..., flat] & 0x7F
    groups = np.stack([a, m], axis=-1)  # (..., 192, 40, 2)
    return groups.reshape(groups.shape[:-2] + (80,))


def dhgr_screen_codes(main, aux):
    """Screen memory -> (..., 192, 140) colour codes."""
    # 560-bit row stream as 140 nibbles: pixel x = dots 4x..4x+3
    bits = _row_bits(main, aux, VideoMode.DHGR)
    nibbles = (bits[..., 0::4]
               + (bits[..., 1::4] << 1)
               + (bits[..., 2::4] << 2)
               + (bits[..., 3::4] << 3))
    return nibbles.astype(np.int32)


def _hgr_row_dots(main):
    """HGR screen memory -> (..., 192, 560) 0/1 dot stream per row."""
    main = np.asarray(main, dtype=np.int64)
    page = screen.X_Y_TO_PAGE.astype(np.int32)
    offset = screen.X_Y_TO_OFFSET.astype(np.int32)
    flat = page * 256 + offset
    rows = main.reshape(main.shape[:-2] + (32 * 256,))[..., flat]  # (..,192,40)

    # expand to the 560-dot stream: data bit k of byte b drives dots
    # 14b+2k and 14b+2k+1, delayed one dot when the palette bit is set
    dots = np.zeros(rows.shape[:-1] + (561,), dtype=np.int64)
    pal = (rows >> 7) & 1  # (..., 192, 40)
    for b in range(40):
        pb = pal[..., b]
        for k in range(7):
            bit = (rows[..., b] >> k) & 1
            base = 14 * b + 2 * k
            for j in (0, 1):
                plain = dots[..., base + j]
                shifted = dots[..., base + j + 1]
                dots[..., base + j] = np.where(
                    pb == 0, plain | bit, plain)
                dots[..., base + j + 1] = np.where(
                    pb == 1, shifted | bit, shifted)
    return dots[..., :560]


def hgr_screen_codes(main):
    """HGR screen memory -> (..., 192, 140) colour codes (560-dot window
    colours sampled at each pixel's first dot)."""
    dots = _hgr_row_dots(main)
    # sliding 4-bit window colour at each dot, phase = dot % 4
    padded = np.concatenate(
        [dots, np.zeros(dots.shape[:-1] + (3,), np.int64)], axis=-1)
    win = (padded[..., 0:560]
           + (padded[..., 1:561] << 1)
           + (padded[..., 2:562] << 2)
           + (padded[..., 3:563] << 3))
    ph = (np.arange(560) % 4).astype(np.int64)
    codes560 = (((win << ph) | (win >> (4 - ph))) & 0xF)
    # sample at each 140-px pixel's first dot
    return codes560[..., 0::4].astype(np.int32)


def screen_to_rgb(main, aux, mode: VideoMode, palette: Palette):
    """Render screen memory to (..., 192, 140, 3) float RGB."""
    if mode == VideoMode.DHGR:
        codes = dhgr_screen_codes(main, aux)
    else:
        codes = hgr_screen_codes(main)
    rgb = palettes.palette_rgb_array(palette)
    return rgb[codes]


def _row_bits(main, aux, mode: VideoMode):
    """Screen memory -> (..., 192, 560) 0/1 dot stream per row."""
    if mode == VideoMode.DHGR:
        groups = _row_dots_dhgr(np.asarray(main, np.int64),
                                np.asarray(aux, np.int64))
        bits = ((groups[..., :, None] >> np.arange(7)) & 1)
        return bits.reshape(bits.shape[:-2] + (560,))
    return _hgr_row_dots(main)


def screen_to_rgb_yiq(main, aux, mode: VideoMode, palette: Palette):
    """NTSC-composite render: demodulate each row's 560-dot stream with the
    calibrated YIQ decoder (ops/yiq.py) and average down to 140 px."""
    from iivision_tpu_torch.ops import yiq

    bits = _row_bits(main, aux, mode).astype(np.int64)
    z = np.zeros(bits.shape[:-1] + (3,), np.int64)
    padded = np.concatenate([z, bits, z], axis=-1)  # (..., 566)
    codes = sum((padded[..., k:k + 560] << k) for k in range(yiq.WIN))
    out = np.zeros(codes.shape + (3,), np.float64)
    for p in range(4):  # dot d sits at carrier phase d % 4
        out[..., p::4, :] = yiq.decode_windows(codes[..., p::4], p, palette)
    return out.reshape(out.shape[:-2] + (140, 4, 3)).mean(axis=-2)


def screen_to_rgb_mono(main, aux, mode: VideoMode):
    """Monochrome-monitor render: every dot is an independent white/black
    pixel at the full 560-dot resolution -> (..., 192, 560, 3) float RGB
    (the display the 'mono' colour model optimises for)."""
    bits = _row_bits(main, aux, mode).astype(np.float64)
    return np.repeat((bits * 255.0)[..., None], 3, axis=-1)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Peak signal-to-noise ratio between RGB images (0..255 scale)."""
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))

"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/screen.py, which this package never imports.

Apple II (D)HGR screen-memory model (counterpart of
iivision_tpu/screen.py, with its numpy/jax.numpy array transforms written
on torch tensors in exact int32).

Screen state is the raw byte arrays, main and aux (32, 256) per frame: page
p, offset o.  The packed "masked lanes" - the 13-bit (DHGR) / 14-bit (HGR)
windows whose pixels a byte store influences - are derived from the bytes:

DHGR, per column pair, 34 bits
    [hdr:3][aux_even:7][main_even:7][aux_odd:7][main_odd:7][ftr:3]
  hdr = top 3 bits of the previous column's main_odd; ftr = low 3 bits of
  the next column's aux_even; masked lane o = bits [7o, 7o+13).

HGR, per column pair, 22 bits
    [hdr:3][even:8][odd_pal:1][odd_data:7][ftr:3]
  hdr = {odd.5, odd.6, odd.7} of the previous column's odd byte;
  ftr = {even.7, even.0, even.1} of the next column's even byte;
  masked lane 0 = bits [0, 14), lane 1 = bits [8, 22).

Headers and footers never cross a page boundary: column 0's header and
column 127's footer are zero.
"""

from typing import Tuple

import numpy as np
import torch

from benchmark.reference.video_mode import VideoMode, require_mode


def y_to_base_addr(y: int, page: int = 0) -> int:
    """Base memory address of screen row y on the given screen page."""
    a = y // 64
    d = y - 64 * a
    b = d // 8
    c = d - 8 * b
    return 8192 * (page + 1) + 1024 * c + 128 * b + 40 * a


def _screen_maps():
    page = np.zeros((192, 40), dtype=np.uint8)
    offset = np.zeros((192, 40), dtype=np.uint8)
    holes = np.full((32, 256), True, dtype=bool)
    for y in range(192):
        addr = y_to_base_addr(y) + np.arange(40)
        page[y] = (addr >> 8) - 32
        offset[y] = addr & 0xFF
        holes[page[y], offset[y]] = False
    return page, offset, holes


# (192, 40) uint8: the page (0..31) and page offset of byte column x of
# screen row y; (32, 256) bool: page offsets that map to no screen byte (the
# 8 bytes that pad each 120-byte half page to 128)
X_Y_TO_PAGE, X_Y_TO_OFFSET, SCREEN_HOLES = _screen_maps()


class DHGR:
    """DHGR packed-representation constants."""
    NAME = "DHGR"
    MASKED_BITS = 13
    MASKED_DOTS = 10
    N_LANES = 4
    # NTSC clock phase at the first masked bit of each lane
    PHASES = (1, 0, 3, 2)

    @staticmethod
    def bank_lanes(is_aux: bool) -> Tuple[int, int]:
        """Lane indices for (even, odd) page offsets of a memory bank."""
        return (0, 2) if is_aux else (1, 3)


class HGR:
    """HGR packed-representation constants."""
    NAME = "HGR"
    MASKED_BITS = 14
    MASKED_DOTS = 18
    N_LANES = 2
    PHASES = (1, 3)

    @staticmethod
    def bank_lanes(is_aux: bool) -> Tuple[int, int]:
        if is_aux:
            raise ValueError("HGR has no aux bank")
        return (0, 1)


def spec_for_mode(mode: VideoMode):
    """The packed-representation class of `mode` (TypeError on another
    package's VideoMode)."""
    return DHGR if require_mode(mode) == VideoMode.DHGR else HGR


def _double_pixels(x):
    """Each of bits 0..6 controls two dots; bit 6 spills a third dot (bit
    14) in case the following byte is palette-shifted."""
    dp = x & 0
    for k in range(7):
        bit = (x >> k) & 1
        dp = dp | (bit << (2 * k)) | (bit << (2 * k + 1))
    dp = dp | (((x >> 6) & 1) << 14)
    return dp


def hgr_to_dots(masked_vals, byte_offset: int):
    """HGR 14-bit masked values -> 21-bit display dot sequences (numpy
    arrays or torch tensors: operator-only arithmetic).  Each data bit
    doubles into two dots, the palette bit delays a byte's dots by one
    position, and a palette-shifted byte overwrites the spilled third dot
    of its predecessor's bit 6."""
    mv = masked_vals
    h = (mv & 0b111) << 5
    hp = (h & 0x80) >> 7
    res = _double_pixels(h & 0x7F) >> (11 - hp)

    if byte_offset == 0:
        b = (mv >> 3) & 0xFF
        bp = (b & 0x80) >> 7
        body = b & 0x7F
    else:
        bp = (mv >> 3) & 0x01
        body = (mv >> 4) & 0x7F
    # mask out in case we overwrite the spilled high dot of the header
    res = res & ~((2 ** 14 - 1) << (3 + bp))
    res = res ^ (_double_pixels(body) << (3 + bp))

    f = (mv >> 12) & 0b11
    fp = (mv >> 11) & 0b01
    res = res & ~((2 ** 4 - 1) << (17 + fp))
    res = res ^ (_double_pixels(f) << (17 + fp))
    return res & (2 ** 21 - 1)


def _zero_col(a: torch.Tensor, col: int) -> torch.Tensor:
    a = a.clone()
    a[..., col] = 0
    return a


def dhgr_masked_lanes(main: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """(..., 32, 256) screen bytes -> (..., 32, 128, 4) int32 13-bit
    lanes."""
    main = main.to(torch.int32)
    aux = aux.to(torch.int32)
    a0 = aux[..., 0::2] & 0x7F
    m0 = main[..., 0::2] & 0x7F
    a1 = aux[..., 1::2] & 0x7F
    m1 = main[..., 1::2] & 0x7F

    prev_m1 = _zero_col(torch.roll(m1, 1, dims=-1), 0)
    next_a0 = _zero_col(torch.roll(a0, -1, dims=-1), -1)
    hdr = prev_m1 >> 4
    ftr = next_a0 & 0b111

    lane0 = hdr | (a0 << 3) | ((m0 & 0b111) << 10)
    lane1 = (a0 >> 4) | (m0 << 3) | ((a1 & 0b111) << 10)
    lane2 = (m0 >> 4) | (a1 << 3) | ((m1 & 0b111) << 10)
    lane3 = (a1 >> 4) | (m1 << 3) | (ftr << 10)
    return torch.stack([lane0, lane1, lane2, lane3], dim=-1)


def hgr_masked_lanes(main: torch.Tensor) -> torch.Tensor:
    """(..., 32, 256) screen bytes -> (..., 32, 128, 2) int32 14-bit
    lanes."""
    main = main.to(torch.int32)
    even = main[..., 0::2]
    odd = main[..., 1::2]
    prev_odd = _zero_col(torch.roll(odd, 1, dims=-1), 0)
    next_even = _zero_col(torch.roll(even, -1, dims=-1), -1)
    hdr = ((prev_odd >> 5) & 0b011) | ((prev_odd >> 5) & 0b100)
    ftr = ((next_even >> 7) & 1) | ((next_even & 0b11) << 1)
    packed = (hdr | (even << 3) | ((odd & 0x80) << 4)
              | ((odd & 0x7F) << 12) | (ftr << 19))
    return torch.stack([packed & 0x3FFF, (packed >> 8) & 0x3FFF], dim=-1)


def interleave_bank_lanes(even_vals: torch.Tensor,
                          odd_vals: torch.Tensor) -> torch.Tensor:
    """Per-lane (..., N) values -> (..., 2N) in page-offset order (even
    offsets from even_vals, odd from odd_vals)."""
    stacked = torch.stack([even_vals, odd_vals], dim=-1)
    return stacked.reshape(stacked.shape[:-2] + (stacked.shape[-2] * 2,))

"""Masked-lane derivation in torch (counterpart of iivision_tpu/screen.py).

The address tables, `SCREEN_HOLES` and the DHGR/HGR spec classes stay in
the JAX package's `screen` and are imported from there; only the array
transforms that it runs through `jax.numpy` are written here, in exact
int32.
"""

import torch


def _zero_col(a: torch.Tensor, col: int) -> torch.Tensor:
    a = a.clone()
    a[..., col] = 0
    return a


def dhgr_masked_lanes(main: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """(..., 32, 256) screen bytes -> (..., 32, 128, 4) int32 13-bit lanes.

    Same bit layout as iivision_tpu.screen.dhgr_masked_lanes: per column
    pair [hdr:3][aux_even:7][main_even:7][aux_odd:7][main_odd:7][ftr:3],
    with no header/footer leaking across page boundaries.
    """
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
    """(..., 32, 256) screen bytes -> (..., 32, 128, 2) int32 14-bit lanes
    (iivision_tpu.screen.hgr_masked_lanes)."""
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

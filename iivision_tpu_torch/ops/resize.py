"""Batched separable Lanczos-3 resize on a torch device (counterpart of the
device branch of iivision_tpu/ops/resize.py `resize_batch`).

A resize is ``out = A_h @ img @ A_w.T`` per channel, with the JAX package's
own dense resampling matrices (`resize_matrix`, PIL's geometry), as two
`torch.einsum` products, then round, clip and uint8.  They are plain
products outside any kernel.

The products run in float64: the float32 weights and the uint8 pixels
convert to it exactly, and no float64 product on a card takes the TF32
path, whatever the caller set in `torch.backends`.  The JAX package sums in
float32 at HIGHEST precision, so a pixel whose exact value lies next to a
rounding boundary can land one uint8 level apart (tests pin the share).
"""

import torch

from iivision_tpu.ops.resize import resize_matrix


def resize_batch(frames: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Resize (..., H, W, C) frames to (..., h_out, w_out, C) uint8 on the
    frames' device."""
    h_in, w_in = frames.shape[-3], frames.shape[-2]
    dev = frames.device
    ah = torch.as_tensor(resize_matrix(h_in, h_out), device=dev).double()
    aw = torch.as_tensor(resize_matrix(w_in, w_out), device=dev).double()
    x = frames.to(torch.float64)
    y = torch.einsum("oh,...hwc->...owc", ah, x)
    y = torch.einsum("pw,...owc->...opc", aw, y)
    return y.round().clamp(0.0, 255.0).to(torch.uint8)

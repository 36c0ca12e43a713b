"""Batched separable Lanczos-3 resize (counterpart of
iivision_tpu/ops/resize.py).

A resize is ``out = A_h @ img @ A_w.T`` per channel with PIL's resample
geometry (the kernel widened by the scale when downscaling, taps outside
the image excluded and the rest renormalized).  Two paths:

- `resize_batch` on a torch device: the dense resampling matrices
  (`resize_matrix`) as two `torch.einsum` products, then round, clip and
  uint8.  The products run in float64: the float32 weights and the uint8
  pixels convert to it exactly, and no float64 product on a card takes
  the TF32 path, whatever the caller set in `torch.backends`.  The JAX
  package sums in float32 at HIGHEST precision, so a pixel whose exact
  value lies next to a rounding boundary can land one uint8 level apart
  (tests pin the share).
- `resize_host` on numpy arrays: PIL's own fixed-point passes in C++
  (sim/csrc/resize_fast.cpp), bit-exact with PIL, falling back to PIL.
"""

import functools
import math
import subprocess
from typing import Tuple

import numpy as np
import torch

_A = 3.0  # Lanczos kernel support (taps)
_PRECISION_BITS = 22  # PIL's 8bpc fixed point (Resample.c: 32 - 8 - 2)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.sinc(x) * np.sinc(x / _A)
    return np.where(x < _A, out, 0.0)


@functools.lru_cache(None)
def resize_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Banded filter taps: (idx (n_out, width) int64, w (n_out, width)
    float32), PIL's geometry."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = _A * fscale
    centers = (np.arange(n_out) + 0.5) * scale  # in input coordinates
    lo = np.floor(centers - support).astype(np.int64)
    hi = np.ceil(centers + support).astype(np.int64)
    width = int((hi - lo).max())
    taps = lo[:, None] + np.arange(width)[None, :]  # (n_out, width)
    w = _lanczos3((taps + 0.5 - centers[:, None]) / fscale)
    w = np.where((taps < hi[:, None]) & (taps >= 0) & (taps < n_in), w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    return np.clip(taps, 0, n_in - 1), w.astype(np.float32)


@functools.lru_cache(None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 dense resampling matrix."""
    idx, w = resize_taps(n_in, n_out)
    n_out_, width = idx.shape
    m = np.zeros((n_out_, n_in), dtype=np.float64)
    np.add.at(m, (np.repeat(np.arange(n_out_), width), idx.ravel()),
              w.astype(np.float64).ravel())
    return m.astype(np.float32)


@functools.lru_cache(None)
def _pil_coeffs(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's fixed-point resample coefficients for one axis (Pillow
    Resample.c precompute_coeffs + normalize_coeffs_8bpc in double
    precision, quantized round-half-away at 2^22).  Returns (bounds
    (n_out, 2) {min, count}, kk (n_out, ksize) int32)."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = _A * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((n_out, 2), np.int32)
    kk = np.zeros((n_out, ksize), np.int32)
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
            v = k[x] / ww * (1 << _PRECISION_BITS)
            kk[xx, x] = int(v - 0.5) if v < 0 else int(v + 0.5)
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def resize_host(frames: np.ndarray, h_out: int, w_out: int) -> np.ndarray:
    """Resize (..., H, W, C) uint8 numpy frames to (..., h_out, w_out, C)
    on the host: horizontal then vertical C++ pass with a uint8
    intermediate, as Pillow orders them; PIL itself when the native build
    is unavailable or C != 3."""
    h_in, w_in = frames.shape[-3], frames.shape[-2]
    if (h_in, w_in) == (h_out, w_out):
        return np.asarray(frames, dtype=np.uint8)
    flat = np.ascontiguousarray(frames, dtype=np.uint8).reshape(
        (-1, h_in, w_in, frames.shape[-1]))
    if flat.shape[-1] == 3:
        from iivision_tpu_torch.sim import native
        try:
            if w_out != w_in:
                flat = native.resample_h(flat, w_out,
                                         *_pil_coeffs(w_in, w_out))
            if h_out != h_in:
                flat = native.resample_v(flat, h_out,
                                         *_pil_coeffs(h_in, h_out))
            return flat.reshape(frames.shape[:-3] + (h_out, w_out, -1))
        except (OSError, subprocess.CalledProcessError):
            pass  # no C++ toolchain: PIL below
    from PIL import Image
    out = np.empty((flat.shape[0], h_out, w_out, flat.shape[-1]), np.uint8)
    for i, f in enumerate(flat):
        out[i] = np.asarray(Image.fromarray(f).resize(
            (w_out, h_out), Image.LANCZOS))
    return out.reshape(frames.shape[:-3] + (h_out, w_out, -1))


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

"""The encoder's distance model, plain: lane pixels, the diagonal
Damerau-Levenshtein diff of the window colour model and the store-cost
table, read from the shipped npz by path (frozen from
iivision_tpu_torch/ops/distance.py; the window model only).
"""

import functools
import os

import numpy as np
import torch

from benchmark.reference import DATA_DIR, palettes
from benchmark.reference.palettes import Palette, require_palette
from benchmark.reference.screen import hgr_to_dots, spec_for_mode
from benchmark.reference.video_mode import VideoMode, require_mode

TRANSPOSE_COST = 1
STORE_COST_VERSION = 1


def lane_pixels(vals: torch.Tensor, mode: VideoMode,
                lane: int) -> torch.Tensor:
    """(...) masked lane values -> (..., L) int32 pixel colour codes at the
    lane's NTSC phase."""
    spec = spec_for_mode(mode)
    vals = vals.to(torch.int32)
    dots = vals if mode == VideoMode.DHGR else hgr_to_dots(vals, lane)
    ph = spec.PHASES[lane]
    cols = []
    for i in range(int(spec.MASKED_DOTS)):
        w = (dots >> i) & 0xF
        r = (ph + i) % 4
        if r:
            w = ((w << r) | (w >> (4 - r))) & 0xF
        cols.append(w)
    return torch.stack(cols, dim=-1)


def dist_pixel_pairs(pa: torch.Tensor, pb: torch.Tensor,
                     sub: torch.Tensor) -> torch.Tensor:
    """Elementwise diagonal DP: (..., L) codes -> (...) int32.  D[0] =
    C[a0, b0]; D[k] = min(D[k-1] + C[ak, bk], D[k-2] + 1 where a_k ==
    b_{k-1} and a_{k-1} == b_k)."""
    pa = pa.to(torch.int64)
    pb = pb.to(torch.int64)
    flat = sub.to(torch.int32).reshape(-1)
    cost = flat[pa * 16 + pb]
    d_m2 = torch.zeros(pa.shape[:-1], dtype=torch.int32, device=pa.device)
    d_m1 = cost[..., 0]
    for k in range(1, pa.shape[-1]):
        dk = d_m1 + cost[..., k]
        swap = (pa[..., k] == pb[..., k - 1]) & (pa[..., k - 1] == pb[..., k])
        dk = torch.where(swap, torch.minimum(dk, d_m2 + TRANSPOSE_COST), dk)
        d_m2, d_m1 = d_m1, dk
    return d_m1


def n_contents(mode: VideoMode) -> int:
    """Content bytes a store can carry: 7-bit DHGR, 8-bit HGR."""
    return 128 if require_mode(mode) == VideoMode.DHGR else 256


@functools.lru_cache(None)
def store_cost_table(mode: VideoMode, palette: Palette) -> np.ndarray:
    """(n_lanes, 2^B, n_contents) int16 store costs of the window model,
    from the shipped table."""
    path = os.path.join(DATA_DIR, "store_cost", "v%d_%s_%s_window.npz" % (
        STORE_COST_VERSION, mode.name, palette.name))
    cost = np.load(path)["cost"]
    if cost.min() < 0 or cost.max() >= 1 << 15:
        raise ValueError("store costs outside 0 .. 2^15 - 1")
    return cost.astype(np.int16)


class Distance:
    """The window model on `device`: the (16, 16) int32 CIE2000 basis and
    the int16 store-cost table."""

    def __init__(self, mode: VideoMode, palette: Palette, device):
        self.mode = require_mode(mode)
        require_palette(palette)
        self.n_contents = n_contents(mode)
        self.sub = torch.as_tensor(
            palettes.diff_matrix(palette).astype(np.float32).astype(
                np.int32), device=device)
        self.store_cost16 = torch.as_tensor(store_cost_table(mode, palette),
                                            device=device)

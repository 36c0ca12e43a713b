"""The encoder's distance model in torch (counterpart of
iivision_tpu/ops/distance.py).

- `lane_pixels`: masked lane values -> NTSC colour codes per pixel.
- `dist_pixel_pairs`: the diagonal Damerau-Levenshtein distance between
  pixel-code strings, elementwise.  Its plain form is the recurrence
  written directly, indexing `sub[a, b]`; on a CUDA tensor it is kernel A's
  elementwise entry (ops/editdist.py `dist_pairs_elementwise`).
- `store_cost_table`: the shipped int16-exact store-cost tables.
- `ComputedDistance`: what the encoder holds per (mode, palette).
"""

import numpy as np
import torch

from iivision_tpu.ops.distance import (  # noqa: F401
    n_contents, store_cost_path, sub16)
from iivision_tpu.palettes import Palette
from iivision_tpu.screen import hgr_to_dots, spec_for_mode
from iivision_tpu.video_mode import VideoMode

TRANSPOSE_COST = 1


def lane_pixels(vals: torch.Tensor, mode: VideoMode,
                lane: int) -> torch.Tensor:
    """(...) masked lane values -> (..., L) int32 pixel colour codes at the
    lane's NTSC phase (iivision_tpu.ops.distance.lane_pixels)."""
    spec = spec_for_mode(mode)
    vals = vals.to(torch.int32)
    # DHGR windows are already the dot sequence; the HGR expansion is
    # operator-only arithmetic and runs on torch tensors as written
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


def dist_pixel_pairs_plain(pa: torch.Tensor, pb: torch.Tensor,
                           sub: torch.Tensor) -> torch.Tensor:
    """Elementwise diagonal DP, the plain torch form.

    pa, pb: (..., L) integer codes in 0..15; sub: (16, 16) integer costs.
    Returns (...) int32.  D[0] = C[a0, b0]; D[k] = min(D[k-1] + C[ak, bk],
    D[k-2] + 1 where a_k == b_{k-1} and a_{k-1} == b_k), D[-1] = 0.
    All values are integers below 2^16, so int32 equals the JAX package's
    float32 result exactly.
    """
    pa = pa.to(torch.int64)
    pb = pb.to(torch.int64)
    flat = sub.to(torch.int32).reshape(-1)
    cost = flat[pa * 16 + pb]  # (..., L) C[a_k, b_k]
    d_m2 = torch.zeros(pa.shape[:-1], dtype=torch.int32, device=pa.device)
    d_m1 = cost[..., 0]
    for k in range(1, pa.shape[-1]):
        dk = d_m1 + cost[..., k]
        swap = (pa[..., k] == pb[..., k - 1]) & (pa[..., k - 1] == pb[..., k])
        dk = torch.where(swap, torch.minimum(dk, d_m2 + TRANSPOSE_COST), dk)
        d_m2, d_m1 = d_m1, dk
    return d_m1


def dist_pixel_pairs(pa: torch.Tensor, pb: torch.Tensor,
                     sub: torch.Tensor) -> torch.Tensor:
    """Elementwise diagonal DP distance, (..., L) codes -> (...) int32.

    A CUDA tensor goes through kernel A's elementwise entry; a CPU tensor
    through `dist_pixel_pairs_plain`."""
    from iivision_tpu_torch.ops import editdist

    return editdist.dist_pairs_elementwise(pa, pb, sub)


def dist_lane_pairs(va: torch.Tensor, vb: torch.Tensor, mode: VideoMode,
                    lane: int, sub: torch.Tensor) -> torch.Tensor:
    """Distance between masked-lane value arrays (elementwise pairs),
    window colour model."""
    return dist_pixel_pairs(lane_pixels(va, mode, lane),
                            lane_pixels(vb, mode, lane), sub)


def sub_for(mode: VideoMode, palette: Palette,
            model: str = "window") -> np.ndarray:
    """(16, 16) float32 cost basis.  Only the window model is ported."""
    if model != "window":
        raise NotImplementedError(
            "colour model %r is not ported yet (ROADMAP.md Queue 1: "
            "'HGR, yiq, mono and joint in the encoder')" % (model,))
    return sub16(palette)


def store_cost_table(mode: VideoMode, palette: Palette,
                     model: str = "window") -> np.ndarray:
    """(n_lanes, 2^B, n_contents) int16 store costs from the package's
    shipped artifact.  Building a missing table is not ported: a miss
    raises."""
    path = store_cost_path(mode, palette, model)
    try:
        cost = np.load(path)["cost"]
    except FileNotFoundError:
        raise FileNotFoundError(
            "no shipped store-cost table %s; building one is not ported "
            "yet (ROADMAP.md Queue 1: 'the torch _build_store_cost')"
            % path) from None
    if cost.max() >= 1 << 15:
        raise ValueError("store costs overflow int16: max %d" % cost.max())
    return cost.astype(np.int16)


class ComputedDistance:
    """Distance provider for the torch encoder: the int16 store-cost table
    and the (16, 16) cost basis, resident on `device`."""

    def __init__(self, mode: VideoMode, palette: Palette,
                 model: str = "window", *, device):
        self.mode = mode
        self.palette = palette
        self.model = model
        self.device = torch.device(device)
        self.n_contents = n_contents(mode)
        self.sub = torch.as_tensor(
            sub_for(mode, palette, model).astype(np.int32),
            device=self.device)
        self.store_cost16 = torch.as_tensor(
            store_cost_table(mode, palette, model), device=self.device)

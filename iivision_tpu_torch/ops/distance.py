"""The encoder's distance model in torch (counterpart of
iivision_tpu/ops/distance.py).

- `lane_pixels`: masked lane values -> NTSC colour codes per pixel.
- `dist_pixel_pairs`: the diagonal Damerau-Levenshtein distance between
  pixel-code strings, elementwise.  Its plain form is the recurrence
  written directly, indexing `sub[a, b]`; on a CUDA tensor it is kernel A's
  elementwise entry (ops/editdist.py `dist_pairs_elementwise`).
- `dist_window_sums(_sub2)`: the yiq model's per-position pair costs,
  summed (a gather-sum; the JAX package's one-hot einsum is XLA, not
  Pallas).
- `dist_lane_pairs`: either of the two, chosen by the rank of `sub` as in
  the JAX package: (16, 16) is the window (or mono) edit distance,
  (n_lanes, L, 128, 128) the yiq sums.  The edit distance on a CUDA tensor
  is one launch of kernel A's lane-distance entry (ops/editdist.py
  `lane_distance`), which derives the codes itself; its plain form is
  `dist_lane_pairs_plain`: `lane_pixels` on both sides, then
  `dist_pixel_pairs_plain`.
- `build_store_cost` / `store_cost_table`: the int16 store-cost tables,
  loaded from the shipped npz files (under `DATA_DIR`, read by path) or
  the user cache, or built and saved there.
- `ComputedDistance`: what the encoder holds per (mode, palette, model).

Every distance is an integer below 2^16, so int32 here equals the JAX
package's float32 exactly.
"""

import functools
import os

import numpy as np
import torch

from iivision_tpu_torch import DATA_DIR, palettes
from iivision_tpu_torch.palettes import Palette, require_palette
from iivision_tpu_torch.screen import hgr_to_dots, spec_for_mode
from iivision_tpu_torch.video_mode import VideoMode, require_mode

TRANSPOSE_COST = 1
# the shipped tables' version tag (iivision_tpu/ops/distance.py)
STORE_COST_VERSION = 1
# (t, c) pairs per distance call in the store-cost build: one call per
# DHGR lane, four per HGR lane; bounds the (pairs, L) code transients
BUILD_PAIRS = 1 << 20


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


def dist_window_sums(wa: torch.Tensor, wb: torch.Tensor,
                     subs: torch.Tensor) -> torch.Tensor:
    """Per-position pair costs summed (yiq model: no alignment DP).

    wa, wb: (..., L) 7-bit window codes; subs: (L, 128, 128) integer costs.
    Returns (...) int32: sum over k of subs[k, wa_k, wb_k]."""
    L = subs.shape[0]
    pos = torch.arange(L, dtype=torch.int64, device=wa.device) * (128 * 128)
    idx = pos + wa.to(torch.int64) * 128 + wb.to(torch.int64)
    return subs.to(torch.int32).reshape(-1)[idx].sum(-1, dtype=torch.int32)


def dist_window_sums_sub2(wa: torch.Tensor, wb: torch.Tensor,
                          subs2: torch.Tensor) -> torch.Tensor:
    """`dist_window_sums` with a leading stack axis carrying its own subs.

    wa, wb: (S, ..., L) window codes; subs2: (S, L, 128, 128) costs."""
    return torch.stack([dist_window_sums(a, b, s)
                        for a, b, s in zip(wa, wb, subs2)])


def dist_lane_pairs_plain(va: torch.Tensor, vb: torch.Tensor,
                          mode: VideoMode, lane: int,
                          sub: torch.Tensor) -> torch.Tensor:
    """The (16, 16)-basis lane distance as plain torch ops: both sides'
    colour codes, then the recurrence."""
    return dist_pixel_pairs_plain(lane_pixels(va, mode, lane),
                                  lane_pixels(vb, mode, lane), sub)


def dist_lane_pairs(va: torch.Tensor, vb: torch.Tensor, mode: VideoMode,
                    lane: int, sub: torch.Tensor) -> torch.Tensor:
    """Distance between masked-lane value arrays (elementwise pairs).

    The cost basis rides in `sub`'s rank: (16, 16) selects the windowed
    colour (or mono) edit distance, (n_lanes, L, 128, 128) the yiq model."""
    if sub.dim() == 4:
        from iivision_tpu_torch.ops import yiq

        return dist_window_sums(yiq.lane_windows(va, mode, lane),
                                yiq.lane_windows(vb, mode, lane), sub[lane])
    from iivision_tpu_torch.ops import editdist

    return editdist.lane_distance(va, vb, mode, lane, sub)


@functools.lru_cache(None)
def sub16(palette: Palette) -> np.ndarray:
    """(16, 16) float32 CIE2000 costs between the palette's colours."""
    return palettes.diff_matrix(palette).astype(np.float32)


@functools.lru_cache(None)
def sub16_mono() -> np.ndarray:
    """(16, 16) float32 monochrome basis: popcount(a ^ b), the number of
    differing dots of two 4-dot windows, scaled x25 so magnitudes compare
    with the CIEDE2000 basis; palette-independent."""
    a = np.arange(16)
    ham = np.unpackbits(
        (a[:, None] ^ a[None, :]).astype(np.uint8)[..., None],
        axis=-1).sum(axis=-1)
    return (ham * 25).astype(np.float32)


def n_contents(mode: VideoMode) -> int:
    """Distinct content bytes a store can carry: DHGR bytes are 7-bit,
    HGR full 8-bit."""
    return 128 if require_mode(mode) == VideoMode.DHGR else 256


def store_cost_path(mode: VideoMode, palette: Palette, model: str,
                    data_dir=None) -> str:
    """Path of a store-cost table: under `data_dir`, or the shipped ones
    under DATA_DIR."""
    return os.path.join(
        data_dir or DATA_DIR, "store_cost",
        "v%d_%s_%s_%s.npz" % (STORE_COST_VERSION, mode.name,
                              palette.name, model))


def _user_cache_dir() -> str:
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.expanduser("~/.cache")), "iivision_tpu")


def save_store_cost(cost: np.ndarray, mode: VideoMode, palette: Palette,
                    model: str, data_dir=None) -> str:
    """Write a table in the JAX package's npz layout: exact integers as
    uint16 (window, mono), float32 otherwise (yiq)."""
    path = store_cost_path(mode, palette, model, data_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if model in ("window", "mono"):
        if float(np.abs(cost - np.round(cost)).max()) != 0.0:
            raise ValueError("%s store costs are not integers" % model)
        out = cost.astype(np.uint16)
    else:
        out = cost.astype(np.float32)
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "wb") as f:
        np.savez_compressed(f, cost=out)
    os.replace(tmp, path)
    return path


def sub_for(mode: VideoMode, palette: Palette,
            model: str = "window") -> np.ndarray:
    """float32 cost basis for `model`: 'window' (the reference's nominal
    colours), 'yiq' (NTSC composite) or 'mono' (dot-level Hamming)."""
    if model == "yiq":
        from iivision_tpu_torch.ops import yiq

        return yiq.lane_subs(mode, palette)
    if model == "mono":
        return sub16_mono()
    if model != "window":
        raise ValueError("unknown colour model: %r" % (model,))
    return sub16(palette)


def store_cost_rows(mode: VideoMode, lane: int, t: torch.Tensor,
                    sub: torch.Tensor) -> torch.Tensor:
    """(len(t), C) int32: the cost of storing each content byte c over
    target lane values t, D(masked_update(t, c), t)."""
    spec = spec_for_mode(mode)
    c = torch.arange(n_contents(mode), dtype=torch.int32,
                     device=t.device)[None, :]
    t = t.to(torch.int32)[:, None]
    if mode == VideoMode.DHGR:
        new = spec.masked_update(t, c)
    else:
        new = spec.masked_update(t, c, lane)
    return dist_lane_pairs(new, t.expand_as(new), mode, lane, sub)


def build_store_cost(mode: VideoMode, palette: Palette, model: str,
                     device) -> torch.Tensor:
    """(n_lanes, 2^B, C) int32 store costs built on `device`
    (iivision_tpu/ops/distance.py `_build_store_cost`).  The window and mono
    models run kernel A's lane-distance entry on a card and the plain
    recurrence on the CPU; yiq runs the window gather-sums."""
    spec = spec_for_mode(mode)
    n = 1 << int(spec.MASKED_BITS)
    chunk = min(n, BUILD_PAIRS // n_contents(mode))
    sub = torch.as_tensor(sub_for(mode, palette, model).astype(np.int32),
                          device=device)
    out = torch.empty((int(spec.N_LANES), n, n_contents(mode)),
                      dtype=torch.int32, device=device)
    for lane in range(int(spec.N_LANES)):
        for t0 in range(0, n, chunk):
            t = torch.arange(t0, t0 + chunk, dtype=torch.int32,
                             device=device)
            out[lane, t0:t0 + chunk] = store_cost_rows(mode, lane, t, sub)
    return out


def store_cost_table(mode: VideoMode, palette: Palette, model: str,
                     device) -> np.ndarray:
    """(n_lanes, 2^B, n_contents) int16 store costs.

    Searches the package's shipped tables, then the user cache; on a miss
    builds the table on `device` and saves it to the user cache (the npz
    layout the JAX package reads and writes, so either package's tables
    serve both).  float32 tables (yiq) go to int16 by truncation toward
    zero, as the JAX encoder's `astype(int16)` does."""
    for d in (None, _user_cache_dir()):
        path = store_cost_path(mode, palette, model, d)
        if os.path.exists(path):
            cost = np.load(path)["cost"]
            break
    else:
        cost = build_store_cost(mode, palette, model, device).cpu().numpy()
        try:
            save_store_cost(cost.astype(np.float32), mode, palette, model,
                            _user_cache_dir())
        except OSError:
            pass  # read-only home: rebuild next process
    # the joint body kernel reads a cost's bits as a float, which is exact
    # only for 0 <= cost < 2^15
    if cost.min() < 0 or cost.max() >= 1 << 15:
        raise ValueError("store costs outside 0 .. 2^15 - 1: min %d, max %d"
                         % (cost.min(), cost.max()))
    return cost.astype(np.int16)


class ComputedDistance:
    """Distance provider for the torch encoder: the int16 store-cost table
    and the int32 cost basis ((16, 16), or (n_lanes, L, 128, 128) for
    yiq), resident on `device`."""

    def __init__(self, mode: VideoMode, palette: Palette,
                 model: str = "window", *, device):
        self.mode = require_mode(mode)
        self.palette = require_palette(palette)
        self.model = model
        self.device = torch.device(device)
        self.n_contents = n_contents(mode)
        self.sub = torch.as_tensor(
            sub_for(mode, palette, model).astype(np.int32),
            device=self.device)
        self.store_cost16 = torch.as_tensor(
            store_cost_table(mode, palette, model, self.device),
            device=self.device)

"""Edit-distance tables in torch, through kernel A (counterpart of
iivision_tpu/ops/editdist.py).

The diagonal reduction of the weighted Damerau-Levenshtein distance, and
its proof, are in the JAX module's docstring.  This module has:

- `dp_distance_tile`: the plain torch form for all pairs of a tile,
  written as the recurrence itself (a cost lookup per position);
- `pair_distance`: all pairs through kernel A's `editdist_tile` entry (the
  counterpart of the Pallas `pallas_distance`); `same_codes` tells the
  kernel that both sides are one code set (its symmetric path);
- `lane_distance`: elementwise pairs of masked lane values through kernel
  A's `lane_dist` entry, which derives the colour codes itself (the
  store-cost build and the quality scorer, through
  `distance.dist_lane_pairs`);
- `dist_pairs_elementwise`: elementwise pairs of (..., L) code strings
  through kernel A's `dist_pairs` entry;
- `edit_distance_matrix` and `build_tables`: whole-lane LUTs.

A wrapper runs its plain version only for CPU tensors.  For CUDA tensors
it launches the kernel (csrc/editdist.cu) or raises.  Each wrapper counts
its kernel launches in its `launches` attribute.

The code strings, the cost matrix, the scalar oracles (`dam_lev_scalar`,
`diagonal_dp_scalar`) and the npz writer and reader are numpy copies of
the JAX module's (same names).
"""

import ctypes
import functools
import os
from typing import Optional

import numpy as np
import torch

from iivision_tpu_torch import DATA_DIR, _build, colours, palettes
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.screen import spec_for_mode
from iivision_tpu_torch.video_mode import VideoMode

TRANSPOSE_COST = 1
INDEL_COST = 100000
MAX_L = 32  # longest code string kernel A's elementwise entry accepts
TILE_L = (10, 18)  # code lengths its all-pairs tile is compiled for


@functools.lru_cache(None)
def lane_pixel_codes(mode: VideoMode, lane: int) -> np.ndarray:
    """(2^MASKED_BITS, MASKED_DOTS) uint8 colour codes of every masked
    value of a lane: the value expanded to display dots, then the sliding
    NTSC window at the lane's clock phase."""
    spec = spec_for_mode(mode)
    vals = np.arange(1 << spec.MASKED_BITS, dtype=np.int64)
    return colours.dots_to_pixels_vec(
        spec.to_dots(vals, lane), num_bits=int(spec.MASKED_DOTS),
        init_phase=spec.PHASES[lane]).astype(np.uint8)


def substitute_matrix(palette: Palette) -> np.ndarray:
    """(16, 16) int32 CIE2000 substitution costs."""
    return palettes.diff_matrix(palette)


def dam_lev_scalar(a, b, sub: np.ndarray,
                   transpose_cost: float = TRANSPOSE_COST,
                   indel_cost: float = INDEL_COST) -> float:
    """Textbook weighted Damerau-Levenshtein (with the 'last seen' table):
    the scalar oracle of the diagonal reduction, host-side, test use."""
    la, lb = len(a), len(b)
    maxdist = (la + lb) * indel_cost + 1
    d = np.full((la + 2, lb + 2), maxdist, dtype=np.float64)
    d[1, 1] = 0
    for i in range(1, la + 1):
        d[i + 1, 1] = i * indel_cost
    for j in range(1, lb + 1):
        d[1, j + 1] = j * indel_cost
    da = {}
    for i in range(1, la + 1):
        db = 0
        for j in range(1, lb + 1):
            k = da.get(b[j - 1], 0)
            l_ = db
            if a[i - 1] == b[j - 1]:
                cost = 0.0
                db = j
            else:
                cost = float(sub[a[i - 1], b[j - 1]])
            d[i + 1, j + 1] = min(
                d[i, j] + cost,  # substitution
                d[i + 1, j] + indel_cost,  # insertion
                d[i, j + 1] + indel_cost,  # deletion
                d[k, l_] + (i - k - 1) * indel_cost + transpose_cost
                + (j - l_ - 1) * indel_cost,  # transposition
            )
        da[a[i - 1]] = i
    return float(d[la + 1, lb + 1])


def diagonal_dp_scalar(a, b, sub: np.ndarray) -> float:
    """Scalar form of the diagonal recurrence (test cross-check): D[k] =
    D[k-1] + C[a_k, b_k], or D[k-2] + the transposition cost where a_k,
    a_{k-1} are b_{k-1}, b_k swapped, whichever is less."""
    assert len(a) == len(b)
    dm2, dm1 = 0.0, None
    for k in range(len(a)):
        dk = (dm1 if dm1 is not None else 0.0) + float(sub[a[k], b[k]])
        if k >= 1 and a[k] == b[k - 1] and a[k - 1] == b[k]:
            dk = min(dk, dm2 + TRANSPOSE_COST)
        dm2, dm1 = (dm1 if dm1 is not None else 0.0), dk
    return dm1 if dm1 is not None else 0.0


def table_path(mode: VideoMode, palette: Palette,
               data_dir: Optional[str] = None) -> str:
    return os.path.join(
        data_dir or DATA_DIR,
        "%s_palette_%d_edit_distance.npz" % (spec_for_mode(mode).NAME,
                                             palette.value))


def save_tables(tables, mode: VideoMode, palette: Palette,
                data_dir: Optional[str] = None) -> str:
    """Save LUTs in the reference's npz layout (upper triangle only)."""
    n = 1 << spec_for_mode(mode).MASKED_BITS
    full = np.asarray(tables).reshape(len(tables), n, n)
    tri = np.where(
        np.arange(n)[:, None] > np.arange(n)[None, :], full, 0
    ).astype(np.uint16)
    path = table_path(mode, palette, data_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, edit_distance=tri.reshape(len(tables), n * n))
    return path


def load_tables(mode: VideoMode, palette: Palette,
                data_dir: Optional[str] = None) -> np.ndarray:
    """Load and symmetrise a reference-layout npz (what `save_tables`
    wrote): (n_lanes, 2^(2*MASKED_BITS)) uint16."""
    n = 1 << spec_for_mode(mode).MASKED_BITS
    dist = np.load(table_path(mode, palette, data_dir))["edit_distance"]
    full = dist.reshape(len(dist), n, n)
    full = full + np.transpose(full, (0, 2, 1))
    return full.reshape(len(dist), n * n)


def dp_distance_tile(a_codes: torch.Tensor, b_codes: torch.Tensor,
                     sub: torch.Tensor) -> torch.Tensor:
    """(M, N) int32 distances for all pairs of (M, L) and (N, L) codes,
    plain torch.  sub: (16, 16) integer costs."""
    a = a_codes.to(torch.int64)
    b = b_codes.to(torch.int64)
    flat = sub.to(torch.int32).reshape(-1)
    L = a.shape[1]

    def cost(k):
        return flat[a[:, k, None] * 16 + b[None, :, k]]  # (M, N)

    d_m2 = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32,
                       device=a.device)
    d_m1 = cost(0)
    for k in range(1, L):
        dk = d_m1 + cost(k)
        swap = ((a[:, k, None] == b[None, :, k - 1])
                & (a[:, k - 1, None] == b[None, :, k]))
        dk = torch.where(swap, torch.minimum(dk, d_m2 + TRANSPOSE_COST), dk)
        d_m2, d_m1 = d_m1, dk
    return d_m1


def _check_codes(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("tensors on different devices: %s vs %s"
                             % (t.device, dev))
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("kernel A takes contiguous int32 tensors, got "
                             "%s (contiguous=%s)" % (t.dtype,
                                                     t.is_contiguous()))


def _sub_i32(sub: torch.Tensor, device) -> torch.Tensor:
    if sub.shape != (16, 16):
        raise ValueError("cost matrix must be (16, 16), got %s"
                         % (tuple(sub.shape),))
    return sub.to(device=device, dtype=torch.int32).contiguous()


def same_codes(codes_a: torch.Tensor, codes_b: torch.Tensor) -> bool:
    """Whether both sides are one code set: one tensor, or views of one
    storage with equal shape and strides.  Kernel A then takes its
    symmetric path if the cost matrix is symmetric too (the kernel checks
    that itself, so no launch waits for the card): D(a, b) = D(b, a), the
    transposition test being symmetric by itself, so it computes only the
    tiles on or above the diagonal and writes each off-diagonal one
    twice."""
    return codes_a is codes_b or (
        codes_a.device == codes_b.device
        and codes_a.data_ptr() == codes_b.data_ptr()
        and codes_a.shape == codes_b.shape
        and codes_a.stride() == codes_b.stride())


def pair_distance(codes_a: torch.Tensor, codes_b: torch.Tensor,
                  sub: torch.Tensor, out=None) -> torch.Tensor:
    """(n_a, n_b) uint16 distances for all pairs (kernel A, all pairs).

    codes_a: (n_a, L), codes_b: (n_b, L) int32 codes in 0..15; sub: (16, 16)
    integer costs; out: an optional contiguous (n_a, n_b) uint16 tensor to
    write.  CPU tensors run `dp_distance_tile`.  Passing one code set twice
    (`same_codes`) under a symmetric `sub` halves the card's DP work.

    On the card L must be one of TILE_L, the LUT lengths (DHGR 10, HGR 18):
    the tile is compiled for each length so that its steps unroll with
    every code in registers.  Another length needs an instantiation of its
    own in csrc/editdist.cu; `dist_pairs_elementwise` takes any L up to
    MAX_L."""
    if codes_a.dim() != 2 or codes_b.dim() != 2 \
            or codes_a.shape[1] != codes_b.shape[1]:
        raise ValueError("code shapes %s and %s do not pair" % (
            tuple(codes_a.shape), tuple(codes_b.shape)))
    n_a, L = codes_a.shape
    n_b = codes_b.shape[0]
    if out is None:
        out = torch.empty((n_a, n_b), dtype=torch.uint16,
                          device=codes_a.device)
    elif (out.shape != (n_a, n_b) or out.dtype != torch.uint16
          or out.device != codes_a.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (%d, %d) uint16 tensor "
                         "on %s" % (n_a, n_b, codes_a.device))
    if codes_a.device.type == "cpu":
        out.copy_(dp_distance_tile(codes_a, codes_b, sub).to(torch.uint16))
        return out
    if codes_a.device.type != "cuda":
        raise ValueError("no kernel for device %s" % codes_a.device)
    _check_codes(codes_a, codes_b)
    if L not in TILE_L:
        raise ValueError("code strings of length %d (the all-pairs tile "
                         "takes the LUT lengths %s)" % (L, TILE_L))
    sub_d = _sub_i32(sub, codes_a.device)
    _build.launch("iiv_editdist_tile",
                  ctypes.c_void_p(codes_a.data_ptr()), n_a,
                  ctypes.c_void_p(codes_b.data_ptr()), n_b, L,
                  ctypes.c_void_p(sub_d.data_ptr()),
                  int(same_codes(codes_a, codes_b)),
                  ctypes.c_void_p(out.data_ptr()),
                  ctypes.c_void_p(_build.stream_ptr(codes_a.device)))
    _build.count(pair_distance, "launches")
    return out


_build.counter(pair_distance)


def dist_pairs_elementwise(pa: torch.Tensor, pb: torch.Tensor,
                           sub: torch.Tensor) -> torch.Tensor:
    """(...) int32 distances of elementwise (..., L) code pairs (kernel A,
    elementwise).  CPU tensors run distance.dist_pixel_pairs_plain."""
    if pa.shape != pb.shape:
        raise ValueError("pair shapes differ: %s vs %s"
                         % (tuple(pa.shape), tuple(pb.shape)))
    if pa.device.type == "cpu":
        from iivision_tpu_torch.ops.distance import dist_pixel_pairs_plain

        return dist_pixel_pairs_plain(pa, pb, sub)
    if pa.device.type != "cuda":
        raise ValueError("no kernel for device %s" % pa.device)
    pa = pa.to(torch.int32).contiguous()
    pb = pb.to(torch.int32).contiguous()
    _check_codes(pa, pb)
    L = pa.shape[-1]
    if not 1 <= L <= MAX_L:
        raise ValueError("code strings of length %d (kernel takes 1..%d)"
                         % (L, MAX_L))
    sub_d = _sub_i32(sub, pa.device)
    out = torch.empty(pa.shape[:-1], dtype=torch.int32, device=pa.device)
    _build.launch("iiv_dist_pairs", ctypes.c_void_p(pa.data_ptr()),
                  ctypes.c_void_p(pb.data_ptr()), out.numel(), L,
                  ctypes.c_void_p(sub_d.data_ptr()),
                  ctypes.c_void_p(out.data_ptr()),
                  ctypes.c_void_p(_build.stream_ptr(pa.device)))
    _build.count(dist_pairs_elementwise, "launches")
    return out


_build.counter(dist_pairs_elementwise)


def _merged_stride(shape, stride):
    """The one element stride that walks the given dims in row-major order,
    or None if they do not merge (dims of size 1 never matter)."""
    dims = [(n, s) for n, s in zip(shape, stride) if n != 1]
    for (_, s0), (n1, s1) in zip(dims, dims[1:]):
        if s0 != n1 * s1:
            return None
    return dims[-1][1] if dims else 0


def rows_cols(va: torch.Tensor, vb: torch.Tensor):
    """Both tensors (one shape) as one (rows, cols) grid with a row and a
    column stride each, read in place: (va, vb, rows, cols, (a_rs, a_cs),
    (b_rs, b_cs)).  A lane sliced out of a (..., n_lanes) array merges into
    one strided row; a column broadcast along a row keeps stride 0.  Where
    no split of the dims merges for both, contiguous copies are taken."""
    shape = tuple(va.shape)
    for split in range(len(shape) + 1):
        strides = []
        for t in (va, vb):
            rs = _merged_stride(shape[:split], t.stride()[:split])
            cs = _merged_stride(shape[split:], t.stride()[split:])
            strides.append(None if rs is None or cs is None else (rs, cs))
        if None not in strides:
            rows = int(np.prod(shape[:split], dtype=np.int64))
            cols = int(np.prod(shape[split:], dtype=np.int64))
            return va, vb, rows, cols, strides[0], strides[1]
    return rows_cols(va.contiguous(), vb.contiguous())


def lane_distance(va: torch.Tensor, vb: torch.Tensor, mode: VideoMode,
                  lane: int, sub: torch.Tensor) -> torch.Tensor:
    """(...) int32 distances of elementwise pairs of masked lane values
    under a (16, 16) cost basis (kernel A, lane distance): one launch that
    derives both sides' colour codes in registers.

    va, vb: one shape, values of lane `lane` of `mode` (13-bit DHGR, 14-bit
    HGR).  CPU tensors run distance.dist_lane_pairs_plain.  On a card both
    must be int32 (any strides: they are read in place where the dims
    merge into a (rows, cols) grid), fewer than 2^31 pairs."""
    if va.shape != vb.shape:
        raise ValueError("pair shapes differ: %s vs %s"
                         % (tuple(va.shape), tuple(vb.shape)))
    if not 0 <= lane < spec_for_mode(mode).N_LANES:
        raise ValueError("%s has no lane %d" % (mode.name, lane))
    if sub.shape != (16, 16):
        raise ValueError("cost matrix must be (16, 16), got %s"
                         % (tuple(sub.shape),))
    if va.device.type == "cpu":
        from iivision_tpu_torch.ops.distance import dist_lane_pairs_plain

        return dist_lane_pairs_plain(va, vb, mode, lane, sub)
    if vb.device != va.device or va.dtype != torch.int32 \
            or vb.dtype != torch.int32:
        raise ValueError("kernel A's lane distance takes int32 tensors on "
                         "one device, got %s on %s and %s on %s" % (
                             va.dtype, va.device, vb.dtype, vb.device))
    if va.device.type != "cuda":
        raise ValueError("no kernel for device %s" % va.device)
    if va.numel() >= 1 << 31:
        raise ValueError("%d pairs (kernel takes fewer than 2^31)"
                         % va.numel())
    out = torch.empty(va.shape, dtype=torch.int32, device=va.device)
    if va.numel() == 0:
        return out
    va, vb, rows, cols, (a_rs, a_cs), (b_rs, b_cs) = rows_cols(va, vb)
    sub_d = _sub_i32(sub, va.device)
    _build.launch("iiv_lane_dist", ctypes.c_void_p(va.data_ptr()), a_rs, a_cs,
                  ctypes.c_void_p(vb.data_ptr()), b_rs, b_cs, rows, cols,
                  int(mode == VideoMode.DHGR), int(lane),
                  ctypes.c_void_p(sub_d.data_ptr()),
                  ctypes.c_void_p(out.data_ptr()),
                  ctypes.c_void_p(_build.stream_ptr(va.device)))
    _build.count(lane_distance, "launches")
    return out


_build.counter(lane_distance)


def lane_codes(mode: VideoMode, lane: int, device) -> torch.Tensor:
    """(2^B, L) int32 colour codes of every masked value of a lane."""
    return torch.as_tensor(lane_pixel_codes(mode, lane).astype(np.int32),
                           device=device)


def cost_matrix(palette: Palette, device) -> torch.Tensor:
    """(16, 16) int32 CIE2000 substitution costs."""
    return torch.as_tensor(substitute_matrix(palette).astype(np.int32),
                           device=device)


def edit_distance_matrix(mode: VideoMode, palette: Palette, lane: int,
                         device, out=None) -> torch.Tensor:
    """Full (N, N) uint16 distance matrix of one lane, N = 2^MASKED_BITS."""
    codes = lane_codes(mode, lane, device)
    return pair_distance(codes, codes, cost_matrix(palette, device), out)


def build_tables(mode: VideoMode, palette: Palette, device,
                 n_rows=None) -> torch.Tensor:
    """(n_lanes, N*N) uint16 LUTs of a video mode on `device`, indexed by
    (src << MASKED_BITS) + tgt (iivision_tpu/ops/editdist.py `build_tables`).
    Each lane's kernel launch writes straight into its slice.  n_rows:
    only each lane's first n_rows rows, (n_lanes, n_rows*N), through the
    general all-pairs tile (the whole table takes the symmetric one)."""
    spec = spec_for_mode(mode)
    n = 1 << spec.MASKED_BITS
    if n_rows is None:
        out = torch.empty((spec.N_LANES, n, n), dtype=torch.uint16,
                          device=device)
        for lane in range(spec.N_LANES):
            edit_distance_matrix(mode, palette, lane, device, out[lane])
        return out.reshape(spec.N_LANES, n * n)
    out = torch.empty((spec.N_LANES, n_rows, n), dtype=torch.uint16,
                      device=device)
    sub = cost_matrix(palette, device)
    for lane in range(spec.N_LANES):
        codes = lane_codes(mode, lane, device)
        pair_distance(codes[:n_rows], codes, sub, out[lane])
    return out.reshape(spec.N_LANES, n_rows * n)

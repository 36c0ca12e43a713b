"""Device ingest of a batch in one launch (csrc/ingest.cu): (B, F, H, W, 3)
uint8 frames on a card -> the encoder's targets, lanes (B, F, 32, 128,
n_lanes) and bytes (B, F, 2, 32, 256) int32, with no host round trip.

The kernel's plain version is the torch chain
`parallel.mesh.ingest_batch_plain` (per movie and chunk, `ingest_chunk`:
the Lanczos resize of `ops/resize`, the ordered dither and packing of
`ops/dither`, `encoder.prepare_targets`), which `mesh` runs on the CPU; on
a card the kernel is held to it value for value
(`chip_smoke.check_ingest`, tests/test_torch_ingest_kernel.py).

- `constants`: the kernel's tables, built on the host from the chain's
  own sources: each axis's banded resize taps (`resize.resize_taps`:
  int32 source index and float64 weight), the 8x8 Bayer thresholds, the
  sRGB -> XYZ matrix and white point, the palette's Lab values and the
  colour code of each palette entry (16 for DHGR, the 6 HGR colours for
  HGR);
- `palette_scores`: the -2 Lab and |p|^2 terms of the palette score, by
  the chain's own torch expressions;
- `ingest_batch`: one launch for the whole batch, on the current CUDA
  stream, into outputs from `torch.empty`.  The taps reach the card, and
  the palette scores (computed on the card) the host, once per (device,
  mode, palette, source size), at the first call; the small tables then
  travel in each launch's parameters, so a later call copies nothing
  between host and card.  Counts its launches in
  `ingest_batch.launches`.
"""

import ctypes
import functools

import numpy as np
import torch

from iivision_tpu_torch import _build, palettes
from iivision_tpu_torch.ops import dither, resize
from iivision_tpu_torch.palettes import Palette, require_palette
from iivision_tpu_torch.screen import spec_for_mode
from iivision_tpu_torch.video_mode import VideoMode, require_mode

OUT_H, OUT_W = 192, 140  # frames.TARGET_H, frames.TARGET_W
ROW_STEPS = (24, 12, 8, 6, 4, 3, 2, 1)  # screen rows a block resizes at once
STEP_BYTES = 24 * 1024  # shared memory a step's float64 rows may take


def palette_codes(mode: VideoMode) -> np.ndarray:
    """The colour code of each palette entry the quantizer picks from:
    all 16 for DHGR (`quantize_ordered`), the 6 HGR colours for HGR
    (`quantize_hgr`)."""
    if require_mode(mode) == VideoMode.DHGR:
        return np.arange(16, dtype=np.int32)
    return np.asarray(sorted(set(dither.HGR_COLOURS_P0)
                             | set(dither.HGR_COLOURS_P1)), np.int32)


def constants(mode: VideoMode, palette: Palette, h_in: int,
              w_in: int) -> dict:
    """The kernel's tables on the host (CPU tensors), for (h_in, w_in)
    sources: h_idx / h_w (192, kh) and w_idx / w_w (140, kw) taps (int32
    index, float64 weight), bayer (8, 8) and xyz (12,: the matrix's rows,
    then the white point) float32, lab (n, 3) float32 and codes (n,)
    int32."""
    out = {}
    for axis, n_in, n_out in (("h", h_in, OUT_H), ("w", w_in, OUT_W)):
        idx, w = resize.resize_taps(n_in, n_out)
        out[axis + "_idx"] = torch.as_tensor(idx.astype(np.int32))
        out[axis + "_w"] = torch.as_tensor(w.astype(np.float64))
    out["bayer"] = torch.as_tensor(dither._bayer_matrix(8),
                                   dtype=torch.float32)
    out["xyz"] = torch.as_tensor(np.concatenate(
        [palettes._SRGB_TO_XYZ.reshape(-1), palettes._D65_WHITE]),
        dtype=torch.float32)
    codes = palette_codes(mode)
    out["lab"] = torch.as_tensor(
        dither._palette_lab(require_palette(palette))[codes],
        dtype=torch.float32)
    out["codes"] = torch.as_tensor(codes)
    return out


def palette_scores(lab: torch.Tensor) -> torch.Tensor:
    """(4, n) float32: the rows of -2 lab.T, then |p|^2, by the chain's
    own expressions (`dither._nearest`) on lab's device, so the kernel's
    scores add the same float32 values."""
    return torch.cat([-2.0 * lab.T, (lab ** 2).sum(dim=-1)[None]])


@functools.lru_cache(None)
def _launch_constants(device: torch.device, mode: VideoMode,
                      palette: Palette, h_in: int, w_in: int):
    """(taps on `device`, tables on the host for the launch's parameters):
    `constants`, with `palette_scores` in place of lab, computed on
    `device` and brought back once.  Built at the first call for each key,
    which waits for its copies."""
    c = constants(mode, palette, h_in, w_in)
    taps = {k: c[k].to(device).contiguous()
            for k in ("h_idx", "h_w", "w_idx", "w_w")}
    host = dict(bayer=c["bayer"].contiguous(), xyz=c["xyz"],
                pal=palette_scores(c["lab"].to(device)).cpu().contiguous(),
                codes=c["codes"])
    torch.cuda.current_stream(device).synchronize()
    return taps, host


def rows_per_step(w_in: int) -> int:
    """Screen rows a block resizes at once: the most (a divisor of its 24)
    whose float64 intermediate rows fit STEP_BYTES, at least 1."""
    row = 8 * 3 * w_in + 4 * OUT_W
    return next((r for r in ROW_STEPS if r * row <= STEP_BYTES), 1)


def ingest_batch(rgb_b: torch.Tensor, mode: VideoMode, palette: Palette):
    """(B, F, H, W, 3) uint8 frames on a card -> (lanes (B, F, 32, 128,
    n_lanes), bytes (B, F, 2, 32, 256)) int32 on that card, in one launch
    of csrc/ingest.cu (see the module docstring).  Frames elsewhere, or of
    another dtype or rank, raise ValueError before a launch."""
    mode = require_mode(mode)
    palette = require_palette(palette)
    if rgb_b.device.type != "cuda":
        raise ValueError("ingest_batch runs the card's kernel; got frames "
                         "on %s (mesh.ingest_movies_batch takes the torch "
                         "chain there)" % rgb_b.device)
    if rgb_b.dtype != torch.uint8 or rgb_b.dim() != 5 \
            or rgb_b.shape[-1] != 3:
        raise ValueError("ingest_batch takes (B, F, H, W, 3) uint8 frames; "
                         "got %s %s" % (rgb_b.dtype, tuple(rgb_b.shape)))
    B, F, H, W = rgb_b.shape[:4]
    dev = rgb_b.device
    n_lanes = spec_for_mode(mode).N_LANES
    lanes = torch.empty((B, F, 32, 128, n_lanes), dtype=torch.int32,
                        device=dev)
    bytes_ = torch.empty((B, F, 2, 32, 256), dtype=torch.int32, device=dev)
    if B * F == 0:
        return lanes, bytes_
    rgb_b = rgb_b.contiguous()
    taps, host = _launch_constants(dev, mode, palette, H, W)
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (
        taps["h_idx"], taps["h_w"], taps["w_idx"], taps["w_w"],
        host["bayer"], host["xyz"], host["pal"], host["codes"])]
    _build.launch(
        "iiv_ingest_batch", ctypes.c_void_p(rgb_b.data_ptr()), B * F, H, W,
        ptr[0], ptr[1], taps["h_idx"].shape[1], ptr[2], ptr[3],
        taps["w_idx"].shape[1], ptr[4], ptr[5], ptr[6], ptr[7],
        host["codes"].shape[0], int(mode == VideoMode.HGR), rows_per_step(W),
        ctypes.c_void_p(lanes.data_ptr()), ctypes.c_void_p(bytes_.data_ptr()),
        ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.count(ingest_batch)
    return lanes, bytes_


_build.counter(ingest_batch)

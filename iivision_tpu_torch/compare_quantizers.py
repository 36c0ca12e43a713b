"""Image-level quantizer comparison harness (the port's copy of
iivision_tpu/compare_quantizers.py; bmp2dhr quality parity).

The reference's visual baseline is defined by the external bmp2dhr C++
binary: 280x192 BMP -> Buckels "D9" dither -> (D)HGR memory dumps
(reference transcoder/frame_grabber.py:75-108: `bmp2dhr f.bmp dhgr P<n> A
D9`).  This harness compares any of the following quantizations of the
same source frames at image level - each is rendered (nominal palette and
NTSC-composite YIQ renderers) and scored against the source with PSNR and
mean CIEDE2000:

- this package's ordered (Bayer) dither (the C++ host path);
- its native error-diffusion kernels (sim/csrc/dither.cpp);
- a bmp2dhr binary, when one is available (--bmp2dhr PATH; the exact
  reference invocation is reproduced);
- a reference frame-cache directory of pregenerated bmp2dhr dumps
  (--reference_cache DIR, `%08d.BIN/.AUX` layout).

The source's resizes (to 280x192, then to 140x192) run on `--device`
(default cuda; the CPU only when asked), through `ops/resize.resize_batch`:

    python -m iivision_tpu_torch.compare_quantizers \
        tests/fixtures/parity_frames.npz [--bmp2dhr PATH] [--report]

Scores print as a table; --report appends it to AB_REPORT.md.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from iivision_tpu_torch import frames, palettes, render, require_device
from iivision_tpu_torch.ops import dither, resize
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode


def run_bmp2dhr(rgb280: np.ndarray, mode: VideoMode, palette: Palette,
                binary: str):
    """Quantize one (192, 280, 3) uint8 frame through a bmp2dhr binary.

    Reproduces the reference's exact invocation (frame_grabber.py:78-83,
    103-108).  Returns (main (32, 256), aux (32, 256) | None).
    """
    from PIL import Image

    with tempfile.TemporaryDirectory() as td:
        bmp = os.path.join(td, "f.bmp")
        Image.fromarray(rgb280).save(bmp)
        if mode == VideoMode.DHGR:
            subprocess.check_call(
                [binary, bmp, "dhgr", "P%d" % palette.value, "A", "D9"])
            main = np.fromfile(os.path.join(td, "f.BIN"), np.uint8)
            aux = np.fromfile(os.path.join(td, "f.AUX"), np.uint8)
            return main.reshape(32, 256), aux.reshape(32, 256)
        subprocess.check_call(
            [binary, bmp, "hgr", "P%d" % palette.value, "D9"])
        main = np.fromfile(os.path.join(td, "fC.BIN"), np.uint8)
        return main.reshape(32, 256), None


def our_variants(rgb140: np.ndarray, mode: VideoMode, palette: Palette):
    """This package's quantizers for one (192, 140, 3) frame.

    Yields (name, main, aux)."""
    if mode == VideoMode.DHGR:
        codes = dither.quantize_ordered_host(rgb140[None], palette)[0]
        m, a = dither.dhgr_pack_host(codes[None])
        yield "ordered", m[0], a[0]
        for kernel in ("buckels", "atkinson", "jarvis", "d1", "d4", "d9"):
            c = dither.quantize_error_diffusion(
                rgb140.astype(np.float32), palette, kernel=kernel)
            m, a = dither.dhgr_pack_host(np.asarray(c, np.uint8)[None])
            yield kernel, m[0], a[0]
    else:
        yield "ordered", dither.quantize_hgr_host(rgb140[None], palette)[0], \
            None


def score_screen(main, aux, src140: np.ndarray, mode: VideoMode,
                 palette: Palette) -> dict:
    """PSNR and mean CIEDE2000 of the rendered screen against the source,
    and the PSNR of the NTSC-composite rendering."""
    out = np.asarray(render.screen_to_rgb(main, aux, mode, palette),
                     np.float64)
    lab_out = palettes.srgb_to_lab(out)
    lab_src = palettes.srgb_to_lab(src140.astype(np.float64))
    de = palettes.delta_e_cie2000(lab_out, lab_src)
    out_y = np.asarray(render.screen_to_rgb_yiq(main, aux, mode, palette),
                       np.float64)
    return dict(psnr=render.psnr(out, src140), cie2000=float(np.mean(de)),
                psnr_yiq=render.psnr(out_y, src140))


def _resize(rgb: np.ndarray, h: int, w: int, device) -> np.ndarray:
    return resize.resize_batch(torch.as_tensor(rgb, device=device), h,
                               w).cpu().numpy()


def load_frames(source: str, n_frames: int, device="cuda") -> np.ndarray:
    """(N, 192, 280, 3) uint8 source frames from any supported source,
    resized on `device` where they are of another size."""
    device = require_device(device)
    it, _rate = frames.iter_video_frames(source)
    out = []
    for i, f in enumerate(it):
        if i >= n_frames:
            break
        f = np.asarray(f, np.uint8)
        if f.shape[:2] != (192, 280):
            f = _resize(f[None], 192, 280, device)[0]
        out.append(f)
    return np.stack(out)


def compare(source: str, mode: VideoMode, palette: Palette,
            n_frames: int = 4, bmp2dhr: str = None,
            reference_cache: str = None, device="cuda"):
    """Run all available quantizers over the source; returns rows
    [(name, {psnr, cie2000, psnr_yiq})] averaged over frames, best PSNR
    first."""
    src280 = load_frames(source, n_frames, device)
    src140 = _resize(src280, 192, 140, require_device(device))

    totals = {}

    def add(name, s):
        t = totals.setdefault(name, {})
        for k, v in s.items():
            t[k] = t.get(k, 0.0) + v / len(src280)

    for i in range(len(src280)):
        for name, m, a in our_variants(src140[i], mode, palette):
            add(name, score_screen(m, a, src140[i], mode, palette))
        if bmp2dhr:
            m, a = run_bmp2dhr(src280[i], mode, palette, bmp2dhr)
            add("bmp2dhr_D9", score_screen(m, a, src140[i], mode, palette))
        if reference_cache:
            tm, ta, n = frames.load_reference_cache(reference_cache, mode)
            if i < n:
                add("bmp2dhr_cache", score_screen(
                    tm[i], None if ta is None else ta[i], src140[i],
                    mode, palette))
    return sorted(totals.items(), key=lambda kv: -kv[1]["psnr"])


def format_table(rows, mode, palette, source, n) -> str:
    lines = ["", "## Quantizer image-level comparison (%s/%s, %d frames"
             " of %s)" % (mode.name, palette.name, n, os.path.basename(
                 str(source))), "",
             "| quantizer | PSNR (dB) | mean CIEDE2000 | PSNR (composite) |",
             "|---|---|---|---|"]
    for name, s in rows:
        lines.append("| %s | %.2f | %.2f | %s |" % (
            name, s["psnr"], s["cie2000"],
            "%.2f" % s["psnr_yiq"] if "psnr_yiq" in s else "-"))
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", help="image/gif/npy/npz/video source")
    ap.add_argument("--video_mode", default="DHGR",
                    choices=[m.name for m in VideoMode])
    ap.add_argument("--palette", default="NTSC",
                    choices=[p.name for p in Palette if p.value >= 0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the resizes (default: cuda).")
    ap.add_argument("--bmp2dhr", default=None,
                    help="Path to a bmp2dhr binary (runs the reference's "
                         "exact D9 invocation for comparison).")
    ap.add_argument("--reference_cache", default=None,
                    help="Reference frame-cache dir of bmp2dhr dumps.")
    ap.add_argument("--report", action="store_true",
                    help="Append the table to AB_REPORT.md.")
    a = ap.parse_args(argv)

    mode, pal = VideoMode[a.video_mode], Palette[a.palette]
    rows = compare(a.source, mode, pal, a.frames, bmp2dhr=a.bmp2dhr,
                   reference_cache=a.reference_cache, device=a.device)
    table = format_table(rows, mode, pal, a.source, a.frames)
    print(table)
    if a.report:
        with open(os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "AB_REPORT.md"), "a") as f:
            f.write(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())

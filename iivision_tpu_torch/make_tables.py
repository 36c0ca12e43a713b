"""CLI: generate the reference-layout edit-distance LUTs through kernel A
(counterpart of iivision_tpu/make_tables.py, `--what luts`).

    python -m iivision_tpu_torch.make_tables --what luts --modes DHGR \\
        --palettes NTSC --device cuda

Writes the same npz files as the JAX package (upper triangle, symmetrised
at load; `editdist.save_tables`, shared).  `--what store_cost` is not
ported yet: the encoder loads the shipped store-cost tables.
"""

import argparse
import os
import time

import torch

from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode

from iivision_tpu_torch import require_device


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Generate (D)HGR edit-distance LUTs (PyTorch + CUDA).")
    parser.add_argument("--data_dir", default=None,
                        help="Output directory (default: package data/).")
    parser.add_argument("--modes", nargs="+", default=["HGR", "DHGR"],
                        choices=[m.name for m in VideoMode])
    parser.add_argument("--palettes", nargs="+", default=["NTSC", "IIGS"],
                        choices=[p.name for p in Palette if p.value >= 0])
    parser.add_argument("--what", nargs="+", default=["luts"],
                        choices=["luts", "store_cost"])
    parser.add_argument("--device", default="cuda",
                        help="torch device to build on (default: cuda).")
    a = parser.parse_args(args)
    if "store_cost" in a.what:
        parser.error("--what store_cost is not ported to iivision_tpu_torch "
                     "yet (ROADMAP.md Queue 1: 'the torch _build_store_cost'"
                     " and 'the HGR make_tables store_cost path')")
    device = require_device(a.device)

    from iivision_tpu.ops.distance import DATA_DIR, _user_cache_dir
    from iivision_tpu_torch.ops import editdist

    if a.data_dir is None and not os.access(DATA_DIR, os.W_OK):
        a.data_dir = _user_cache_dir()
        os.makedirs(a.data_dir, exist_ok=True)
        print("package data/ not writable; writing LUTs to %s" % a.data_dir)

    for pal_name in a.palettes:
        for mode_name in a.modes:
            mode, pal = VideoMode[mode_name], Palette[pal_name]
            t0 = time.time()
            tables = editdist.build_tables(mode, pal, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_build = time.time() - t0
            t0 = time.time()
            path = editdist.save_tables(tables.cpu().numpy(), mode, pal,
                                        a.data_dir)
            print("%s/%s: built %.2fs on %s, saved %.1fs -> %s"
                  % (mode_name, pal_name, t_build, device,
                     time.time() - t0, path))
            del tables


if __name__ == "__main__":
    main()

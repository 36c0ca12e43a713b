"""CLI: generate the distance-model artifacts on a torch device
(counterpart of iivision_tpu/make_tables.py).

    python -m iivision_tpu_torch.make_tables --what luts store_cost \\
        --modes DHGR --palettes NTSC --device cuda

- `--what luts`: the reference-layout edit-distance LUTs through kernel A's
  all-pairs entry (upper triangle, symmetrised at load;
  `editdist.save_tables`).
- `--what store_cost`: the encoder's store-cost tables for `--models`,
  through kernel A's lane-distance entry (window) or the yiq window sums
  (`distance.save_store_cost`).  The encoder builds a missing
  table itself on first use (mono has none shipped).

Both write the same npz files as the JAX package.
"""

import argparse
import os
import time

import torch

from iivision_tpu_torch import DATA_DIR, require_device
from iivision_tpu_torch.palettes import Palette
from iivision_tpu_torch.video_mode import VideoMode


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Generate (D)HGR distance-model artifacts "
                    "(PyTorch + CUDA).")
    parser.add_argument("--data_dir", default=None,
                        help="Output directory (default: the JAX package's "
                             "data/ directory, DATA_DIR).")
    parser.add_argument("--modes", nargs="+", default=["HGR", "DHGR"],
                        choices=[m.name for m in VideoMode])
    parser.add_argument("--palettes", nargs="+", default=["NTSC", "IIGS"],
                        choices=[p.name for p in Palette if p.value >= 0])
    parser.add_argument("--what", nargs="+", default=["luts", "store_cost"],
                        choices=["luts", "store_cost"])
    parser.add_argument("--models", nargs="+", default=["window"],
                        choices=["window", "yiq"],
                        help="Colour models for store-cost artifacts.")
    parser.add_argument("--device", default="cuda",
                        help="torch device to build on (default: cuda).")
    a = parser.parse_args(args)
    device = require_device(a.device)

    from iivision_tpu_torch.ops import distance, editdist

    if a.data_dir is None and not os.access(DATA_DIR, os.W_OK):
        a.data_dir = distance._user_cache_dir()
        os.makedirs(a.data_dir, exist_ok=True)
        print("data/ not writable; writing artifacts to %s"
              % a.data_dir)

    for pal_name in a.palettes:
        for mode_name in a.modes:
            mode, pal = VideoMode[mode_name], Palette[pal_name]
            if "store_cost" in a.what:
                for model in a.models:
                    t0 = time.time()
                    cost = distance.build_store_cost(mode, pal, model, device)
                    _sync(device)
                    t_build = time.time() - t0
                    path = distance.save_store_cost(
                        cost.cpu().numpy().astype("float32"), mode, pal,
                        model, a.data_dir)
                    print("store_cost %s/%s/%s: built %.2fs on %s -> %s"
                          % (mode_name, pal_name, model, t_build, device,
                             path))
            if "luts" in a.what:
                t0 = time.time()
                tables = editdist.build_tables(mode, pal, device)
                _sync(device)
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

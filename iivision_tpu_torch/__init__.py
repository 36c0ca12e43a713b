"""ii-vision on PyTorch + CUDA: the DHGR and HGR transcode (window, yiq and
mono colour models, default or joint content), solo or as a batch of
movies, the quality scorer, LUT and store-cost generation and the sub-op
microbenchmark for one NVIDIA H100, beside the JAX package `iivision_tpu`.

The JAX package is the reference this package is held against.  Modules
that never touch JAX are imported from it, not copied: the stream ABI
(`stream/*`), the C++ player VM and 6502 machine (`sim/*`), palettes and
colours, the screen address tables, `encoder.plan_movie` / `flatten_ops`,
the host ingest path of `frames` and the audio decoding of `audio.Audio`.
What runs through `jax` there is written here in torch:

- `screen`: masked-lane derivation (exact int32);
- `ops.distance`: lane pixels, the diagonal Damerau-Levenshtein diff, the
  yiq window sums and the store-cost tables (loaded or built);
- `ops.yiq`: the yiq model's window codes;
- `ops.editdist`: all-pairs edit-distance tiles (kernel A, CUDA);
- `ops.random`: threefry2x32 nonces, bit-equal to `jax.random`, for one
  key or a batch of keys;
- `ops.subop`: the encoder's sequential sub-op chain for B movies, default
  and joint content (kernel B, CUDA);
- `ops.subop_bench`: the sub-op microbenchmark's math (kernel C, CUDA);
- `ops.resize`: the batched Lanczos resize (float64 einsums);
- `ops.dither`: the ordered, HGR and mono quantizers and screen packing;
- `parallel.mesh`: batch ingest, batch and mixed-length encodes and op
  fetches on one card;
- `quality`: replay and perceptual scoring of emitted streams;
- `encoder`, `audio`, `movie`, `cli`, `make_tables`, `bench_subop`.

Device policy: every function that allocates takes an explicit `device`;
nothing here guesses one.  A CUDA tensor runs the hand-written kernels and
a CPU tensor runs their plain torch versions - the choice follows the
tensor, never a fallback.
"""

import os

import torch

# iivision_tpu/__init__.py configures a JAX compile cache (importing jax)
# unless IIVISION_NO_COMPILE_CACHE is set when it first loads.  Set it for
# that import only, so the shared modules load no JAX, then put the
# environment back: the JAX package's AOT cache reads the same variable
# at call time, and a process may run both packages.  The port itself has
# no compile cache.
_OPT_OUT = "IIVISION_NO_COMPILE_CACHE"
_had_opt_out = _OPT_OUT in os.environ
os.environ.setdefault(_OPT_OUT, "1")
try:
    from iivision_tpu.palettes import Palette  # noqa: F401
    from iivision_tpu.video_mode import VideoMode  # noqa: F401
finally:
    if not _had_opt_out:
        del os.environ[_OPT_OUT]

__version__ = "0.1.0"


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a usable card
    raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but torch.cuda.is_available()"
                           " is false" % dev)
    return dev

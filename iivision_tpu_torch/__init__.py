"""ii-vision on PyTorch + CUDA: the DHGR and HGR transcode (window, yiq and
mono colour models, default or joint content), solo (whole-movie, chunked
or streaming) or as a batch of movies, the quality scorer and renderer,
LUT and store-cost generation and the sub-op microbenchmark for one NVIDIA
H100, and the delivery of the streams it writes (the TCP server, stream
retargeting and seeking, verification on the 6502 machine, rendering, the
boot disk), beside the JAX package `iivision_tpu`.

The JAX package is the reference this package is held against; this
package imports nothing of it.  What it needs of the JAX package's
host-side modules is copied here under the same names (`video_mode`,
`palettes`, `colours`, `screen`, `plan`, `stream` (opcodes, framing,
`retarget`, `seek`), `frames`, `render`, `sim` (the player VM, the 6502
assembler `asm65` and machine `machine65`), `server`, `verify_stream`,
`render_stream`, `prodos`, `make_disk`, and helpers inside `ops`,
`quality`, `audio`, `cli`).  Data files are not copied: they are read by
path from `DATA_DIR`, the JAX package's `data/` directory (the shipped
store-cost tables, the player's `iivision.dbg`, its source
`player/main.s` and the template disk `player/prodos_template.dsk`).

What runs through `jax` there is written here in torch:

- `screen`: masked-lane derivation (exact int32);
- `ops.distance`: lane pixels, the diagonal Damerau-Levenshtein diff, the
  yiq window sums and the store-cost tables (loaded or built);
- `ops.yiq`: the yiq model's window codes;
- `ops.editdist`: all-pairs edit-distance tiles (kernel A, CUDA);
- `ops.random`: threefry2x32 nonces, bit-equal to `jax.random`;
- `ops.chunk_start`: the encoder's chunk-start diff and priority update
  in plain torch (on a card the body kernel's prologue);
- `ops.body`: one chunk body of the encoder - the chunk start's recompute,
  page top-k, nonces and the sub-op chain - in one launch (CUDA, a
  thread-block cluster per movie);
- `ops.subop`: the per-step sub-op chain, default and joint content, in
  plain torch (what the body's plain version runs);
- `ops.subop_bench`: the sub-op microbenchmark's math (kernel C, CUDA);
- `ops.resize`: the batched Lanczos resize (float64 einsums);
- `ops.dither`: the ordered, HGR and mono quantizers and screen packing;
- `parallel.mesh`: batch ingest, batch and mixed-length encodes, op
  fetches and the LUT build, on one card or sharded over a mesh of
  devices;
- `quality`: replay and perceptual scoring of emitted streams;
- `roofline`: the encode's cost model on a card's peaks;
- `encoder`, `audio`, `movie`, `cli`, `make_tables`, `bench_subop`.

Host tools with no device code: `encoder_host` (the numpy oracle of the
encoder), `encoder_parity` (the reference-order k=1 greedy) and
`compare_quantizers` (the image-level quantizer harness, whose resizes run
on its `--device`).

Device policy: every function that allocates takes an explicit `device`;
nothing here guesses one.  A CUDA tensor runs the hand-written kernels and
a CPU tensor runs their plain torch versions - the choice follows the
tensor, never a fallback.
"""

import os

import torch

__version__ = "0.1.0"

# the JAX package's data directory, read by path (never imported): shipped
# store-cost tables, the player's symbol file and source, the template disk
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "iivision_tpu", "data")


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a usable card
    raises instead of running anywhere else.  A bare "cuda" names the
    current card by its index, as the tensors made there name it, so that
    devices compare equal to their tensors' (`dist.device ==
    lanes.device`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device %s requested but "
                               "torch.cuda.is_available() is false" % dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""The whole-movie encoder, B movies in lockstep (counterpart of
iivision_tpu/encoder.py `_build_encode_scan` / `encode_movie`, and of its
`vmap` over a batch in iivision_tpu/parallel/mesh.py).

The JAX encoder is one XLA scan over chunk bodies and their steps; this is
the same computation as a Python loop over the same plan (`plan.plan_movie`)
with one call per body:

- at a chunk start, the diff of the active bank against the frame's target
  and the priority update (`ops/chunk_start`: one kernel launch for all B
  movies on a card, for every colour model);
- the body's steps (`ops/body`): per step the k busiest pages of each movie
  (a stable top-k: ties go to the lower page, as `lax.top_k` orders them)
  and j sequential sub-ops on each, with the nonces drawn inside - one
  kernel launch per body on a card, the body kernel's joint instantiation
  for joint content (`--joint_content`).

A CPU tensor runs the plain torch forms inside the same wrappers.  Output
is byte-identical to the JAX package for the same seeds: the nonces are
`jax.random`'s bits, the float32 expressions are the same, and the dtype
boundaries are kept (state is int32 between bodies, float32 within
one).  The solo encode is the
B = 1 call.

What the JAX package needed only on the TPU is left out: the cost slab
per body (the kernels read the int16 store-cost table directly), the
carried-slab strategies, step bucketing and frame padding, AOT programs,
split fetches and the `diag` ablations.  One whole-movie encode serves
every length; the JAX package's chunked and streaming encoders exist for
TPU memory bounds and are bit-identical to its unchunked one.
"""

from typing import Optional

import torch

from iivision_tpu_torch import screen
from iivision_tpu_torch.ops import body, chunk_start
from iivision_tpu_torch.ops import random as trandom
from iivision_tpu_torch.ops.chunk_start import n_banks
from iivision_tpu_torch.plan import (  # noqa: F401
    OP_FIELDS, MoviePlan, flatten_ops, plan_movie)
from iivision_tpu_torch.video_mode import VideoMode, require_mode


def prepare_targets(frames_main, frames_aux, mode: VideoMode, device):
    """Per-frame encoder targets from (..., 32, 256) uint8 screen banks
    (numpy arrays or tensors; frames_aux is None for HGR).

    Returns (lanes_tgt (..., 32, 128, n_lanes) int32, bytes_tgt
    (..., 2, 32, 256) int32) on `device`; HGR stacks its one bank twice, as
    the JAX package does."""
    main = torch.as_tensor(frames_main, device=device)
    if require_mode(mode) == VideoMode.DHGR:
        aux = torch.as_tensor(frames_aux, device=device)
        lanes = screen.dhgr_masked_lanes(main, aux)
    else:
        aux = main
        lanes = screen.hgr_masked_lanes(main)
    bytes_tgt = torch.stack([main.to(torch.int32), aux.to(torch.int32)],
                            dim=-3)
    return lanes, bytes_tgt


def encode_movies(dist, lanes_tgt_b, bytes_tgt_b, plan: MoviePlan,
                  mode: VideoMode, seeds, joint: bool = False):
    """Encode B planned movies in lockstep on the targets' device.

    lanes_tgt_b: (B, F, 32, 128, n_lanes) int32; bytes_tgt_b:
    (B, F, 2, 32, 256) int32; every movie follows `plan`.
    dist: a distance.ComputedDistance on the same device.
    seeds: B ints, or None for deterministic tie-breaks (testing).
    joint: joint content selection (`--joint_content`).
    Returns (ops (B, S, K*J, 6) uint8, final main (B, 32, 256) int32, final
    aux (B, 32, 256)) as tensors on the device; for HGR the final aux is
    the main bank.
    """
    require_mode(mode)
    dev = lanes_tgt_b.device
    if dist.device != dev or bytes_tgt_b.device != dev:
        raise ValueError("targets on %s, distance model on %s"
                         % (dev, dist.device))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("no encoder for device %s" % dev)
    B = lanes_tgt_b.shape[0]
    if seeds is not None and len(seeds) != B:
        raise ValueError("%d seeds for %d movies" % (len(seeds), B))
    k, j, Sc = plan.k, plan.j, plan.chunk_steps
    if not 1 <= k <= 32:
        raise ValueError("k=%d pages per step (a bank has 32)" % k)
    sf, sb, sr = plan.step_frame, plan.step_bank, plan.step_recompute
    S = len(sf)
    if S % Sc:
        raise ValueError("plan steps (%d) not a multiple of the chunk "
                         "length (%d)" % (S, Sc))
    lanes_tgt_b = lanes_tgt_b.contiguous()
    bytes_tgt_b = bytes_tgt_b.contiguous()
    table = dist.store_cost16.reshape(-1, dist.n_contents)

    zero = torch.zeros((B, n_banks(mode), 32, 256), dtype=torch.int32,
                       device=dev)
    banks, up, dw = zero.clone(), zero.clone(), zero.clone()
    # every record starts as the padding op (page 32, the active bank's
    # target byte at (0, 0), zero offsets); steps run overwrite theirs
    pad = bytes_tgt_b[:, torch.tensor(sf, dtype=torch.int64, device=dev),
                      torch.tensor(sb, dtype=torch.int64, device=dev),
                      0, 0].T  # (S, B)
    ops = torch.zeros((S, B, j, k, OP_FIELDS), dtype=torch.uint8,
                      device=dev)
    ops[..., 0] = 32
    ops[..., 1] = pad.to(torch.uint8)[:, :, None, None]
    nvalid = torch.tensor(plan.step_nvalid, dtype=torch.int32, device=dev)
    keys = None if seeds is None else trandom.key_words(seeds, dev)
    for b0 in range(0, S, Sc):
        frame, bank = int(sf[b0]), int(sb[b0])
        if sr[b0]:
            chunk_start.chunk_start(banks, lanes_tgt_b, frame, bank,
                                    dist.sub, up, dw, mode)
        body.encode_body(up, dw, banks, lanes_tgt_b, bytes_tgt_b, frame,
                         bank, table, keys, nvalid, b0, Sc, ops, mode, joint)
    ops = ops.transpose(0, 1).reshape(B, S, k * j, OP_FIELDS)
    # HGR's one bank is both main and aux, as the JAX encoder returns it
    return ops, banks[:, 0], banks[:, -1]


def encode_movie(dist, lanes_tgt, bytes_tgt, plan: MoviePlan,
                 mode: VideoMode, seed: Optional[int] = 0,
                 joint: bool = False):
    """Encode one planned movie on the targets' device: the B = 1 call of
    `encode_movies`.

    seed=None disables random tie-breaks (deterministic, for testing).
    Returns (ops (S, K*J, 6) uint8, final main (32, 256) int32, final aux)
    as tensors on the device; for HGR the final aux is the main bank.
    """
    ops, main, aux = encode_movies(
        dist, lanes_tgt[None], bytes_tgt[None], plan, mode,
        None if seed is None else [seed], joint)
    return ops[0], main[0], aux[0]

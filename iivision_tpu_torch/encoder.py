"""The whole-movie encoder, B movies in lockstep (counterpart of
iivision_tpu/encoder.py `_build_encode_scan` / `encode_movie`, and of its
`vmap` over a batch in iivision_tpu/parallel/mesh.py).

The JAX encoder is one XLA scan over chunk bodies and their steps; this is
the same computation as a Python loop over the same plan (`plan.plan_movie`)
with one call per body (`ops/body.encode_body`, one kernel launch for all
B movies on a card, as the JAX package's `chunk_body` is one body):

- at a chunk start, the diff of the active bank against the frame's target
  and the priority update (`ops/chunk_start`'s computation, for every
  colour model: the body kernel's prologue on a card);
- the body's steps: per step the k busiest pages of each movie (a stable
  top-k: ties go to the lower page, as `lax.top_k` orders them) and j
  sequential sub-ops on each, with the nonces drawn inside - the body
  kernel's joint instantiation for joint content (`--joint_content`).

A CPU tensor runs the plain torch forms inside the same wrappers.  Output
is byte-identical to the JAX package for the same seeds: the nonces are
`jax.random`'s bits, the float32 expressions are the same, and the dtype
boundaries are kept (state is int32 between bodies, float32 within
one).  The solo encode is the
B = 1 call.

The encode is resumable: `new_state` makes the carried state (screens,
priorities, diffs, key words, the plan's `nvalid` and the op records, all
on the device) and `encode_segment` runs a range of plan steps on it, with
that range's targets only.  `encode_movies` is the one-segment call.
`encode_movie_chunked` and `encode_movie_streaming` (the JAX package's
long-movie encoders, same names) run a segment per `chunk_frames` encoded
frames: targets go up per segment, so device memory for them is bounded,
and on a card the upload, the encode and the fetch of the records overlap
each other and the host's ingest.  The op records and `nvalid` stay
whole-movie on the device (48 bytes a step at k=8 j=1), so the kernels
take absolute step indices and segment-relative frame indices as they
are, and a segment's records are fetched as the slice `ops[s0:s1]`.  Every
split gives the whole-movie encode's bytes.

The encodes take `into`, a dict of stage timings (`Movie.timings`), and
open `trace.span`s in it: `encode.targets` (a segment's upload and
`prepare_targets`), `encode.launch` (each `encode_segment` call's loop of
body launches, one span a call) and `encode.wait` (the host's wait for the
records and final screens); `encode_segment` adds the bodies it launches
to `into["body_launches"]`.

What the JAX package needed only on the TPU is left out: the cost slab
per body (the kernels read the int16 store-cost table directly), the
carried-slab strategies, step bucketing, frame and segment padding to one
compiled shape, AOT programs, split fetches and the `diag` ablations.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from iivision_tpu_torch import screen
from iivision_tpu_torch.ops import body
from iivision_tpu_torch.ops import random as trandom
from iivision_tpu_torch.ops.chunk_start import n_banks
from iivision_tpu_torch.plan import (  # noqa: F401
    OP_FIELDS, MoviePlan, flatten_ops, ops_to_ticks, plan_movie)
from iivision_tpu_torch.trace import span
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


@dataclass
class EncodeState:
    """What an encode carries from one segment of the plan to the next:
    the screen banks, the update priorities and the live diffs of B movies
    ((B, n_banks, 32, 256) int32 each, updated in place), the seeds' key
    words, and the whole plan's `nvalid` and op records on the device."""
    dist: object
    plan: MoviePlan
    mode: VideoMode
    joint: bool
    banks: torch.Tensor
    up: torch.Tensor
    dw: torch.Tensor
    keys: Optional[torch.Tensor]
    nvalid: torch.Tensor
    step_frame: torch.Tensor  # (S,) int64 on the device
    step_bank: torch.Tensor
    ops: torch.Tensor  # (S, B, j, k, 6) uint8

    def result(self):
        """(ops (B, S, K*J, 6) uint8, final main (B, 32, 256) int32, final
        aux); HGR's one bank is both main and aux, as the JAX encoder
        returns it."""
        S, B, j, k = self.ops.shape[:4]
        ops = self.ops.transpose(0, 1).reshape(B, S, k * j, OP_FIELDS)
        return ops, self.banks[:, 0], self.banks[:, -1]


def new_state(dist, plan: MoviePlan, mode: VideoMode, seeds, B: int,
              joint: bool = False) -> EncodeState:
    """The state before the first step: blank screens, on `dist`'s
    device."""
    require_mode(mode)
    dev = dist.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("no encoder for device %s" % dev)
    if seeds is not None and len(seeds) != B:
        raise ValueError("%d seeds for %d movies" % (len(seeds), B))
    k, j, Sc = plan.k, plan.j, plan.chunk_steps
    if not 1 <= k <= 32:
        raise ValueError("k=%d pages per step (a bank has 32)" % k)
    S = len(plan.step_frame)
    if S % Sc:
        raise ValueError("plan steps (%d) not a multiple of the chunk "
                         "length (%d)" % (S, Sc))
    zero = torch.zeros((B, n_banks(mode), 32, 256), dtype=torch.int32,
                       device=dev)
    return EncodeState(
        dist=dist, plan=plan, mode=mode, joint=joint,
        banks=zero.clone(), up=zero.clone(), dw=zero,
        keys=None if seeds is None else trandom.key_words(seeds, dev),
        nvalid=torch.tensor(plan.step_nvalid, dtype=torch.int32, device=dev),
        step_frame=torch.tensor(plan.step_frame, dtype=torch.int64,
                                device=dev),
        step_bank=torch.tensor(plan.step_bank, dtype=torch.int64,
                               device=dev),
        ops=torch.empty((S, B, j, k, OP_FIELDS), dtype=torch.uint8,
                        device=dev))


def encode_segment(state: EncodeState, lanes_tgt_b, bytes_tgt_b, f0: int,
                   s0: int, s1: int, into: Optional[dict] = None) -> None:
    """Run plan steps s0 .. s1 - 1 on `state`, in place.

    lanes_tgt_b (B, F, 32, 128, n_lanes) and bytes_tgt_b (B, F, 2, 32, 256)
    int32 hold the targets of frames f0 .. f0 + F - 1, which must cover
    the frames of these steps.  Step indices stay absolute (the nonces
    fold them), so any split into segments gives the whole-movie encode's
    records.  A segment starts on a body boundary and on a recompute step:
    the carried diff is rebuilt from the carried screens.  `into`: see the
    module docstring."""
    plan, mode = state.plan, state.mode
    dev = state.banks.device
    if lanes_tgt_b.device != dev or bytes_tgt_b.device != dev:
        raise ValueError("targets on %s, distance model on %s"
                         % (lanes_tgt_b.device, dev))
    if s1 <= s0:
        return
    Sc = plan.chunk_steps
    sf, sb, sr = plan.step_frame, plan.step_bank, plan.step_recompute
    if s0 % Sc or s1 % Sc or not sr[s0]:
        raise ValueError(
            "segment steps %d .. %d: a segment starts and ends on a body "
            "boundary (every %d steps) and starts on a recompute step"
            % (s0, s1, Sc))
    F = lanes_tgt_b.shape[1]
    if int(sf[s0]) < f0 or int(sf[s1 - 1]) >= f0 + F:
        raise ValueError("steps %d .. %d encode frames %d .. %d; targets "
                         "hold %d .. %d" % (s0, s1, sf[s0], sf[s1 - 1], f0,
                                            f0 + F - 1))
    lanes_tgt_b = lanes_tgt_b.contiguous()
    bytes_tgt_b = bytes_tgt_b.contiguous()
    table = state.dist.store_cost16.reshape(-1, state.dist.n_contents)
    # every record starts as the padding op (page 32, the active bank's
    # target byte at (0, 0), zero offsets); steps run overwrite theirs
    seg = state.ops[s0:s1]
    pad = bytes_tgt_b[:, state.step_frame[s0:s1] - f0,
                      state.step_bank[s0:s1], 0, 0].T  # (s1 - s0, B)
    seg.zero_()
    seg[..., 0] = 32
    seg[..., 1] = pad.to(torch.uint8)[:, :, None, None]
    bodies = range(s0, s1, Sc)
    with span("encode.launch", into):
        for b0 in bodies:
            frame, bank = int(sf[b0]) - f0, int(sb[b0])
            body.encode_body(state.up, state.dw, state.banks, lanes_tgt_b,
                             bytes_tgt_b, frame, bank, table, state.keys,
                             state.nvalid, b0, Sc, state.ops, mode,
                             state.joint,
                             sub=state.dist.sub if sr[b0] else None)
    if into is not None:
        into["body_launches"] = into.get("body_launches", 0) + len(bodies)


def encode_movies(dist, lanes_tgt_b, bytes_tgt_b, plan: MoviePlan,
                  mode: VideoMode, seeds, joint: bool = False,
                  into: Optional[dict] = None):
    """Encode B planned movies in lockstep on the targets' device: the
    one-segment call of `encode_segment`.

    lanes_tgt_b: (B, F, 32, 128, n_lanes) int32; bytes_tgt_b:
    (B, F, 2, 32, 256) int32; every movie follows `plan`.
    dist: a distance.ComputedDistance on the same device.
    seeds: B ints, or None for deterministic tie-breaks (testing).
    joint: joint content selection (`--joint_content`).
    into: stage timings (module docstring).
    Returns (ops (B, S, K*J, 6) uint8, final main (B, 32, 256) int32, final
    aux (B, 32, 256)) as tensors on the device; for HGR the final aux is
    the main bank.
    """
    dev = lanes_tgt_b.device
    if dist.device != dev or bytes_tgt_b.device != dev:
        raise ValueError("targets on %s, distance model on %s"
                         % (dev, dist.device))
    state = new_state(dist, plan, mode, seeds, lanes_tgt_b.shape[0], joint)
    encode_segment(state, lanes_tgt_b, bytes_tgt_b, 0, 0,
                   len(plan.step_frame), into)
    return state.result()


def encode_movie(dist, lanes_tgt, bytes_tgt, plan: MoviePlan,
                 mode: VideoMode, seed: Optional[int] = 0,
                 joint: bool = False, into: Optional[dict] = None):
    """Encode one planned movie on the targets' device: the B = 1 call of
    `encode_movies`.

    seed=None disables random tie-breaks (deterministic, for testing).
    Returns (ops (S, K*J, 6) uint8, final main (32, 256) int32, final aux)
    as tensors on the device; for HGR the final aux is the main bank.
    """
    ops, main, aux = encode_movies(
        dist, lanes_tgt[None], bytes_tgt[None], plan, mode,
        None if seed is None else [seed], joint, into)
    return ops[0], main[0], aux[0]


def segment_ranges(plan: MoviePlan, chunk_frames: int):
    """(f0, f1, s0, s1) of each segment: frame bounds every `chunk_frames`
    encoded frames, step bounds where the plan's frames change (the JAX
    package's own split)."""
    if chunk_frames <= 0:
        raise ValueError("chunk_frames must be positive, got %r"
                         % (chunk_frames,))
    sf = plan.step_frame
    f_max = int(sf.max())
    bounds = list(range(0, f_max + 1, chunk_frames)) + [f_max + 1]
    return [(f0, f1, int(np.searchsorted(sf, f0)),
             int(np.searchsorted(sf, f1)))
            for f0, f1 in zip(bounds[:-1], bounds[1:])]


def _to_device(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host uint8 array on `dev`; on a card through pinned memory, so
    the copy is queued and the host goes on."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if dev.type != "cuda":
        return t
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(dev, non_blocking=True)


def _encode_segments(dist, pull, plan: MoviePlan, mode: VideoMode,
                     seed: Optional[int], chunk_frames: int, joint: bool,
                     into: Optional[dict]):
    """The segment loop of the chunked and streaming encoders on `dist`'s
    device.  `pull(n)` gives the next n frames' (main, aux | None) host
    uint8 banks.  Returns (ops (S, K*J, 6) uint8 numpy, final main
    (32, 256) int32 numpy, final aux).

    On a card nothing in the loop waits for it: a segment's targets go up
    from pinned memory, its bodies (each with its chunk start) are queued, and its
    records come back on a second stream, behind an event recorded after
    its last body, into pinned memory that is read only after the loop.
    So the host pulls (or quantizes) segment i + 1 while the card encodes
    segment i, and the fetch of segment i - 1 runs beside both."""
    require_mode(mode)
    ranges = segment_ranges(plan, chunk_frames)
    dev = dist.device
    state = new_state(dist, plan, mode, None if seed is None else [seed], 1,
                      joint)
    on_card = dev.type == "cuda"
    if on_card:
        # one pinned buffer for the whole movie's records: a pinned
        # allocation per segment would stall the queue each time
        fetch_stream = torch.cuda.Stream(dev)
        ops_host = torch.empty(state.ops.shape, dtype=torch.uint8,
                               pin_memory=True)
    for f0, f1, s0, s1 in ranges:
        fm, fa = pull(f1 - f0)
        with span("encode.targets", into):
            lanes, bytes_tgt = prepare_targets(
                _to_device(fm, dev),
                None if fa is None else _to_device(fa, dev), mode, dev)
        encode_segment(state, lanes[None], bytes_tgt[None], f0, s0, s1, into)
        if on_card:
            done = torch.cuda.Event()
            done.record()
            with torch.cuda.stream(fetch_stream):
                fetch_stream.wait_event(done)
                ops_host[s0:s1].copy_(state.ops[s0:s1], non_blocking=True)
    with span("encode.wait", into):
        main = state.banks[0, 0].cpu().numpy()
        aux = state.banks[0, -1].cpu().numpy()
        if on_card:
            fetch_stream.synchronize()
    ops = (ops_host if on_card else state.ops).numpy()
    return ops.reshape(-1, plan.k * plan.j, OP_FIELDS), main, aux


def encode_movie_chunked(dist, frames_main, frames_aux, plan: MoviePlan,
                         mode: VideoMode, seed: Optional[int] = 0,
                         chunk_frames: int = 512, joint: bool = False,
                         into: Optional[dict] = None):
    """Encode an arbitrarily long planned movie with bounded target memory
    on `dist`'s device (counterpart of the JAX package's
    `encode_movie_chunked`).

    The plan is split at encoded-frame boundaries into segments of at most
    `chunk_frames` frames; each segment's uint8 target banks go to the
    device when it starts (lanes are derived there) and the encoder state
    is carried across segments.  Output is bit-identical to `encode_movie`
    with the same seed.

    frames_main / frames_aux: (F, 32, 256) uint8 host banks (aux None for
    HGR).  Returns (ops (S, K*J, 6) uint8 numpy, final main, final aux).
    """
    frames_main = np.asarray(frames_main)
    frames_aux = None if frames_aux is None else np.asarray(frames_aux)
    pos = 0

    def pull(n):
        nonlocal pos
        lo, pos = pos, pos + n
        if pos > len(frames_main):
            raise ValueError("plan needs %d encoded frames, targets hold %d"
                             % (pos, len(frames_main)))
        return (frames_main[lo:pos],
                None if frames_aux is None else frames_aux[lo:pos])

    return _encode_segments(dist, pull, plan, mode, seed, chunk_frames, joint,
                            into)


def encode_movie_streaming(dist, batches, plan: MoviePlan, mode: VideoMode,
                           seed: Optional[int] = 0, chunk_frames: int = 64,
                           joint: bool = False, into: Optional[dict] = None):
    """Encode while targets stream in, on `dist`'s device (counterpart of
    the JAX package's `encode_movie_streaming`).

    batches: an iterator of (main (n, 32, 256) uint8, aux | None) target
    batches of any sizes whose concatenation covers the plan's frames.
    The plan is split as in `encode_movie_chunked`; the next segment's
    batches are pulled after this segment's launches are queued, so a
    generator that quantizes on the host (`frames.ingest_stream_array`)
    works while the card encodes.  Output is bit-identical to
    `encode_movie` with the same seed.

    Returns (ops, final main, final aux, targets_main, targets_aux): the
    (S, K*J, 6) records, the final screen banks and the accumulated host
    targets of every batch pulled (targets_aux is None for HGR).
    """
    acc_main, acc_aux = [], []  # all pulled batches (host copies)
    buf_main, buf_aux = [], []  # not-yet-consumed frames
    buffered = 0
    batches = iter(batches)

    def pull_frames(need):
        nonlocal buffered
        while buffered < need:
            try:
                bm, ba = next(batches)
            except StopIteration:
                raise ValueError(
                    "target stream ended %d frames short" % (need - buffered))
            bm = np.asarray(bm, np.uint8)
            acc_main.append(bm)
            buf_main.append(bm)
            if ba is not None:
                ba = np.asarray(ba, np.uint8)
                acc_aux.append(ba)
                buf_aux.append(ba)
            buffered += len(bm)
        out_m = np.concatenate(buf_main) if len(buf_main) > 1 else buf_main[0]
        out_a = None
        if buf_aux:
            out_a = (np.concatenate(buf_aux) if len(buf_aux) > 1
                     else buf_aux[0])
        take_m, rest_m = out_m[:need], out_m[need:]
        buf_main[:] = [rest_m] if len(rest_m) else []
        if out_a is not None:
            buf_aux[:] = [out_a[need:]] if len(out_a) > need else []
            out_a = out_a[:need]
        buffered -= need
        return take_m, out_a

    ops, main, aux = _encode_segments(dist, pull_frames, plan, mode, seed,
                                      chunk_frames, joint, into)
    tgt_main = np.concatenate(acc_main) if len(acc_main) > 1 else acc_main[0]
    tgt_aux = (np.concatenate(acc_aux) if len(acc_aux) > 1 else
               acc_aux[0]) if acc_aux else None
    return ops, main, aux, tgt_main, tgt_aux

"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/plan.py, which this package never imports.

The encoder's host-side opcode schedule (the port's copy of
iivision_tpu/encoder.py `MoviePlan`, `plan_movie`, `flatten_ops` and
`ops_to_ticks`; pure numpy).

Scheduling semantics follow the reference encode loop: one opcode per
audio tick; frame f is pulled at the first tick >= ticks_per_frame * f;
every n-th pulled frame becomes the new target; diff weights and update
priorities are recomputed at every encoded-frame start and (DHGR) at every
2 KB bank flip.
"""

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from benchmark.reference import opcodes as ops_mod
from benchmark.reference.video_mode import VideoMode, require_mode

OP_FIELDS = 6  # per-op record: [page, content, o0, o1, o2, o3]
BODY_CAP = 8  # max plan steps per chunk body: bodies tile chunks


@dataclass
class MoviePlan:
    """Static per-step schedule driving the encoder (all numpy).

    Steps are laid out chunk-major: every (frame, bank) chunk spans a
    multiple of `chunk_steps` consecutive steps (tail steps padded with
    nvalid=0), and step_recompute is True exactly on each chunk's first
    step."""
    n_ops: int
    k: int  # pages per step
    j: int  # ops per page per step (ops/step = k*j)
    chunk_steps: int  # steps per body
    step_frame: np.ndarray  # (S,) int32: index into the stacked targets
    step_bank: np.ndarray  # (S,) int32: 0=main, 1=aux
    step_recompute: np.ndarray  # (S,) bool: recompute diff+priority
    step_nvalid: np.ndarray  # (S,) int32: number of real ops in this step
    op_tick_index: np.ndarray  # (n_ops,) int32: audio tick of each opcode


def plan_movie(n_frames: int, n_audio_ticks: int, input_frame_rate: float,
               ticks_per_second: float, every_n_video_frames: int,
               mode: VideoMode, k: int = 8,
               j: int = 1) -> Tuple[MoviePlan, int]:
    """Plan the opcode schedule for a movie: for every opcode, the encoded
    frame it targets and the bank it stores to, chunked into steps of k*j
    opcodes with a recompute flag on each chunk's first step.  Returns
    (plan, number of encoded frames).  Memoized; the returned arrays are
    read-only."""
    return _plan_movie_cached(n_frames, n_audio_ticks,
                              float(input_frame_rate),
                              float(ticks_per_second),
                              every_n_video_frames, require_mode(mode), k, j)


@functools.lru_cache(maxsize=256)
def _plan_movie_cached(n_frames, n_audio_ticks, input_frame_rate,
                       ticks_per_second, every_n_video_frames, mode, k, j):
    tpf = ticks_per_second / input_frame_rate
    # the movie ends when the (n_frames+1)-th frame pull raises
    # StopIteration: pull f happens at the first tick >= tpf*(f-1), so the
    # terminating pull is at ceil(tpf*n_frames) and that tick emits no op
    end_tick = int(np.ceil(tpf * n_frames))
    n_ops = int(min(n_audio_ticks, end_tick - 1))
    if n_ops <= 0:
        raise ValueError("Empty movie: no opcodes to emit")

    ticks = np.arange(1, n_ops + 1)
    pulled = np.minimum(np.floor(ticks / tpf).astype(np.int64) + 1, n_frames)
    encoded = (pulled - 1) // every_n_video_frames
    n_encoded = int(encoded.max()) + 1

    op_idx = np.arange(n_ops)
    seg = np.where(op_idx < ops_mod.OPS_FIRST_FRAME, 0,
                   1 + (op_idx - ops_mod.OPS_FIRST_FRAME)
                   // ops_mod.OPS_PER_FRAME)
    bank = (seg % 2).astype(np.int32) if mode == VideoMode.DHGR else \
        np.zeros(n_ops, dtype=np.int32)

    change = np.zeros(n_ops, dtype=bool)
    change[0] = True
    change[1:] = (np.diff(encoded) != 0) | (np.diff(bank) != 0)
    chunk_starts = np.flatnonzero(change)
    chunk_ends = np.append(chunk_starts[1:], n_ops)

    # chunk-major padded layout: each (frame, bank) chunk takes a whole
    # number of bodies, tail steps padded with nvalid=0 no-ops
    ops_per_step = k * j
    lengths = chunk_ends - chunk_starts
    n_steps_per_chunk = -(-lengths // ops_per_step)
    body_steps = min(int(n_steps_per_chunk.max()), BODY_CAP)
    sf, sb, sr, sn = [], [], [], []
    for cs, ce in zip(chunk_starts, chunk_ends):
        length = ce - cs
        n_chunk = -(-length // ops_per_step)
        n_steps = -(-n_chunk // body_steps) * body_steps
        for st in range(n_steps):
            sf.append(encoded[cs])
            sb.append(bank[cs])
            sr.append(st == 0)
            sn.append(int(np.clip(length - st * ops_per_step,
                                  0, ops_per_step)))

    plan = MoviePlan(
        n_ops=n_ops,
        k=k,
        j=j,
        chunk_steps=body_steps,
        step_frame=np.asarray(sf, dtype=np.int32),
        step_bank=np.asarray(sb, dtype=np.int32),
        step_recompute=np.asarray(sr, dtype=bool),
        step_nvalid=np.asarray(sn, dtype=np.int32),
        op_tick_index=op_idx.astype(np.int32),
    )
    for a in (plan.step_frame, plan.step_bank, plan.step_recompute,
              plan.step_nvalid, plan.op_tick_index):
        a.setflags(write=False)  # memoized: shared across callers
    return plan, n_encoded


def flatten_ops(ops: np.ndarray, plan: MoviePlan) -> np.ndarray:
    """(S, K*J, 6) step-major ops -> (n_ops, 6) stream-ordered, valid
    only."""
    S_real = len(plan.step_nvalid)
    ops = np.asarray(ops)[:S_real]
    k = ops.shape[1]
    valid = np.arange(k)[None, :] < plan.step_nvalid[:, None]
    flat = ops.reshape(S_real * k, OP_FIELDS)
    return flat[valid.reshape(-1)]

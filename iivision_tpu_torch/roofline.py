"""The encode's cost model on a card's peaks: bytes, operations and the
least time the card could take (counterpart of iivision_tpu/roofline.py).

The model counts the algorithm's work, not the form of the code that does
it: the plan's chunk starts (the diff of the active bank against the
frame's target, a diagonal edit-distance DP per page offset, or the yiq
model's window sums) and its bodies (per step the k busiest pages and j
sequential sub-ops on each), exactly as `encoder.encode_segment` runs
them.  So the same count reads the body kernel on a card (a chunk start
is the prologue of the body launch that follows it), the plain torch
forms, or any later kernel that does the same work.  The
JAX package's model counted XLA's one-hot matmuls; the port has none, and
nothing in the encode runs on the tensor cores, so there is no MFU here.

- `chunk_start_cost` / `body_cost`: (bytes, float32 operations, int32
  operations) of one chunk start / one body for B movies; a body that
  recomputes costs the sum of the two.  Bytes count each input read once
  and each output written once.
- `encode_cost`: their sum over a plan, with the counts of chunk starts
  (recomputing bodies), bodies, steps and sequential sub-ops.
- `device_peaks`: a card's HBM bytes/s, float32 operations/s outside the
  tensor cores and int32 operations/s, by the card's name.  A card not in
  `CARD_PEAKS` raises: a wrong peak would give a wrong share.
- `report`: one measured encode against the model.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from iivision_tpu_torch.ops import yiq
from iivision_tpu_torch.ops.chunk_start import n_banks
from iivision_tpu_torch.ops.distance import n_contents
from iivision_tpu_torch.screen import spec_for_mode
from iivision_tpu_torch.video_mode import VideoMode

PAGE = 32 * 256  # bytes of one screen bank: 32 pages of 256 offsets
OFFSETS = 240  # offsets of a page that map to screen bytes (16 are holes)
# int32 instructions of one threefry2x32 block as csrc/body.cu writes it:
# the key parity (2 xors), the first key injection (2 adds), 20 mix rounds
# of an add, a rotation (one funnel shift) and a xor (60), and five key
# injections of 3 adds (15)
THREEFRY_INT32_OPS = 79
UNIFORM_INT32_OPS = 3  # a uniform's bits to float: xor, shift, or


class Peaks(NamedTuple):
    hbm_bytes_per_s: float
    fp32_ops_per_s: float  # outside the tensor cores
    int32_ops_per_s: float


# torch.cuda.get_device_name -> peaks.  NVIDIA H100 SXM5 80GB: HBM3 at
# 3.35 TB/s and 67 TFLOP/s float32 (NVIDIA H100 Tensor Core GPU data
# sheet); int32: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost clock
# (NVIDIA H100 Tensor Core GPU Architecture whitepaper).  The rates assume
# the card's full 700 W power limit.
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12, 64 * 132 * 1.98e9),
}


def device_peaks(device) -> Peaks:
    """Peaks of a card: a CUDA device (torch.device, index or 'cuda:N'),
    or a card's name as torch.cuda.get_device_name gives it."""
    name = device
    if not isinstance(device, str) or device.split(":")[0] in ("cuda",
                                                                 "cpu"):
        dev = torch.device("cuda", device) if isinstance(device, int) \
            else torch.device(device)
        if dev.type != "cuda":
            raise ValueError("no peaks for device %s: the roofline is a "
                             "card's" % dev)
        name = torch.cuda.get_device_name(dev)
    if name not in CARD_PEAKS:
        raise ValueError("no peaks for the card %r (known: %s)"
                         % (name, ", ".join(CARD_PEAKS)))
    return CARD_PEAKS[name]


def least_time(nbytes: float, fp32_ops: float, int32_ops: float,
               peaks: Peaks):
    """(seconds, 'bytes' or 'operations'): the larger of the bytes over the
    HBM rate and the operations over the card's rate for their type."""
    t_bytes = nbytes / peaks.hbm_bytes_per_s
    t_ops = (fp32_ops / peaks.fp32_ops_per_s
             + int32_ops / peaks.int32_ops_per_s)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def chunk_start_cost(mode: VideoMode, batch: int, model: str = "window"):
    """(bytes, float32 ops, int32 ops) that a chunk start adds to the body
    launch whose prologue runs it, for `batch` movies.  Bytes: the other
    bank's row (DHGR; the active bank's row, up and the bank's two target
    lanes are the body's own reads, and the new up and dw stay on the chip
    until the body writes them) and the cost basis (for yiq the window
    costs the offsets index: at most one int32 per offset and window); the
    body then reads no dw (`body_cost(recompute=True)`).  int32 operations
    at the offsets that are not holes: one add per yiq window, or an add,
    two compares and a min per DP step."""
    nbytes = batch * (n_banks(mode) - 1) * PAGE * 4
    if model == "yiq":
        windows = yiq.n_pixels(mode)
        nbytes += min(spec_for_mode(mode).N_LANES * windows * 128 * 128,
                      batch * PAGE * windows) * 4
        per_offset = windows
    else:
        nbytes += 16 * 16 * 4
        per_offset = 4 * spec_for_mode(mode).MASKED_DOTS
    return float(nbytes), 0.0, float(batch * 32 * OFFSETS * per_offset)


def nonce_int32_ops(k: int, j: int) -> int:
    """int32 operations of one seeded step's nonce draws: threefry blocks
    for fold_in(key, step) and fold_in(step key, 0), the 32 page uniforms,
    and per slot and sub-op its fold_in and 256 offset uniforms (257 k j
    blocks); each uniform's bits also take UNIFORM_INT32_OPS."""
    blocks = 2 + 32 + 257 * k * j
    return blocks * THREEFRY_INT32_OPS + (32 + 256 * k * j) * UNIFORM_INT32_OPS


def body_cost(mode: VideoMode, k: int, j: int, batch: int, steps: int,
              run: int, joint: bool = False, seeded: bool = False,
              recompute: bool = False):
    """(bytes, float32 ops, int32 ops) of one body of `steps` plan steps,
    `run` of them not padding, for `batch` movies.  Bytes per movie: up, dw
    and the bank bytes read and written, the target bytes and the bank's
    two target lanes, one int16 table read per offset per sub-op run, the
    body's records.  Joint content adds the bank's table rows (each read
    once) and, per offset and content of every sub-op run, a float32
    subtract and compare.  seeded: the nonce draws of every step run
    (`nonce_int32_ops`) count as int32 operations.  recompute: the launch
    runs a chunk start first (whose own work is `chunk_start_cost`), so dw
    is not read."""
    C = n_contents(mode)
    nbytes = batch * ((5 if recompute else 6) * PAGE * 4 + 2 * PAGE * 4
                      + run * k * j * 256 * 2 + steps * k * j * 6)
    fp32 = 0.0
    if joint:
        nbytes += batch * PAGE * C * 2
        fp32 = 2.0 * batch * run * k * j * 256 * C
    int32 = float(batch * run * nonce_int32_ops(k, j)) if seeded else 0.0
    return float(nbytes), fp32, int32


@dataclass
class EncodeCost:
    """The modelled work of one encode of a plan for `batch` movies."""
    bytes: float
    fp32_ops: float
    int32_ops: float
    chunk_starts: int  # recomputing bodies, over every shard
    bodies: int  # launches, over every shard
    steps: int
    seq_subops: int  # dependent sub-ops in one shard's launch sequence


def encode_cost(plan, mode: VideoMode, batch: int = 1,
                model: str = "window", joint: bool = False,
                shards: int = 1, seeded: bool = False) -> EncodeCost:
    """The cost of encoding `plan` for `batch` movies split into `shards`
    lockstep launch sequences (a mesh's shards; each launches once per
    body for its movies).  A chunk start runs in every body whose first
    step recomputes (`chunk_starts` counts those bodies, not launches of
    their own); a body runs its steps' j sub-ops wherever a step is not
    padding.  seeded: count the bodies' nonce draws (`body_cost`)."""
    Sc = int(plan.chunk_steps)
    nv = np.asarray(plan.step_nvalid)
    runs = (nv.reshape(-1, Sc) > 0).sum(axis=1)
    recompute = np.asarray(plan.step_recompute)[::Sc].astype(bool)
    n_cs = int(recompute.sum())
    total = np.asarray(chunk_start_cost(mode, batch, model)) * n_cs
    kinds, counts = np.unique(np.stack([runs, recompute]), axis=1,
                              return_counts=True)
    for (run, rec), count in zip(kinds.T, counts):
        total = total + count * np.asarray(body_cost(
            mode, plan.k, plan.j, batch, Sc, int(run), joint, seeded,
            bool(rec)))
    return EncodeCost(
        bytes=float(total[0]), fp32_ops=float(total[1]),
        int32_ops=float(total[2]), chunk_starts=n_cs * shards,
        bodies=len(runs) * shards, steps=len(nv),
        seq_subops=int((nv > 0).sum()) * plan.j)


def report(plan, mode: VideoMode, batch: int, seconds: float, device,
           model: str = "window", joint: bool = False,
           shards: int = 1, seeded: bool = False) -> dict:
    """One measured encode of `seconds` against the model on `device`'s
    peaks (see `device_peaks`); seeded: the encode drew nonces.  Returns a
    dict with the counts, the least time, the share of that bound the
    encode reached, the HBM share of peak and `bound`: 'bytes' or
    'operations' where that share passes a half, else 'latency(n seq
    sub-ops @ x us)'; and a one-line summary under "line"."""
    peaks = device_peaks(device)
    cost = encode_cost(plan, mode, batch, model, joint, shards, seeded)
    least_s, by = least_time(cost.bytes, cost.fp32_ops, cost.int32_ops,
                             peaks)
    share = least_s / seconds
    us_per_subop = seconds / max(cost.seq_subops, 1) * 1e6
    bound = by if share > 0.5 else "latency(%d seq sub-ops @ %.2fus)" % (
        cost.seq_subops, us_per_subop)
    rec = dict(
        bytes=cost.bytes, fp32_ops=cost.fp32_ops, int32_ops=cost.int32_ops,
        chunk_starts=cost.chunk_starts, bodies=cost.bodies,
        steps=cost.steps, seq_subops=cost.seq_subops, seconds=seconds,
        least_ms=least_s * 1e3, bound_share_pct=100 * share,
        hbm_pct_of_peak=100 * cost.bytes / seconds / peaks.hbm_bytes_per_s,
        bound=bound, peaks=peaks._asdict())
    rec["line"] = (
        "roofline[B=%d %s %s k=%d j=%d%s%s]: %.4fs; %.4g bytes, %.4g fp32 + "
        "%.4g int32 ops -> least %.4f ms (%.3f%% of the bound), HBM %.3f%% "
        "of peak; %d chunk starts / %d bodies / %d steps / %d seq sub-ops "
        "-> %s-bound" % (
            batch, mode.name, model, plan.k, plan.j,
            " joint" if joint else "",
            " shards=%d" % shards if shards > 1 else "", seconds, cost.bytes,
            cost.fp32_ops, cost.int32_ops, rec["least_ms"], 100 * share,
            rec["hbm_pct_of_peak"], cost.chunk_starts, cost.bodies,
            cost.steps, cost.seq_subops, bound))
    return rec

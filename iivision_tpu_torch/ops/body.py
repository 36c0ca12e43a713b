"""One chunk body of the encoder for B movies (counterpart of the JAX
encoder's `chunk_body`, iivision_tpu/encoder.py:482: the recompute
`do_recompute` under lax.cond, :540-553, then the step scan, `step_body`
and `sub_op`, :567-759): the chunk start's recompute if asked for, then
steps s0 .. s0+Sc-1 of the plan on the active bank of one frame, with the
default content rule or the joint one (`--joint_content`).

- `encode_body_plain`: `chunk_start.chunk_start_plain` when given a cost
  basis `sub`, then the per-step torch loop - page maxima (`amax`), the
  nonce add, a stable sort for the top k, `index_select` of the pages'
  rows, the plain sub-op chain (`subop.sub_op_chain_plain`, default or
  joint), `index_copy_` back, with the nonces of the body drawn by
  `ops/random.step_nonces`;
- `encode_body`: one launch of csrc/body.cu on a CUDA tensor (the
  recompute, for `sub`, in the kernel's prologue; nonces drawn inside the
  kernel; `joint` picks the kernel's joint instantiation), a thread-block
  cluster of `cluster` CTAs per movie (1, 2, 4, 8 or 16; None:
  `cluster_size` on the card's `max_active_clusters`), `encode_body_plain`
  on a CPU tensor.  Each rule counts its launches, `encode_body.launches`
  and `encode_body.joint_launches`, and a launch that recomputes also
  counts in `encode_body.recompute_launches` ((16, 16) bases) or
  `encode_body.yiq_recompute_launches` (the yiq costs);
- `cluster_size`: the chooser, a plain function of B, k, j, the rule and
  the card's maximum active clusters per size;
- `threefry_uniform`: the kernel's threefry for tests, writing
  `step_nonces`' layout (`threefry_uniform.launches` counts it);
- `nonce_plain`: one nonce from Python integers, the per-element form of
  the kernel's indexing (counter r * 256 + t under fold_in(fold_in(key,
  step), stream)).

State (int32, updated in place at `bank`): up, dw, banks (B, n_banks, 32,
256).  Targets: lanes_tgt_b (B, F, 32, 128, n_lanes), bytes_tgt_b (B, F, 2,
32, 256) int32 (bytes 0..255), read at `frame`.  table: (n_lanes * R, C)
int16 store costs.  keys: (B, 2) int32 words of `jax.random` keys
(`random.key_words`), or None for the deterministic encoder.  nvalid: the
plan's (S,) int32 `step_nvalid` on the device.  ops: (S, B, j, k, 6) uint8
records, padding ops already written; steps with nvalid 0 keep them.  sub:
None (no recompute), the (16, 16) int32 cost basis of the window and mono
models, or the yiq model's (n_lanes, L, 128, 128) int32 window costs
(`ComputedDistance.sub`).
"""

import ctypes
import functools
import struct

import torch

from iivision_tpu_torch import _build, screen
from iivision_tpu_torch.ops import random as trandom
from iivision_tpu_torch.ops import subop, yiq
from iivision_tpu_torch.ops.chunk_start import (bank_lanes,
                                                chunk_start_plain, n_banks)
from iivision_tpu_torch.video_mode import VideoMode


def sc_row_index(tgt_lanes, bank: int, n_values: int,
                 mode: VideoMode) -> torch.Tensor:
    """(..., 32, 256) int32: the store-cost table row each page offset
    reads - lane * R + target lane value, even offsets on the bank's first
    lane, odd offsets on its second."""
    le, lo = bank_lanes(mode, bank)
    return screen.interleave_bank_lanes(
        le * n_values + tgt_lanes[..., le],
        lo * n_values + tgt_lanes[..., lo]).to(torch.int32).contiguous()


def _key_pair(keys: torch.Tensor) -> tuple:
    """(B, 2) int32 key words -> ops/random's (k1, k2) int64 pair."""
    k = keys.to(torch.int64) & trandom.MASK32
    return k[:, 0], k[:, 1]


def encode_body_plain(up, dw, banks, lanes_tgt_b, bytes_tgt_b, frame: int,
                      bank: int, table, keys, nvalid, s0: int, Sc: int, ops,
                      mode: VideoMode, joint: bool = False, *,
                      sub=None) -> None:
    """The body as the per-step torch loop (see the module docstring),
    after `chunk_start_plain` under `sub` unless sub is None; joint: joint
    content selection."""
    if sub is not None:
        chunk_start_plain(banks, lanes_tgt_b, frame, bank, sub, up, dw, mode)
    dev = up.device
    B = up.shape[0]
    j, k = ops.shape[2], ops.shape[3]
    n_values = table.shape[0] // screen.spec_for_mode(mode).N_LANES
    tl = lanes_tgt_b[:, frame]
    pad = bytes_tgt_b[:, frame, bank, 0, 0].contiguous()  # (B,) int32
    nv = nvalid[s0:s0 + Sc].tolist()
    nonce_p = nonce_o = None
    if keys is not None:
        steps = torch.arange(s0, s0 + Sc, dtype=torch.int64, device=dev)
        nonce_p, nonce_o = trandom.step_nonces(_key_pair(keys), steps, k, j)
        # step-major, so each step's (B, j, k, 256) is contiguous
        nonce_o = nonce_o.transpose(0, 1).contiguous()
    # body state, float32: [up, dw, by, tb] rows of the active bank,
    # flattened to (B * 32, 4, 256)
    st = torch.stack([up[:, bank], dw[:, bank], banks[:, bank],
                      bytes_tgt_b[:, frame, bank]],
                     dim=2).to(torch.float32).reshape(B * 32, 4, 256)
    sc_rows = sc_row_index(tl, bank, n_values, mode).reshape(B * 32, 256)
    # page p of movie b is row b * 32 + p of the flattened state
    movie_base = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * 32
    for i, s in enumerate(range(s0, s0 + Sc)):
        if nv[i] == 0:
            continue  # a padded step: no state change, padding records
        score = st[:, 0].amax(dim=1).reshape(B, 32) * 256.0
        if keys is not None:
            score = score + nonce_p[:, i] * 255.0
        pages = torch.sort(score, dim=1, descending=True,
                           stable=True).indices[:, :k].contiguous()
        flat = (pages + movie_base).reshape(-1)
        rows = st.index_select(0, flat).reshape(B, k, 4, 256)
        subop.sub_op_chain_plain(
            rows, sc_rows.index_select(0, flat).reshape(B, k, 256), table,
            None if keys is None else nonce_o[i], pages, nv[i], pad, ops[s],
            joint)
        st.index_copy_(0, flat, rows.reshape(B * k, 4, 256))
    # truncate back to int32 at the body's end
    st = st.reshape(B, 32, 4, 256)
    up[:, bank] = st[:, :, 0].to(torch.int32)
    dw[:, bank] = st[:, :, 1].to(torch.int32)
    banks[:, bank] = st[:, :, 2].to(torch.int32)


CLUSTER_SIZES = (1, 2, 4, 8, 16)  # CTAs per movie the kernel takes


def cluster_size(B: int, k: int, j: int, joint: bool, max_clusters) -> int:
    """CTAs per movie for a body of B movies at (k, j): the largest cluster
    size whose maximum active cluster count (`max_clusters`, {size:
    count}, as `max_active_clusters` reads them) holds all B movies in one
    wave; 1 where none does.  The rule is the measured sweep's
    (`chip_smoke.body_cluster_sweep` on an H100, in PERF.md): at B = 1 every
    setting, (1, 1) and the joint rule included, ran fastest at 16, and
    at B = 32 16 and 8 tied ahead of 4, 2 and 1, so no setting takes a
    smaller size than the largest that fits, and the rule reads neither
    (k, j) nor `joint`."""
    fits = [c for c in CLUSTER_SIZES if max_clusters[c] >= B]
    return max(fits) if fits else 1


@functools.lru_cache(None)
def _max_active_clusters(index: int, joint: bool) -> tuple:
    counts = (ctypes.c_int * len(CLUSTER_SIZES))()
    with torch.cuda.device(index):
        _build.launch("iiv_body_max_clusters", int(joint), counts)
    return tuple(counts)


def max_active_clusters(device, joint: bool = False) -> dict:
    """{cluster size: cudaOccupancyMaxActiveClusters} of the body kernel's
    rule on a card (read once per card and rule)."""
    return dict(zip(CLUSTER_SIZES, _max_active_clusters(
        torch.device(device).index or 0, bool(joint))))


@functools.lru_cache(None)
def _chosen_size(index: int, B: int, k: int, j: int, joint: bool) -> int:
    """`cluster_size` on card `index`, once per shape: the launch loop
    asks for every body."""
    return cluster_size(B, k, j, joint, max_active_clusters(index, joint))


def _check_sub(sub, device, mode: VideoMode) -> bool:
    """Raise ValueError unless `sub` is a cost basis the recompute takes on
    `device`: contiguous int32 (16, 16), or the yiq model's (n_lanes, L,
    128, 128).  Returns whether it is the yiq costs."""
    yiq_model = sub.dim() == 4
    shape = ((screen.spec_for_mode(mode).N_LANES, yiq.n_pixels(mode), 128,
              128) if yiq_model else (16, 16))
    if sub.device != device or sub.dtype != torch.int32 \
            or not sub.is_contiguous() or tuple(sub.shape) != shape:
        raise ValueError(
            "the recompute's cost basis: want int32 %s contiguous on %s, got "
            "%s %s on %s" % (shape, device, sub.dtype, tuple(sub.shape),
                             sub.device))
    return yiq_model


def encode_body(up, dw, banks, lanes_tgt_b, bytes_tgt_b, frame: int,
                bank: int, table, keys, nvalid, s0: int, Sc: int, ops,
                mode: VideoMode, joint: bool = False, *, sub=None,
                cluster=None, smids=None) -> None:
    """The body: one launch of the body kernel on a CUDA tensor (its joint
    instantiation if `joint`), `encode_body_plain` on a CPU tensor.
    sub: None, or the cost basis of the chunk start that the launch runs
    first (the kernel's prologue; see the module docstring); a basis of
    the wrong shape, dtype or device raises ValueError before a launch, on
    any device.  cluster: CTAs per movie (one of CLUSTER_SIZES), or None
    for `cluster_size`'s choice; any other value raises ValueError before
    a launch, on any device.  smids: None, or an int32 (B * cluster,)
    tensor on the card that receives the SM each CTA ran on."""
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError("the body kernel runs clusters of %s CTAs; got %r"
                         % (CLUSTER_SIZES, cluster))
    yiq_model = sub is not None and _check_sub(sub, up.device, mode)
    if up.device.type == "cpu":
        encode_body_plain(up, dw, banks, lanes_tgt_b, bytes_tgt_b, frame,
                          bank, table, keys, nvalid, s0, Sc, ops, mode, joint,
                          sub=sub)
        return
    if up.device.type != "cuda":
        raise ValueError("no kernel for device %s" % up.device)
    B, F = lanes_tgt_b.shape[:2]
    nb = n_banks(mode)
    n_lanes = screen.spec_for_mode(mode).N_LANES
    S, _, j, k = ops.shape[:4]
    C = table.shape[1]
    if cluster is None:
        cluster = _chosen_size(up.device.index or 0, B, k, j, bool(joint))
    want = [(up, torch.int32, (B, nb, 32, 256)),
            (dw, torch.int32, (B, nb, 32, 256)),
            (banks, torch.int32, (B, nb, 32, 256)),
            (lanes_tgt_b, torch.int32, (B, F, 32, 128, n_lanes)),
            (bytes_tgt_b, torch.int32, (B, F, 2, 32, 256)),
            (table, torch.int16, None),
            (nvalid, torch.int32, (S,)),
            (ops, torch.uint8, (S, B, j, k, 6))]
    if keys is not None:
        want.append((keys, torch.int32, (B, 2)))
    if smids is not None:
        want.append((smids, torch.int32, (B * cluster,)))
    for t, dtype, shape in want:
        if t.device != up.device or t.dtype != dtype \
                or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(
                "body kernel argument: want %s %s contiguous on %s, got %s "
                "%s on %s" % (dtype, shape, up.device, t.dtype,
                              tuple(t.shape), t.device))
    if joint and (C not in (128, 256) or table.data_ptr() % 8):
        raise ValueError("the joint body kernel takes C = 128 or 256 "
                         "contents and an 8-byte aligned table; got C = %d "
                         "at %#x" % (C, table.data_ptr()))
    le, lo = bank_lanes(mode, bank)
    _build.launch(
        "iiv_encode_body", ctypes.c_void_p(up.data_ptr()),
        ctypes.c_void_p(dw.data_ptr()), ctypes.c_void_p(banks.data_ptr()),
        nb, int(bank), ctypes.c_void_p(lanes_tgt_b.data_ptr()),
        ctypes.c_void_p(bytes_tgt_b.data_ptr()), F, int(frame), n_lanes,
        le, lo, table.shape[0] // n_lanes, ctypes.c_void_p(table.data_ptr()),
        C, ctypes.c_void_p(None if keys is None else keys.data_ptr()),
        ctypes.c_void_p(nvalid.data_ptr()), S, int(s0), int(Sc), B, k, j,
        ctypes.c_void_p(ops.data_ptr()), int(joint), int(cluster),
        ctypes.c_void_p(None if smids is None else smids.data_ptr()),
        ctypes.c_void_p(None if sub is None else sub.data_ptr()),
        0 if sub is None else 2 if yiq_model else 1,
        ctypes.c_void_p(_build.stream_ptr(up.device)))
    _build.count(encode_body, "joint_launches" if joint else "launches")
    if sub is not None:
        _build.count(encode_body, "yiq_recompute_launches" if yiq_model
                     else "recompute_launches")


_build.counter(encode_body, "launches", "joint_launches",
               "recompute_launches", "yiq_recompute_launches")


def threefry_uniform(keys: torch.Tensor, steps: torch.Tensor, k: int,
                     j: int):
    """The body kernel's nonces for (B, 2) int32 key words and (S,) int32
    steps, on a card: (nonce_p (B, S, 32), nonce_o (B, S, j, k, 256))
    float32, the layout of ops/random.step_nonces."""
    if keys.device.type != "cuda":
        raise ValueError("threefry_uniform runs the card's kernel; got "
                         "tensors on %s" % keys.device)
    for t, dtype, ndim in ((keys, torch.int32, 2), (steps, torch.int32, 1)):
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() \
                or t.device != keys.device:
            raise ValueError("threefry_uniform takes contiguous int32 keys "
                             "(B, 2) and steps (S,) on one card")
    B, S = keys.shape[0], steps.shape[0]
    nonce_p = torch.empty((B, S, 32), dtype=torch.float32, device=keys.device)
    nonce_o = torch.empty((B, S, j, k, 256), dtype=torch.float32,
                          device=keys.device)
    _build.launch(
        "iiv_threefry_uniform", ctypes.c_void_p(keys.data_ptr()), B,
        ctypes.c_void_p(steps.data_ptr()), S, k, j,
        ctypes.c_void_p(nonce_p.data_ptr()),
        ctypes.c_void_p(nonce_o.data_ptr()),
        ctypes.c_void_p(_build.stream_ptr(keys.device)))
    _build.count(threefry_uniform, "launches")
    return nonce_p, nonce_o


_build.counter(threefry_uniform)


def nonce_plain(key: tuple, step: int, stream: int, counter: int) -> float:
    """One encoder nonce from Python integers, as the body kernel indexes
    it: key = (k1, k2) words; stream 0 gives page nonces (counter = page),
    stream 1 + jj sub-op jj's offset nonces (counter = slot * 256 +
    offset)."""
    skey = trandom.threefry2x32(key[0], key[1], 0, step)
    sub = trandom.threefry2x32(skey[0], skey[1], 0, stream)
    y0, y1 = trandom.threefry2x32(sub[0], sub[1], 0, counter)
    f = struct.unpack("<f", struct.pack("<I", ((y0 ^ y1) >> 9)
                                        | 0x3F800000))[0]
    return float(f - 1.0)

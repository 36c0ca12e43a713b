"""Batch transcoding, on one card or sharded over several (counterpart of
iivision_tpu/parallel/mesh.py).

The JAX package batches the whole-movie scan with `vmap` and shards the
batch over a device mesh.  Here a batch is an axis written out: B movies
run in lockstep through one plan (`encoder.encode_movies`), so each plan
step is one launch sequence for all of them.  Ingest is fused on the
device the same way: resize, quantize, pack and lane derivation, in chunks
of at most INGEST_CHUNK frames of one movie.

A mesh is a tuple of `torch.device`s (`make_mesh`).  Movies are
independent, so a batch shards over the mesh with no communication: axis
0 splits into `len(mesh)` contiguous blocks in order (`shard_batch`), and
each block is ingested, encoded and fetched on its device, in a host
thread of its own and, on a card, under a CUDA stream of its own (the
kernels launch on the thread's current stream).  The distance model is
copied once per device (`replicate`).  A mesh may name one device more
than once: that is the port's counterpart of XLA's virtual host devices,
and puts two shards on one card.  The edit-distance LUT build shards too:
its row blocks are independent (`build_tables_sharded`).

With `mesh` None or a one-entry mesh every function runs unsharded and
returns tensors; on a larger mesh the batch functions return a tuple of
shards, one per entry, which the fetch functions take as they take a
tensor.  The JAX package's tunnel-transfer pool (`io_pool`) is not
ported: `fetch_ops_parallel` copies each shard to the host on a thread of
its own, which is what a mesh of cards needs.

Spans (`trace.span`): `ingest` around a batch's ingest, with
`ingest.resize`, `ingest.quantize`, `ingest.pack` and `ingest.targets` per
chunk and `ingest.cat` for the batch's concatenation; `encode` around a
batch's encode (the encoder's `encode.launch` inside).  A shard's spans
open on its own thread; there is no span per shard.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from iivision_tpu_torch import encoder
from iivision_tpu_torch import frames as frames_mod
from iivision_tpu_torch.ops import dither, editdist, resize
from iivision_tpu_torch.palettes import Palette, require_palette
from iivision_tpu_torch.screen import spec_for_mode
from iivision_tpu_torch.trace import span
from iivision_tpu_torch.video_mode import VideoMode, require_mode

INGEST_CHUNK = 256  # frames per fused ingest step (bounds the score buffers)


def make_mesh(n_devices=None, device: str = "cuda") -> tuple:
    """The first `n_devices` cards (every card when None), as a tuple of
    `torch.device`s; like the JAX package's `devices[:n]` it takes no more
    cards than the host has.  device="cpu" gives `n_devices` (default 1)
    CPU entries, the stand-in for XLA's virtual host devices."""
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    if kind != "cuda":
        raise ValueError("no mesh of %s devices" % kind)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise ValueError("a mesh of cards on a host with no CUDA card")
    return tuple(torch.device("cuda", i)
                 for i in range(min(n_devices or have, have)))


def as_mesh(mesh):
    """None, or `mesh` (a sequence of devices, or one device) as a tuple of
    `torch.device`s.  A card the host lacks, or a device that is neither
    the CPU nor a card, raises."""
    if mesh is None:
        return None
    if isinstance(mesh, (torch.device, str)):
        mesh = (mesh,)
    elif isinstance(mesh, int):
        raise TypeError("a mesh is a sequence of devices (make_mesh(%d) "
                        "makes one), got an int" % mesh)
    out = tuple(torch.device(d) for d in mesh)
    if not out:
        raise ValueError("an empty mesh")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= have:
            raise ValueError("the mesh names %s; this host has %d CUDA "
                             "card(s)" % (d, have))
        if d.type not in ("cpu", "cuda"):
            raise ValueError("no encoder for device %s" % d)
    return out


def shard_batch(x: torch.Tensor, mesh) -> tuple:
    """Axis 0 of `x` in `len(mesh)` contiguous blocks, in order, block i on
    mesh entry i.  The mesh must divide the batch (the rule of JAX's
    NamedSharding)."""
    mesh = as_mesh(mesh)
    if x.shape[0] % len(mesh):
        raise ValueError("a batch of %d does not split over a mesh of %d"
                         % (x.shape[0], len(mesh)))
    n = x.shape[0] // len(mesh)
    return tuple(x[i * n:(i + 1) * n].to(d) for i, d in enumerate(mesh))


def replicate(x, mesh) -> tuple:
    """One copy of `x` per mesh entry: a tensor, or an object with a
    `to(device)` method such as the distance model.  Entries that name the
    device `x` is on share `x` itself."""
    return tuple(x.to(d) for d in as_mesh(mesh))


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return []


def _map_shards(mesh: tuple, fn, args: list) -> list:
    """fn(*args[i]) for each mesh entry i, each in a host thread of its
    own and, on a card, under a CUDA stream of its own that first waits
    for the calling thread's stream.  Returns the results in mesh order;
    the calling thread's streams then wait for every shard's stream and
    every tensor a shard returns is marked as used there, so the caller
    reads them as it reads its own.  A shard that raises makes the call
    raise, once every shard has ended."""
    callers = {d: torch.cuda.current_stream(d) for d in mesh
               if d.type == "cuda"}

    def one(i):
        d = mesh[i]
        if d.type != "cuda":
            return fn(*args[i]), None
        s = torch.cuda.Stream(d)
        with torch.cuda.device(d), torch.cuda.stream(s):
            s.wait_stream(callers[d])
            for t in _tensors(args[i]):
                if t.device.type == "cuda":
                    t.record_stream(s)
            return fn(*args[i]), s

    with ThreadPoolExecutor(len(mesh), thread_name_prefix="iiv-shard") as pool:
        futures = [pool.submit(one, i) for i in range(len(mesh))]
        results = [f.result() for f in futures]
    outs = []
    for d, (out, s) in zip(mesh, results):
        if s is not None:
            callers[d].wait_stream(s)
            for t in _tensors(out):
                t.record_stream(callers[d])
        outs.append(out)
    return outs


def _sharding(mesh, *batches):
    """The mesh a batch call runs on: None for an unsharded call, else a
    tuple of two or more devices.  A batch given as shards names its own
    mesh when `mesh` is None."""
    if mesh is None and isinstance(batches[0], (tuple, list)):
        mesh = tuple(t.device for t in batches[0])
    mesh = as_mesh(mesh)
    return None if mesh is None or len(mesh) == 1 else mesh


def _as_shards(x, mesh: tuple) -> tuple:
    if isinstance(x, torch.Tensor):
        return shard_batch(x, mesh)
    if len(x) != len(mesh):
        raise ValueError("%d shards for a mesh of %d" % (len(x), len(mesh)))
    return tuple(t.to(d) for t, d in zip(x, mesh))


def _unsharded(x, mesh):
    """A batch for an unsharded call: one shard unwrapped, on the mesh's
    one device if there is one."""
    if isinstance(x, (tuple, list)):
        if len(x) != 1:
            raise ValueError("%d shards for an unsharded call" % len(x))
        x = x[0]
    mesh = as_mesh(mesh)
    return x if mesh is None else x.to(mesh[0])


def ingest_chunk(rgb: torch.Tensor, mode: VideoMode, palette: Palette):
    """(C, H, W, 3) uint8 frames -> encoder targets (lanes (C, 32, 128, L)
    int32, bytes (C, 2, 32, 256) int32) on the frames' device."""
    with span("ingest.resize"):
        if rgb.shape[1:3] != (frames_mod.TARGET_H, frames_mod.TARGET_W):
            rgb = resize.resize_batch(rgb, frames_mod.TARGET_H,
                                      frames_mod.TARGET_W)
    if mode == VideoMode.DHGR:
        with span("ingest.quantize"):
            codes = dither.quantize_ordered(rgb, palette)
        with span("ingest.pack"):
            main, aux = dither.dhgr_codes_to_memory(codes)
    else:
        # HGR's quantizer packs as it goes
        with span("ingest.quantize"):
            main, aux = dither.quantize_hgr(rgb, palette), None
    with span("ingest.targets"):
        return encoder.prepare_targets(main, aux, mode, rgb.device)


def _ingest(rgb_b: torch.Tensor, mode: VideoMode, palette: Palette):
    """Ingest (B, F, H, W, 3) frames on their device.  Each chunk holds
    frames of one movie, from its first frame on, so a movie meets the
    same chunk shapes (and the resize's products the same sums) whatever
    batch or shard it is in."""
    B, F = rgb_b.shape[:2]
    lanes, bytes_ = [], []
    for b in range(B):
        for f in range(0, F, INGEST_CHUNK):
            ln, by = ingest_chunk(rgb_b[b, f:f + INGEST_CHUNK], mode, palette)
            lanes.append(ln)
            bytes_.append(by)
    with span("ingest.cat"):
        lanes = torch.cat(lanes)
        bytes_ = torch.cat(bytes_)
    return (lanes.reshape((B, F) + tuple(lanes.shape[1:])),
            bytes_.reshape((B, F) + tuple(bytes_.shape[1:])))


def ingest_movies_batch(rgb_b: torch.Tensor, mode: VideoMode,
                        palette: Palette, mesh=None):
    """Device-side batched ingestion for equal-length movies.

    rgb_b: (B, F, H, W, 3) uint8 source frames on the card (or the CPU).
    Returns (lanes_b (B, F, 32, 128, L) int32, bytes_b (B, F, 2, 32, 256)
    int32) on the same device, or on a mesh of several entries a tuple of
    shards each, ingested each on its device.
    """
    require_mode(mode)
    require_palette(palette)
    if not isinstance(rgb_b, torch.Tensor):
        raise TypeError("ingest_movies_batch takes a tensor on the device "
                        "to ingest on, got %s" % type(rgb_b).__name__)
    with span("ingest"):
        sharded = _sharding(mesh, rgb_b)
        if sharded is None:
            return _ingest(_unsharded(rgb_b, mesh), mode, palette)
        outs = _map_shards(sharded, lambda x: _ingest(x, mode, palette),
                           [(x,) for x in shard_batch(rgb_b, sharded)])
    lanes, bytes_ = zip(*outs)
    return lanes, bytes_


def _encode(dist, lanes_tgt_b, bytes_tgt_b, plan, mode, seeds, joint):
    ops, main, aux = encoder.encode_movies(
        dist, lanes_tgt_b, bytes_tgt_b, plan, mode, seeds, joint)
    return ops.reshape(ops.shape[0], -1), main, aux


def encode_movies_batch(dist, lanes_tgt_b, bytes_tgt_b,
                        plan: encoder.MoviePlan, mode: VideoMode,
                        seeds, mesh=None, joint: bool = False):
    """Encode a batch of equal-schedule movies on the targets' device, or
    sharded over a mesh.

    lanes_tgt_b: (B, F, 32, 128, L); bytes_tgt_b: (B, F, 2, 32, 256) -
    tensors, or tuples of shards (as `ingest_movies_batch` returns them on
    a mesh, which they then name when `mesh` is None); seeds: B ints, one
    per movie, or None (deterministic).  All movies share `plan`; use
    encode_movies_mixed for mixed-length batches.
    Returns (ops (B, S*K*J*6) flat uint8 - see fetch_ops -, final main
    (B, 32, 256), final aux); on a mesh of several entries each is a tuple
    of shards in batch order, shard i encoded on mesh entry i with its
    movies' seeds.
    """
    with span("encode"):
        return _encode_batch(dist, lanes_tgt_b, bytes_tgt_b, plan, mode,
                             seeds, mesh, joint)


def _encode_batch(dist, lanes_tgt_b, bytes_tgt_b, plan, mode, seeds, mesh,
                  joint):
    sharded = _sharding(mesh, lanes_tgt_b, bytes_tgt_b)
    if sharded is None:
        lanes = _unsharded(lanes_tgt_b, mesh)
        if mesh is not None:  # a one-entry mesh names the device to use
            dist = dist.to(lanes.device)
        return _encode(dist, lanes, _unsharded(bytes_tgt_b, mesh), plan,
                       mode, seeds, joint)
    lanes = _as_shards(lanes_tgt_b, sharded)
    bytes_ = _as_shards(bytes_tgt_b, sharded)
    if seeds is not None:
        seeds = [int(s) for s in seeds]
        if len(seeds) != sum(len(x) for x in lanes):
            raise ValueError("%d seeds for %d movies"
                             % (len(seeds), sum(len(x) for x in lanes)))
    parts, b0 = [], 0
    for ln in lanes:
        parts.append(None if seeds is None else seeds[b0:b0 + len(ln)])
        b0 += len(ln)
    dists = replicate(dist, sharded)
    outs = _map_shards(
        sharded, lambda d, ln, by, sd: _encode(d, ln, by, plan, mode, sd,
                                               joint),
        list(zip(dists, lanes, bytes_, parts)))
    ops, main, aux = zip(*outs)
    return ops, main, aux


def encode_movies_mixed(dist, movies, mode: VideoMode,
                        input_frame_rate: float, ticks_per_second: float,
                        every_n_video_frames: int = 1, k: int = 8,
                        j: int = 1, seeds=None, mesh=None,
                        joint: bool = False):
    """Encode a batch of DIFFERENT-length movies in one lockstep encode,
    sharded over `mesh` when it has several entries.

    movies: list of (targets_main (F_i, 32, 256) u8, targets_aux or None,
    n_input_frames_i, n_audio_ticks_i) sharing the frame rate, tick rate,
    every_n, k and j.  All encode under one shared plan built from (max
    frames, max ticks), which dominates every movie in both ops and encoded
    frames; video targets are padded by repeating each movie's last frame,
    and movie i's stream is the first n_ops_i flattened ops (the encode is
    causal).  Each movie is bit-identical to its padded solo encode.
    seeds default to 0..B-1.

    Returns (flat_ops: list of (n_ops_i, 6) arrays, plan_max, n_ops).
    """
    plans = [encoder.plan_movie(
        n_frames=nf, n_audio_ticks=nt, input_frame_rate=input_frame_rate,
        ticks_per_second=ticks_per_second,
        every_n_video_frames=every_n_video_frames, mode=mode, k=k, j=j)
        for _, _, nf, nt in movies]
    n_ops = [p.n_ops for p, _ in plans]
    plan_max, n_enc_max = encoder.plan_movie(
        n_frames=max(nf for _, _, nf, _ in movies),
        n_audio_ticks=max(nt for _, _, _, nt in movies),
        input_frame_rate=input_frame_rate,
        ticks_per_second=ticks_per_second,
        every_n_video_frames=every_n_video_frames, mode=mode, k=k, j=j)
    assert plan_max.n_ops >= max(n_ops)
    assert all(n_enc_max >= ne for _, ne in plans)

    def pad_targets(t):
        t = np.asarray(t)
        if len(t) >= n_enc_max:
            return t[:n_enc_max]
        reps = np.repeat(t[-1:], n_enc_max - len(t), axis=0)
        return np.concatenate([t, reps], axis=0)

    mains = np.stack([pad_targets(m[0]) for m in movies])
    auxes = (np.stack([pad_targets(m[1]) for m in movies])
             if mode == VideoMode.DHGR else None)
    lanes_b, bytes_b = encoder.prepare_targets(mains, auxes, mode,
                                               dist.device)
    if seeds is None:
        seeds = range(len(movies))
    ops_b, _, _ = encode_movies_batch(
        dist, lanes_b, bytes_b, plan_max, mode, seeds=list(seeds),
        mesh=mesh, joint=joint)
    ops_np = fetch_ops(ops_b, plan_max)
    flats = [encoder.flatten_ops(ops_np[i], plan_max)[:n_ops[i]]
             for i in range(len(movies))]
    return flats, plan_max, n_ops


def fetch_ops(ops_dev, plan: encoder.MoviePlan) -> np.ndarray:
    """Copy the flat (B, S*K*J*6) ops of encode_movies_batch (a tensor or
    a tuple of shards) to the host as (B, S, K*J, 6) uint8."""
    if isinstance(ops_dev, (tuple, list)):
        return np.concatenate([fetch_ops(o, plan) for o in ops_dev])
    return ops_dev.cpu().numpy().reshape(
        ops_dev.shape[0], -1, plan.k * plan.j, encoder.OP_FIELDS)


def fetch_ops_compact(ops_dev, plan: encoder.MoviePlan) -> np.ndarray:
    """Copy only the VALID ops to the host: (B, n_ops, 6) uint8, from a
    tensor or a tuple of shards.

    The padding mask is static per plan (step_nvalid), so the padding slots
    are dropped on the card by one static-index `index_select` before the
    copy; flatten_ops on the host becomes a no-op."""
    if isinstance(ops_dev, (tuple, list)):
        return np.concatenate([fetch_ops_compact(o, plan) for o in ops_dev])
    kj = plan.k * plan.j
    valid = (np.arange(kj)[None, :]
             < plan.step_nvalid[:, None]).reshape(-1)
    idx = torch.as_tensor(np.flatnonzero(valid), device=ops_dev.device)
    assert len(idx) == plan.n_ops
    ops = ops_dev.reshape(ops_dev.shape[0], -1, encoder.OP_FIELDS)
    return ops.index_select(1, idx).cpu().numpy()


def _fetch_parts(ops, streams: int):
    """The parts a parallel fetch copies, one thread each: the shards of a
    tuple, or `streams` slices of one tensor along the batch; and, per
    card, an event on the calling thread's stream that the copies wait
    for."""
    if isinstance(ops, (tuple, list)):
        parts = list(ops)
    else:
        parts = list(torch.tensor_split(ops, max(1, min(streams,
                                                        ops.shape[0]))))
    ready = {}
    for p in parts:
        if p.device.type == "cuda" and p.device not in ready:
            ready[p.device] = torch.cuda.current_stream(p.device)\
                .record_event()
    return parts, ready


def _fetch(parts, ready, plan, compact: bool) -> np.ndarray:
    def pull(p):
        one = fetch_ops_compact if compact else fetch_ops
        if p.device.type != "cuda":
            return one(p, plan)
        s = torch.cuda.Stream(p.device)
        with torch.cuda.device(p.device), torch.cuda.stream(s):
            s.wait_event(ready[p.device])
            p.record_stream(s)
            return one(p, plan)

    with ThreadPoolExecutor(len(parts), thread_name_prefix="iiv-fetch") \
            as pool:
        return np.concatenate(list(pool.map(pull, parts)))


def fetch_ops_parallel(ops_dev, plan: encoder.MoviePlan,
                       compact: bool = True, streams: int = 4) -> np.ndarray:
    """Fetch batched ops to the host on several threads at once: each
    shard of a tuple (each card's copy on its own thread and stream), or
    `streams` slices of one tensor.  With compact=True the static
    valid-op gather runs on the device first.  Returns (B, n_ops, 6) uint8
    (compact) or the padded (B, S, K*J, 6) view, in batch order."""
    return _fetch(*_fetch_parts(ops_dev, streams), plan, compact)


def fetch_ops_parallel_future(ops_dev, plan: encoder.MoviePlan,
                              compact: bool = True, streams: int = 4):
    """fetch_ops_parallel on a background thread; returns a Future.  The
    copies wait for the work queued on the calling thread's stream when
    this is called, not for what it queues after, so the next batch's
    encode runs beside the fetch."""
    parts, ready = _fetch_parts(ops_dev, streams)
    pool = ThreadPoolExecutor(1, thread_name_prefix="iiv-fetch-drv")
    try:
        return pool.submit(_fetch, parts, ready, plan, compact)
    finally:
        pool.shutdown(wait=False)


def build_tables_sharded(mode: VideoMode, palette: Palette, mesh,
                         n_rows=None) -> torch.Tensor:
    """Edit-distance LUTs sharded over the mesh: each lane's source codes
    (the first `n_rows`, or all) split into one row block per entry, and
    each block runs kernel A on its device against every column code (no
    communication until the gather).

    Returns the (n_lanes, n_rows * N) uint16 rows of `editdist.build_tables`
    on the mesh's first device, bit for bit: each block is the general
    all-pairs tile (a row block is another code set than the columns).
    Blocks on that device write into the result in place; the others are
    copied over."""
    mesh = as_mesh(mesh)
    if mesh is None:
        raise ValueError("build_tables_sharded needs a mesh")
    spec = spec_for_mode(require_mode(mode))
    sub = editdist.cost_matrix(require_palette(palette), "cpu")
    codes = [editdist.lane_codes(mode, lane, "cpu")
             for lane in range(int(spec.N_LANES))]
    N = codes[0].shape[0]
    n = N if n_rows is None else n_rows
    rows = zip(*(shard_batch(c[:n], mesh) for c in codes))
    cols = zip(*(replicate(c, mesh) for c in codes))
    out = torch.empty((len(codes), n, N), dtype=torch.uint16,
                      device=mesh[0])
    blk = n // len(mesh)

    def block(i, rows_i, cols_i, sub_i, dst):
        if dst.device != rows_i[0].device:
            dst = torch.empty((len(codes), blk, N), dtype=torch.uint16,
                              device=rows_i[0].device)
        else:
            dst = dst[:, i * blk:(i + 1) * blk]
        for lane, (r, c) in enumerate(zip(rows_i, cols_i)):
            editdist.pair_distance(r, c, sub_i, out=dst[lane])
        return dst

    blocks = _map_shards(mesh, block, [
        (i, r, c, s, out) for i, (r, c, s) in enumerate(
            zip(rows, cols, replicate(sub, mesh)))])
    for i, b in enumerate(blocks):
        if b.device != out.device:
            out[:, i * blk:(i + 1) * blk].copy_(b)
    return out.reshape(len(codes), -1)

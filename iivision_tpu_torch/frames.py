"""Host frame ingestion: video decode -> resize -> (D)HGR target memory maps
(the port's copy of the host path of iivision_tpu/frames.py).

A decode thread feeds batches of resized frames through a bounded queue,
so decode overlaps quantization and host memory stays bounded by the queue
depth.  Resize is PIL-exact C++ (`ops/resize.resize_host`); quantization
is the C++ fused-LUT ordered dither and packing, the C++ error-diffusion
dithers, or the 1-bit mono dither at full dot resolution.  A per-movie
.npz target cache beside the source, stamped with the source file's
identity, is read and written in the JAX package's layout.  Reference
bmp2dhr frame caches (`<video>/<MODE>/<PALETTE>/%08d.BIN/.AUX`) are
ingestible directly.  `ingest_stream_array` is the producer of the
streaming transcode: an in-memory source quantized batch by batch on a
small thread pool.  Device ingest is `parallel/mesh.ingest_movies_batch`.
"""

import functools
import os
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from iivision_tpu_torch.ops import dither
from iivision_tpu_torch.ops.resize import resize_host
from iivision_tpu_torch.palettes import Palette, require_palette
from iivision_tpu_torch.video_mode import VideoMode, require_mode

TARGET_W, TARGET_H = 140, 192
DECODE_BATCH = 64  # frames per decode/quantize batch
QUEUE_BATCHES = 4  # bounded pipeline depth (host RAM cap)
# quantizer-behaviour version folded into the cache tag (the JAX package's
# own: caches written by either package for the same tag are the same)
_QUANTIZER_CACHE_VER = 3


@dataclass
class MovieFrames:
    """Encoded-frame targets plus movie timing metadata."""
    targets_main: np.ndarray  # (F_enc, 32, 256) uint8
    targets_aux: Optional[np.ndarray]  # (F_enc, 32, 256) uint8 or None
    n_frames_total: int  # total pulled frames (before every_n skipping)
    input_frame_rate: float


def iter_video_frames(path: str) -> Tuple[Iterator[np.ndarray], float]:
    """Yield RGB uint8 frames from a video/gif/npy source, with frame
    rate."""
    lower = path.lower()
    if lower.endswith((".npy", ".npz")):
        data = np.load(path)
        if isinstance(data, np.lib.npyio.NpzFile):
            arr = data["frames"]
            rate = float(data["frame_rate"]) if "frame_rate" in data else 30.0
        else:
            arr, rate = data, 30.0
        return iter(arr), rate
    if lower.endswith((".gif", ".png", ".jpg", ".jpeg", ".bmp")):
        from PIL import Image, ImageSequence
        im = Image.open(path)
        dur = im.info.get("duration", 100) or 100

        def gen():
            for fr in ImageSequence.Iterator(im):
                yield np.asarray(fr.convert("RGB"))
        return gen(), 1000.0 / float(dur)
    # video container: OpenCV, else an ffmpeg pipe
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        if cap.isOpened():
            rate = cap.get(cv2.CAP_PROP_FPS) or 30.0

            def gen():
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield frame[:, :, ::-1]  # BGR -> RGB
                cap.release()
            return gen(), float(rate)
    except ImportError:
        pass
    return _ffmpeg_frames(path)


def _ffmpeg_frames(path: str):
    import json
    import shutil
    import subprocess
    if shutil.which("ffprobe") is None:
        raise RuntimeError("No decoder available for %s" % path)
    probe = json.loads(subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height,r_frame_rate",
         "-of", "json", path], check=True, capture_output=True).stdout)
    st = probe["streams"][0]
    w, h = int(st["width"]), int(st["height"])
    num, den = st["r_frame_rate"].split("/")
    proc = subprocess.Popen(
        ["ffmpeg", "-v", "error", "-i", path, "-f", "rawvideo",
         "-pix_fmt", "rgb24", "-"], stdout=subprocess.PIPE)

    def gen():
        frame_bytes = w * h * 3
        while True:
            buf = proc.stdout.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            yield np.frombuffer(buf, np.uint8).reshape(h, w, 3)
        proc.stdout.close()
        proc.wait()
    return gen(), float(num) / float(den)


def resize_frame(rgb: np.ndarray) -> np.ndarray:
    """Lanczos resize of one frame to the 140x192 DHGR pixel grid."""
    return resize_host(np.asarray(rgb, dtype=np.uint8)[None], TARGET_H,
                       TARGET_W)[0]


def _quantize_batch(rgb: np.ndarray, mode: VideoMode, palette: Palette,
                    dither_mode: str):
    """Quantize a (B, 192, W, 3) uint8 batch on the host to (main, aux)
    (B, 32, 256) uint8 (aux None for HGR)."""
    if dither_mode == "mono":
        # 1-bit dither at the full 560-dot resolution; integer-only, so the
        # torch form on the CPU is exact
        main, aux = dither.quantize_mono(torch.as_tensor(rgb), mode)
        return main.numpy(), None if aux is None else aux.numpy()
    if dither_mode == "ordered":
        if mode == VideoMode.DHGR:
            return dither.dhgr_pack_host(
                dither.quantize_ordered_host(rgb, palette))
        return dither.quantize_hgr_host(rgb, palette), None
    codes = torch.as_tensor(np.stack([
        dither.quantize_error_diffusion(f.astype(np.float32), palette,
                                        kernel=dither_mode)
        for f in rgb]))
    if mode == VideoMode.DHGR:
        main, aux = dither.dhgr_codes_to_memory(codes)
        return main.numpy(), aux.numpy()
    dots = dither.hgr_desired_dots(codes)
    return dither.hgr_bytes_to_memory(dither.hgr_dots_to_bytes(dots)).numpy(), \
        None


def reference_cache_dir(video_path: str, mode: VideoMode,
                        palette: Palette) -> str:
    """The reference's frame-cache directory for a video:
    `<video sans ext>/<MODE>/<PALETTE>`."""
    return os.path.join(os.path.splitext(video_path)[0],
                        mode.name, palette.name)


def load_reference_cache(cache_dir: str, mode: VideoMode):
    """Reference bmp2dhr frame caches (one 8 KB flat memory dump per
    frame: `%08d.BIN` + `%08d.AUX` for DHGR, `%08dC.BIN` for HGR) as
    encoder targets.  Returns (main (F, 32, 256), aux or None, F)."""
    mains, auxes = [], []
    idx = 0
    while True:
        if mode == VideoMode.DHGR:
            mainfile = os.path.join(cache_dir, "%08d.BIN" % idx)
            auxfile = os.path.join(cache_dir, "%08d.AUX" % idx)
            if not (os.path.exists(mainfile) and os.path.exists(auxfile)):
                break
            mains.append(np.fromfile(mainfile, dtype=np.uint8))
            auxes.append(np.fromfile(auxfile, dtype=np.uint8))
        else:
            mainfile = os.path.join(cache_dir, "%08dC.BIN" % idx)
            if not os.path.exists(mainfile):
                break
            mains.append(np.fromfile(mainfile, dtype=np.uint8))
        idx += 1
    if idx == 0:
        raise ValueError("No cached frames found in %s" % cache_dir)
    for arr in mains + auxes:
        if arr.size != 8192:
            raise ValueError("Cached frame is %d bytes, expected 8192"
                             % arr.size)
    main = np.stack(mains).reshape(idx, 32, 256)
    aux = (np.stack(auxes).reshape(idx, 32, 256)
           if mode == VideoMode.DHGR else None)
    return main, aux, idx


def _cache_path(path: str, mode, palette, every_n, dither_name) -> str:
    base = os.path.splitext(path)[0]
    tag = "%s_%s_n%d_%s_v%d" % (mode.name, palette.name, every_n,
                                dither_name, _QUANTIZER_CACHE_VER)
    return "%s.iiv_%s.npz" % (base, tag)


def _source_stamp(path: str) -> str:
    """Identity stamp of the source file (size + mtime): a changed source
    invalidates the quantized-target cache."""
    st = os.stat(path)
    return "%d:%d" % (st.st_size, st.st_mtime_ns)


def _resize_stack(batch, width: int = TARGET_W) -> np.ndarray:
    """Stack and resize a list of same-or-mixed-size frames to the target
    grid (140 wide for the colour quantizers, 560 for mono)."""
    if all(f.shape[:2] == (TARGET_H, width) for f in batch):
        return np.stack(batch)
    out = np.empty((len(batch), TARGET_H, width, 3), dtype=np.uint8)
    by_shape = {}
    for i, f in enumerate(batch):
        by_shape.setdefault(f.shape, []).append(i)
    for idxs in by_shape.values():
        out[idxs] = resize_host(np.stack([batch[i] for i in idxs]),
                                TARGET_H, width)
    return out


def _decode_worker(frames_iter, every_n: int, out_q: queue.Queue,
                   stop: threading.Event, width: int = TARGET_W):
    """Decode thread: batches of resized RGB frames into a bounded queue,
    then ("done", n_frames_total) or ("error", exc).  `stop` aborts the
    worker if the consumer dies, so it never blocks on a full queue."""
    def put(item):
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    try:
        batch = []
        n_total = 0
        for idx, frame in enumerate(frames_iter):
            if stop.is_set():
                return
            n_total += 1
            if (idx % every_n) != 0:
                continue
            batch.append(np.asarray(frame, dtype=np.uint8))
            if len(batch) == DECODE_BATCH:
                if not put(("batch", _resize_stack(batch, width))):
                    return
                batch = []
        if batch and not put(("batch", _resize_stack(batch, width))):
            return
        put(("done", n_total))
    except BaseException as e:  # surface decode errors to the consumer
        put(("error", e))


INGEST_WORKERS = 4  # resize+quantize threads (the C++ paths release the GIL)


@functools.lru_cache(None)
def _ingest_pool():
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(INGEST_WORKERS)


def ingest_stream_array(source: np.ndarray, mode: VideoMode,
                        palette: Palette, every_n_video_frames: int = 1,
                        batch: Optional[int] = None):
    """Generator of quantized (main, aux) uint8 target batches for an
    in-memory (F, H, W, 3) source: the producer side of the streaming
    transcode (`encoder.encode_movie_streaming`).

    Resize and quantize fan out over a small thread pool (the C++ resize,
    LUT quantize and packing all release the GIL) and are yielded strictly
    in order through a bounded sliding window of futures, so host ingest
    runs INGEST_WORKERS wide, overlaps the consumer's device work, and
    keeps in-flight memory capped for hour-scale movies.  Short movies
    shrink the default batch so all workers engage."""
    require_mode(mode)
    require_palette(palette)
    sel = source[::every_n_video_frames]
    if batch is not None and batch <= 0:
        raise ValueError("batch must be positive, got %r" % (batch,))
    b = batch or DECODE_BATCH
    if batch is None and len(sel) <= 2 * INGEST_WORKERS * b:
        # an explicit batch request is honoured as it is
        b = max(8, -(-len(sel) // (2 * INGEST_WORKERS)))

    def job(i, n=b):
        # a few large calls, each of which drops the interpreter lock for
        # its work: the consumer's thread launches a kernel every few tens
        # of microseconds and loses time at every handover of the lock
        chunk = np.ascontiguousarray(sel[i:i + n], dtype=np.uint8)
        return _quantize_batch(resize_host(chunk, TARGET_H, TARGET_W), mode,
                               palette, "ordered")

    # build or load the C++ helpers and the fused LUT here, on the calling
    # thread: the workers must not race to compile one library
    if len(sel):
        job(0, 1)
    pool = _ingest_pool()

    starts = iter(range(0, len(sel), b))
    futs = deque()
    try:
        for _ in range(QUEUE_BATCHES + INGEST_WORKERS):
            i = next(starts, None)
            if i is None:
                break
            futs.append(pool.submit(job, i))
        while futs:
            out = futs.popleft().result()
            i = next(starts, None)
            if i is not None:
                futs.append(pool.submit(job, i))
            yield out
    finally:
        for f in futs:  # abandoned mid-stream: drop queued work
            f.cancel()


def ingest(source, mode: VideoMode, palette: Palette,
           every_n_video_frames: int = 1, dither_mode: str = "ordered",
           frame_rate: Optional[float] = None,
           cache: bool = True) -> MovieFrames:
    """Decode and quantize a movie into encoder targets (pipelined).

    source: a path (video/gif/npy/npz), a (F, H, W, 3) uint8 array
    (frame_rate then recommended), or a reference bmp2dhr frame-cache
    directory (frame_rate required)."""
    require_mode(mode)
    require_palette(palette)
    cache_file = None
    if isinstance(source, np.ndarray):
        frames_iter, rate = iter(source), (frame_rate or 30.0)
    elif os.path.isdir(source):
        if frame_rate is None:
            raise ValueError(
                "Reference frame-cache directories carry no frame-rate "
                "metadata; pass frame_rate (--frame_rate on the CLI) for %s"
                % source)
        main, aux, n = load_reference_cache(source, mode)
        sel = slice(None, None, every_n_video_frames)
        return MovieFrames(
            targets_main=main[sel],
            targets_aux=(None if aux is None else aux[sel]),
            n_frames_total=n, input_frame_rate=frame_rate)
    else:
        frames_iter, rate = iter_video_frames(source)
        if frame_rate:
            rate = frame_rate
        cache_file = _cache_path(source, mode, palette, every_n_video_frames,
                                 dither_mode) if cache else None
        if cache_file and os.path.exists(cache_file):
            data = np.load(cache_file)
            stamp = str(data["stamp"]) if "stamp" in data else None
            if stamp == _source_stamp(source):
                return MovieFrames(
                    targets_main=data["main"],
                    targets_aux=(data["aux"] if "aux" in data else None),
                    n_frames_total=int(data["n_total"]),
                    input_frame_rate=float(frame_rate or data["rate"]))

    q = queue.Queue(maxsize=QUEUE_BATCHES)
    stop = threading.Event()
    width = dither.MONO_W if dither_mode == "mono" else TARGET_W
    t = threading.Thread(
        target=_decode_worker,
        args=(frames_iter, every_n_video_frames, q, stop, width),
        daemon=True)
    t.start()
    pending = []
    n_total = None
    try:
        while True:
            kind, payload = q.get()
            if kind == "error":
                raise payload
            if kind == "done":
                n_total = payload
                break
            pending.append(_quantize_batch(payload, mode, palette,
                                           dither_mode))
    finally:
        stop.set()  # unblock and end the worker if we errored out
    t.join()
    if not pending:
        raise ValueError("No frames decoded from source")

    main = np.concatenate([m for m, _ in pending])
    aux = (np.concatenate([a for _, a in pending])
           if mode == VideoMode.DHGR else None)
    if cache_file:
        payload = dict(main=main, n_total=n_total, rate=rate,
                       stamp=_source_stamp(source))
        if aux is not None:
            payload["aux"] = aux
        np.savez_compressed(cache_file, **payload)
    return MovieFrames(targets_main=main, targets_aux=aux,
                       n_frames_total=n_total, input_frame_rate=rate)

"""The library converter's loop (the port's bench `pipelined_dhgr`, with the
synthesis moved into set-up and each movie's own sound).

Set-up makes `pool` distinct batches of `batch` clips of `clip_seconds` on
the device (only the frames the plan encodes, at the configuration's
source size), each clip with its own tone, and the program's normalization
of each tone.  The window cycles the pool, one client, closed loop: the
main thread queues round r + 1 (`mesh.ingest_movies_batch`, each movie's
device audio levels, `mesh.encode_movies_batch`, then
`mesh.fetch_ops_parallel_future`, the port's compaction and copy of the
records on side streams, and the levels' copy to pinned host memory on a
side stream) while one worker thread waits for round r's records and
levels and emits its streams with `emit_stream_fast`.  Every round gets
fresh seeds.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import drive
from benchmark.gen import clips as gen
from benchmark.reference.check import ClipIn, ClipOut


class Client:
    # a run's traffic at the tests' tiny sizes on the CPU
    TINY = dict(clip_seconds=0.2, batch=2, pool=1, sample_span=1,
                sample_rounds=1, sample_movies=2)

    @staticmethod
    def control_clips(cfg: dict, tr: dict, rng: np.random.Generator,
                      device) -> list:
        """As many clips as a run checks, made by this loop's generator
        from `rng`, for the control."""
        n_frames = int(round(tr["clip_seconds"] * float(cfg["source_fps"])))
        n = int(tr["sample_rounds"]) * int(tr["sample_movies"])
        F = len(range(0, n_frames, int(cfg["every_n_video_frames"])))
        rgb = gen.synth_movies_device(gen.phases(rng, n), F, device,
                                      *gen.source_size(cfg))
        waves = drive.waves(rng, cfg, tr["clip_seconds"], n)
        base = int(rng.integers(1, 1 << 30))
        return [ClipIn(rgb[i], waves[i], base + i, n_frames)
                for i in range(n)]

    def __init__(self, cfg: dict, tr: dict, dev: torch.device,
                 rng: np.random.Generator, spans):
        from iivision_tpu_torch import audio as audio_mod
        from iivision_tpu_torch import encoder
        from iivision_tpu_torch.bench import audio_levels_device
        from iivision_tpu_torch.movie import get_distance
        from iivision_tpu_torch.parallel import mesh
        from iivision_tpu_torch.stream.emit_fast import emit_stream_fast

        self._mesh, self._emit = mesh, emit_stream_fast
        self._levels_device = audio_levels_device
        self.dev, self.spans = dev, spans
        self.mode, self.palette = drive.program_mode(cfg)
        self.B = B = int(tr["batch"])
        P = int(tr["pool"])
        bitrate = int(cfg["audio_bitrate"])
        fps = float(cfg["source_fps"])
        every = int(cfg["every_n_video_frames"])
        n_frames = int(round(tr["clip_seconds"] * fps))
        self.dist = get_distance(self.mode, self.palette,
                                 cfg["colour_model"], device=dev)
        self.waves = drive.waves(rng, cfg, tr["clip_seconds"], P * B)
        auds = [audio_mod.Audio(data=w, rate=bitrate, bitrate=bitrate,
                                device=dev) for w in self.waves]
        self.norms = [a.normalization for a in auds]
        self.plan, _ = encoder.plan_movie(
            n_frames=n_frames, n_audio_ticks=len(auds[0].levels()),
            input_frame_rate=fps, ticks_per_second=bitrate,
            every_n_video_frames=every, mode=self.mode, k=int(cfg["k"]),
            j=int(cfg["j"]))
        self.n_frames = n_frames
        self.F = len(range(0, n_frames, every))
        self.n_ops = self.plan.n_ops
        self.movie_s = self.n_ops / bitrate
        self.plan_info = drive.plan_info(self.plan, self.F)
        self.wave_dev = torch.as_tensor(self.waves, device=dev)
        ph = gen.phases(rng, P * B).reshape(P, B)
        self.pool = [gen.synth_movies_device(ph[p], self.F, dev,
                                             *gen.source_size(cfg))
                     for p in range(P)]
        # seeds base + r * B + b for round r, movie b; the warm-up's below
        self.base = int(rng.integers(B, 1 << 30))
        span = int(tr["sample_span"])
        self.sample = {
            int(r): sorted(int(b) for b in rng.choice(
                B, int(tr["sample_movies"]), replace=False))
            for r in rng.choice(span, int(tr["sample_rounds"]),
                                replace=False)}
        self.kept = {}
        on_card = dev.type == "cuda"
        self.side = torch.cuda.Stream(dev) if on_card else None
        self.bufs = [torch.empty((B, self.n_ops), dtype=torch.int32,
                                 pin_memory=on_card) for _ in range(2)]
        self.worker = ThreadPoolExecutor(1, thread_name_prefix="bench-emit")

    def _clip(self, r: int, b: int) -> int:
        """Index into the pool's clips (and waves) of round r's movie b."""
        return (r % len(self.pool)) * self.B + b

    def _launch(self, r: int, seed0: int):
        """Queue round r; returns the future of its records on the host
        and the event that the levels' copy records (None on the CPU,
        where the copy is done)."""
        sp = self.spans
        with sp("launch"):
            with sp("ingest"):
                lanes, bytes_ = self._mesh.ingest_movies_batch(
                    self.pool[r % len(self.pool)], self.mode, self.palette)
            with sp("levels"):
                c0 = self._clip(r, 0)
                lv = torch.stack([
                    self._levels_device(self.wave_dev[c0 + b],
                                        self.norms[c0 + b])[:self.n_ops]
                    for b in range(self.B)])
            with sp("encode"):
                ops, main, aux = self._mesh.encode_movies_batch(
                    self.dist, lanes, bytes_, self.plan, self.mode,
                    seeds=list(range(seed0, seed0 + self.B)))
            if r in self.sample:
                self.kept[r] = dict(bytes=bytes_, main=main, aux=aux,
                                    seed0=seed0)
            with sp("fetch"):
                fut = self._mesh.fetch_ops_parallel_future(ops, self.plan)
                host_lv = self.bufs[r % 2]
                if self.side is None:
                    host_lv.copy_(lv)
                    return fut, None
                ready = torch.cuda.current_stream(self.dev).record_event()
                with torch.cuda.stream(self.side):
                    self.side.wait_event(ready)
                    host_lv.copy_(lv, non_blocking=True)
                    lv.record_stream(self.side)
                    return fut, self.side.record_event()

    def _fetch_emit(self, r: int, pending):
        fut, done = pending
        with self.spans("fetch_emit"):
            flat = fut.result()
            if done is not None:
                done.synchronize()
            lv = self.bufs[r % 2].numpy()
            streams = [self._emit(flat[i], lv[i], self.mode)
                       for i in range(self.B)]
        if r in self.sample:
            self.kept[r].update(levels=lv.copy(), streams=streams)
        return streams

    def warm(self):
        """One round on the pool's first batch, with seeds of its own."""
        self._fetch_emit(-1, self._launch(-1, self.base - self.B))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float, run) -> None:
        t0 = time.perf_counter()
        pending = self._launch(0, self.base)
        r = 1
        while time.perf_counter() - t0 < seconds:
            fut = self.worker.submit(self._fetch_emit, r - 1, pending)
            pending = self._launch(r, self.base + r * self.B)
            self._count(run, fut.result())
            r += 1
        self._count(run, self._fetch_emit(r - 1, pending))
        run.window_s = time.perf_counter() - t0
        run.encodes = r

    def _count(self, run, streams):
        run.attempted += self.B
        good = sum(1 for s in streams if s)
        run.failed += self.B - good
        run.movie_s += good * self.movie_s

    def samples(self):
        """(ClipIn, ClipOut) of the sampled clips, on the host but for the
        frames, which stay on the device."""
        ins, outs = [], []
        for r, movies in sorted(self.sample.items()):
            if r not in self.kept or "streams" not in self.kept[r]:
                raise RuntimeError("sampled round %d did not run" % r)
            k = self.kept[r]
            src = self.pool[r % len(self.pool)]
            for b in movies:
                by = k["bytes"][b].to(torch.uint8).cpu().numpy()
                ins.append(ClipIn(src[b], self.waves[self._clip(r, b)],
                                  k["seed0"] + b, self.n_frames))
                outs.append(ClipOut(
                    (by[:, 0], by[:, 1]), k["levels"][b], k["streams"][b],
                    (k["main"][b].cpu().numpy(), k["aux"][b].cpu().numpy())))
        self.kept.clear()
        return ins, outs

    def close(self):
        self.worker.shutdown(wait=True)

    def release(self):
        """Drop the program's state; the pool and the waves stay for the
        check."""
        self.bufs = self.dist = self.wave_dev = None

"""The clip maker's loop.  Set-up makes `pool` clips on the host at the
configuration's source size, each `copies` rolled copies of a
`clip_seconds` clip with a tone of its own.  One client, closed loop:
`Movie(frames_source=..., audio_source=...).transcode` of the next clip
with a fresh seed, to one file under the temporary directory.
"""

import os
import tempfile
import time

import numpy as np
import torch

from benchmark import drive
from benchmark.gen import clips as gen
from benchmark.reference.check import ClipIn, ClipOut


class Client:
    # a run's traffic at the tests' tiny sizes on the CPU
    TINY = dict(clip_seconds=0.2, pool=2, sample_span=1, sample_clips=1)

    @staticmethod
    def control_clips(cfg: dict, tr: dict, rng: np.random.Generator,
                      device) -> list:
        """As many clips as a run checks, made by this loop's generator
        from `rng`, for the control."""
        n_frames = int(round(tr["clip_seconds"] * float(cfg["source_fps"])))
        copies = int(tr.get("copies", 1))
        n = int(tr["sample_clips"])
        rgb = gen.synth_movies_device(gen.phases(rng, n), n_frames, device,
                                      *gen.source_size(cfg)).cpu().numpy()
        frames = [gen.rolled(rgb[i], copies) for i in range(n)]
        waves = drive.waves(rng, cfg, tr["clip_seconds"] * copies, n)
        base = int(rng.integers(1, 1 << 30))
        every = int(cfg["every_n_video_frames"])
        return [ClipIn(f[::every], w, base + i, len(f))
                for i, (f, w) in enumerate(zip(frames, waves))]

    def __init__(self, cfg: dict, tr: dict, dev: torch.device,
                 rng: np.random.Generator, spans):
        from iivision_tpu_torch import audio as audio_mod
        from iivision_tpu_torch.movie import Movie, get_distance

        self._Movie, self._Audio = Movie, audio_mod.Audio
        self.dev, self.spans = dev, spans
        self.mode, self.palette = drive.program_mode(cfg)
        self.cfg = cfg
        self.bitrate = int(cfg["audio_bitrate"])
        self.every = int(cfg["every_n_video_frames"])
        fps = float(cfg["source_fps"])
        n_frames = int(round(tr["clip_seconds"] * fps))
        copies = int(tr["copies"])
        self.dist = get_distance(self.mode, self.palette,
                                 cfg["colour_model"], device=dev)
        P = int(tr["pool"])
        ph = gen.phases(rng, P)
        src = gen.synth_movies_device(ph, n_frames, dev,
                                      *gen.source_size(cfg)).cpu().numpy()
        self.pool = [gen.rolled(src[p], copies) for p in range(P)]
        self.waves = drive.waves(rng, cfg, tr["clip_seconds"] * copies, P)
        self.base = int(rng.integers(1, 1 << 30))
        self.sample = set(int(i) for i in rng.choice(
            int(tr["sample_span"]), int(tr["sample_clips"]), replace=False))
        self.kept = {}
        fd, self.path = tempfile.mkstemp(suffix=".a2m")
        os.close(fd)
        self.plan_info = None

    def _clip(self, i: int, seed: int):
        """One request: (seconds, Movie, stats)."""
        sp = self.spans
        clip = self.pool[i % len(self.pool)]
        wave = self.waves[i % len(self.pool)]
        cfg = self.cfg
        t0 = time.perf_counter()
        with sp("clip"):
            with sp("construct"):
                aud = self._Audio(data=wave, rate=self.bitrate,
                                  bitrate=self.bitrate, device=self.dev)
                m = self._Movie(
                    frames_source=clip, device=self.dev,
                    every_n_video_frames=self.every, audio_source=aud,
                    audio_bitrate=self.bitrate, video_mode=self.mode,
                    palette=self.palette, k=int(cfg["k"]), j=int(cfg["j"]),
                    seed=seed, dist=self.dist)
            with sp("transcode"):
                stats = m.transcode(self.path)
        return time.perf_counter() - t0, m, stats

    def warm(self):
        _, m, _ = self._clip(0, self.base - 1)
        self.plan_info = drive.plan_info(m.plan, len(m.frames.targets_main))

    def window(self, seconds: float, run) -> None:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            run.attempted += 1
            try:
                dt, m, stats = self._clip(i, self.base + i)
            except Exception:  # a clip's failure is counted, not fatal
                import traceback
                traceback.print_exc()
                run.failed += 1
                i += 1
                continue
            if os.path.getsize(self.path) == 0:
                run.failed += 1
            else:
                run.clip_s.append(dt)
                run.movie_s += stats["movie_seconds"]
                run.timings.append(dict(stats, encoder=m.encoder_used))
            if i in self.sample:
                with open(self.path, "rb") as f:
                    data = f.read()
                self.kept[i] = ClipOut(
                    (m.frames.targets_main, m.frames.targets_aux),
                    np.asarray(m.audio.levels())[:m.plan.n_ops], data,
                    (m.final_main, m.final_aux))
            i += 1
        run.window_s = time.perf_counter() - t0
        run.encodes = i

    def samples(self):
        ins, outs = [], []
        for i in sorted(self.sample):
            if i not in self.kept:
                raise RuntimeError("sampled clip %d did not run" % i)
            p = i % len(self.pool)
            ins.append(ClipIn(self.pool[p][::self.every], self.waves[p],
                              self.base + i, len(self.pool[p])))
            outs.append(self.kept.pop(i))
        return ins, outs

    def close(self):
        if os.path.exists(self.path):
            os.remove(self.path)

    def release(self):
        self.dist = None

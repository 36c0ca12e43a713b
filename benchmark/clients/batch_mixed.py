"""The library converter's loop over a folder of clips of different lengths,
on the path of the CLI's `batch` command (`cli.transcode_batch`): each
round is one `mesh.encode_movies_mixed` call, which pads every movie to
the batch's longest and cuts each stream to its own ops, and then the
round's streams are emitted one after another with `emit_stream_fast`.

Set-up makes `pool` batches.  A batch's lengths are always the traffic's
list `lengths_s` (seconds, one a clip); the seed assigns them to the
clips and draws each clip's phase and tone, so the work of a round does
not depend on the seed.  A clip's frames are the synthetic pattern at the
configuration's source size, rolled copies of a `pattern_seconds` pattern
(`gen.rolled_encoded`); only the frames that every-n-th skipping keeps
are drawn, and the skipped ones stay unwritten zero pages that the ingest
passes over unread.  Each clip is ingested on the host by the program's
own `frames.ingest` on the in-memory array, as the CLI ingests each
input, and its levels come from the program's `audio.Audio`; then its
frames are dropped but for the clips the check samples.

Where it departs from the CLI: host ingest and levels are set-up, not
part of the window; the window repeats rounds on the pool with fresh
seeds, where the CLI makes one call over all its inputs; the streams are
not written to disk.

The window: one client, closed loop, a round encoded and then emitted.
The check samples one of the first `sample_span` rounds: its shortest
clip, the one cut hardest, and `sample_clips` - 1 more drawn from the
seed; a window too short to reach that round runs on until it has.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import drive
from benchmark.gen import clips as gen
from benchmark.reference.check import ClipIn, ClipOut

INGEST_THREADS = 4  # clips ingested at once in set-up


def lengths(tr: dict) -> np.ndarray:
    """The batch's clip lengths in seconds, shortest first."""
    return np.sort(np.asarray(tr["lengths_s"], np.float64))


def n_source(cfg: dict, seconds: float) -> int:
    return int(round(seconds * float(cfg["source_fps"])))


def tone(rng: np.random.Generator, cfg: dict, seconds: float) -> np.ndarray:
    return drive.waves(rng, cfg, seconds, 1)[0]


def encoded_frames(cfg: dict, tr: dict, phase: float, n_src: int,
                   device) -> np.ndarray:
    """The frames a clip of n_src source frames encodes, on the host."""
    n_pat = min(n_src, n_source(cfg, float(tr["pattern_seconds"])))
    pattern = gen.synth_movies_device(np.array([phase]), n_pat, device,
                                      *gen.source_size(cfg))[0]
    return gen.rolled_encoded(pattern.cpu().numpy(), n_src,
                              int(cfg["every_n_video_frames"]))


class Client:
    # a run's traffic at the tests' tiny sizes on the CPU
    TINY = dict(lengths_s=[0.2, 0.3, 0.5], pattern_seconds=0.2, pool=1,
                sample_span=1, sample_clips=3)

    @staticmethod
    def control_clips(cfg: dict, tr: dict, rng: np.random.Generator,
                      device) -> list:
        """As many clips as a run checks, made by this loop's generator
        from `rng`, for the control: the shortest length and
        `sample_clips` - 1 others drawn."""
        L = lengths(tr)
        picks = [0] + sorted(int(i) for i in rng.choice(
            np.arange(1, len(L)), int(tr["sample_clips"]) - 1,
            replace=False))
        ph = gen.phases(rng, len(picks))
        waves = [tone(rng, cfg, L[i]) for i in picks]
        base = int(rng.integers(1, 1 << 30))
        out = []
        for n, i in enumerate(picks):
            src = n_source(cfg, L[i])
            out.append(ClipIn(encoded_frames(cfg, tr, ph[n], src, device),
                              waves[n], base + n, src))
        return out

    def __init__(self, cfg: dict, tr: dict, dev: torch.device,
                 rng: np.random.Generator, spans):
        from iivision_tpu_torch import audio as audio_mod
        from iivision_tpu_torch import frames
        from iivision_tpu_torch.movie import get_distance
        from iivision_tpu_torch.parallel import mesh
        from iivision_tpu_torch.stream.emit_fast import emit_stream_fast

        self._mesh, self._emit = mesh, emit_stream_fast
        self._frames, self._Audio = frames, audio_mod.Audio
        self.cfg, self.tr, self.dev, self.spans = cfg, tr, dev, spans
        self.mode, self.palette = drive.program_mode(cfg)
        L = lengths(tr)
        self.B = B = len(L)
        P = int(tr["pool"])
        self.fps = float(cfg["source_fps"])
        self.every = int(cfg["every_n_video_frames"])
        self.bitrate = int(cfg["audio_bitrate"])
        self.dist = get_distance(self.mode, self.palette,
                                 cfg["colour_model"], device=dev)
        # batch p's movie b is L[order[p][b]] seconds long
        order = [rng.permutation(B) for _ in range(P)]
        self.sample_round = int(rng.integers(int(tr["sample_span"])))
        p_s = self.sample_round % P
        shortest = int(np.argmin(order[p_s]))
        self.sample = sorted([shortest] + [int(b) for b in rng.choice(
            [b for b in range(B) if b != shortest],
            int(tr["sample_clips"]) - 1, replace=False)])
        # seeds base + r * B + b for round r, movie b; the warm-up's below
        self.base = int(rng.integers(B, 1 << 30))
        jobs = []
        for p in range(P):
            ph = gen.phases(rng, B)
            for b in range(B):
                s = L[order[p][b]]
                jobs.append((p, b, ph[b], n_source(cfg, s),
                             tone(rng, cfg, s)))
        # the first clip alone: the program builds or loads its host
        # helpers on first use, which threads must not race to do
        made = [self._make(*jobs[0], keep=p_s == 0 and 0 in self.sample)]
        with ThreadPoolExecutor(INGEST_THREADS) as pool:
            made += list(pool.map(
                lambda jb: self._make(*jb, keep=jb[0] == p_s
                                      and jb[1] in self.sample),
                jobs[1:]))
        self.movies = [[m[0] for m in made[p * B:(p + 1) * B]]
                       for p in range(P)]
        self.levels = [[m[1] for m in made[p * B:(p + 1) * B]]
                       for p in range(P)]
        seed0 = self.base + self.sample_round * B
        self.ins = {jb[1]: ClipIn(m[2], jb[4], seed0 + jb[1], jb[3])
                    for jb, m in zip(jobs, made) if m[2] is not None}
        self.kept = {}
        self.plan_info = None

    def _make(self, p: int, b: int, phase: float, n_src: int,
              wave: np.ndarray, keep: bool):
        """One clip through the program's host ingest and levels: (the
        movie as `encode_movies_mixed` takes it, its levels, its encoded
        frames where the check samples it, else None)."""
        enc = encoded_frames(self.cfg, self.tr, phase, n_src, self.dev)
        src = np.zeros((n_src,) + enc.shape[1:], np.uint8)
        src[::self.every] = enc
        fr = self._frames.ingest(src, self.mode, self.palette,
                                 every_n_video_frames=self.every,
                                 frame_rate=self.fps)
        del src
        lv = np.asarray(self._Audio(data=wave, rate=self.bitrate,
                                    bitrate=self.bitrate,
                                    device=self.dev).levels())
        movie = (fr.targets_main, fr.targets_aux, fr.n_frames_total,
                 len(lv))
        return movie, lv, (enc if keep else None)

    def _round(self, r: int, seed0: int):
        """Encode round r: each movie's flat ops, cut to its own."""
        with self.spans("encode"):
            flats, _, _ = self._mesh.encode_movies_mixed(
                self.dist, self.movies[r % len(self.movies)], self.mode,
                self.fps, float(self.bitrate),
                every_n_video_frames=self.every, k=int(self.cfg["k"]),
                j=int(self.cfg["j"]), seeds=range(seed0, seed0 + self.B))
        return flats

    def _emit_one(self, flat, levels) -> bytes:
        """One stream; one that fails is counted, not fatal (empty)."""
        try:
            return self._emit(flat, levels[:len(flat)], self.mode)
        except Exception:
            import traceback
            traceback.print_exc()
            return b""

    def _emit_round(self, r: int, flats):
        """Round r's streams, with each stream's movie seconds."""
        p = r % len(self.movies)
        with self.spans("emit"):
            streams = [self._emit_one(f, self.levels[p][b])
                       for b, f in enumerate(flats)]
        if r == self.sample_round:
            for b in self.sample:
                main, aux = self.movies[p][b][:2]
                self.kept[b] = ClipOut(
                    (main, main if aux is None else aux),
                    self.levels[p][b][:len(flats[b])], streams[b], None)
        return [(s, len(f) / self.bitrate) for s, f in zip(streams, flats)]

    def warm(self):
        """One round on the pool's first batch, with seeds of its own."""
        self._emit_round(-1, self._round(-1, self.base - self.B))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float, run) -> None:
        t0 = time.perf_counter()
        r = 0
        # a window shorter than the sampled round still reaches it
        while r <= self.sample_round or time.perf_counter() - t0 < seconds:
            flats = self._round(r, self.base + r * self.B)
            self._count(run, self._emit_round(r, flats))
            r += 1
        run.window_s = time.perf_counter() - t0
        run.encodes = r

    def _count(self, run, streams):
        run.attempted += len(streams)
        good = [s for s in streams if s[0]]
        run.failed += len(streams) - len(good)
        run.movie_s += sum(m for _, m in good)

    def samples(self):
        """(ClipIn, ClipOut) of the sampled clips, on the host."""
        if set(self.kept) != set(self.sample):
            raise RuntimeError("sampled round %d did not run"
                               % self.sample_round)
        ins = [self.ins[b] for b in self.sample]
        outs = [self.kept.pop(b) for b in self.sample]
        return ins, outs

    def close(self):
        """Nothing to stop: the round's emit runs on the calling thread."""

    def release(self):
        """Drop the program's state and the pool's targets; the sampled
        clips' frames and waves stay for the check."""
        self.dist = self.movies = self.levels = None

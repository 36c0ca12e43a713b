"""What decides a run's `correct`: the sampled clips' outputs, worked out
again by the plain reference from the same RGB frames, samples and seeds,
and compared number by number with a limit each
(`limits/<client>.json`, named by the traffic's client).

A clip's outputs, on either side, are a `ClipOut`: the target banks its
ingest made, the audio levels, the `.a2m` bytes and the encoder's final
screens.  The reference recomputes the targets and the levels from the
inputs.  The reference then encodes each clip from its own target banks
where they equal the judged side's, byte for byte, and from the judged
side's only where they differ within their limit (the encode is
deterministic given its targets, so such a target cannot fail the
stream); either way it derives the lanes itself, and the stream and the
final screens are compared exactly.  Where the levels
are compared on their own, the reference frames the stream with the
judged side's levels; where not, with its own, so that the stream holds
them to the reference.

Each clip is encoded under its own plan, the one its source frame count
and its ticks give, with no padding: clips that share a plan are encoded
together in one batch, and a clip of another length in its own.  So the
stream a clip is held to does not depend on which clips shared its batch
in the program (a batch of mixed lengths pads every movie to the
longest).

Numbers (a client's limits file names those it compares):
`targets_bad_share` (target bytes that differ, over all),
`levels_bad_share` (ticks whose level differs), `stream_bad_bytes` (stream
bytes that differ, plus any difference in length) and `finals_bad_bytes`
(final screen bytes that differ; a client whose program keeps no final
screens leaves it out).

`control_outputs` is the control: the reference in the program's place,
one precision step below what the configuration states (`control=True`
on every stage).  It has to come out not correct.
"""

import json
import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from benchmark.reference import audio, encode, ingest
from benchmark.reference.distance import Distance
from benchmark.reference.palettes import Palette
from benchmark.reference.plan import MoviePlan, flatten_ops, plan_movie
from benchmark.reference.stream import frame_stream
from benchmark.reference.video_mode import VideoMode

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "limits")


@dataclass
class ClipIn:
    """What both sides were handed: encoded frames (F, H, W, 3) uint8 (a
    tensor on the device for the device ingest path, a numpy array for the
    host path), the samples at the tick rate, the encoder's seed and the
    source's frame count before every-n-th skipping, which with the ticks
    gives the clip's own plan."""
    rgb: object
    wave: np.ndarray
    seed: int
    n_source: int


@dataclass
class ClipOut:
    targets: tuple  # (main, aux) (F, 32, 256) uint8 numpy; aux main for HGR
    levels: np.ndarray  # (n_ops,) int32
    stream: bytes
    finals: Optional[tuple]  # (main, aux) (32, 256) numpy, or None


class Setting:
    """One configuration's reference on one ingest path ("device" or
    "host"): mode, palette, each clip's plan and the distance model, on
    `device`; `seconds` sums the wall time of each stage."""

    def __init__(self, cfg: dict, ingest_path: str, device):
        self.mode = VideoMode[cfg["video_mode"]]
        self.palette = Palette[cfg["palette"]]
        self.path = ingest_path
        self.bitrate = int(cfg["audio_bitrate"])
        self.device = torch.device(device)
        self._plan_args = dict(
            input_frame_rate=float(cfg["source_fps"]),
            ticks_per_second=float(self.bitrate),
            every_n_video_frames=int(cfg["every_n_video_frames"]),
            mode=self.mode, k=int(cfg["k"]), j=int(cfg["j"]))
        self.dist = Distance(self.mode, self.palette, self.device)
        # on a card the encoder's bodies replay as CUDA graphs, freed with
        # this object
        self.graphs = (encode.BodyGraphs() if self.device.type == "cuda"
                       else None)
        self.seconds = defaultdict(float)

    def plan(self, clip: ClipIn) -> MoviePlan:
        """The clip's own plan (memoized by `plan_movie`)."""
        return plan_movie(n_frames=clip.n_source,
                          n_audio_ticks=len(clip.wave), **self._plan_args)[0]

    @contextmanager
    def _timed(self, stage: str):
        t = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[stage] += time.perf_counter() - t

    def targets(self, clips: List[ClipIn], control: bool = False) -> list:
        """Each clip's target banks; the host path's numpy runs a clip a
        thread."""
        with self._timed("targets"):
            if self.path == "device":
                return [self._targets(c, control) for c in clips]
            with ThreadPoolExecutor(len(clips)) as pool:
                return list(pool.map(lambda c: self._targets(c, control),
                                     clips))

    def _targets(self, clip: ClipIn, control: bool) -> tuple:
        if self.path == "device":
            rgb = torch.as_tensor(clip.rgb, device=self.device)
            main, aux = ingest.ingest_device(rgb, self.mode, self.palette,
                                             control)
            return main.cpu().numpy(), aux.cpu().numpy()
        return ingest.ingest_host(np.asarray(clip.rgb), self.mode,
                                  self.palette, control)

    def levels(self, clip: ClipIn, control: bool = False) -> np.ndarray:
        with self._timed("levels"):
            return self._levels(clip, control)

    def _levels(self, clip: ClipIn, control: bool) -> np.ndarray:
        norm = audio.normalization(clip.wave, self.bitrate, self.bitrate)
        n = self.plan(clip).n_ops
        if self.path == "device":
            x = torch.as_tensor(np.asarray(clip.wave, np.float32),
                                device=self.device)
            return audio.levels_device(x, norm, control)[:n].cpu().numpy()
        return audio.levels_host(clip.wave, norm, control)[:n]

    def encode(self, targets: List[tuple], seeds, plan: MoviePlan,
               control: bool = False):
        """Streams' ops and final screens of movies of one plan encoded
        together from their target banks: ([flat ops (n_ops, 6)], main
        (B, 32, 256), aux)."""
        with self._timed("encode"):
            return self._encode(targets, seeds, plan, control)

    def _encode(self, targets: List[tuple], seeds, plan: MoviePlan,
                control: bool):
        main = torch.as_tensor(np.stack([t[0] for t in targets]),
                               device=self.device)
        aux = torch.as_tensor(np.stack([t[1] for t in targets]),
                              device=self.device)
        lanes, bytes_ = encode.target_lanes(main, aux, self.mode)
        ops, fin_main, fin_aux = encode.encode_movies(
            self.dist, lanes, bytes_, plan, self.mode, list(seeds),
            control, self.graphs)
        ops = ops.cpu().numpy()
        return ([flatten_ops(o, plan) for o in ops],
                fin_main.cpu().numpy(), fin_aux.cpu().numpy())

    def encode_each(self, clips: List[ClipIn], targets: List[tuple],
                    control: bool = False) -> list:
        """Each clip's (flat ops, final main, final aux) under its own
        plan: the clips of one plan encoded together, in their order."""
        groups = defaultdict(list)
        for i, c in enumerate(clips):
            groups[(c.n_source, len(c.wave))].append(i)
        out = [None] * len(clips)
        for idx in groups.values():
            flats, main, aux = self.encode(
                [targets[i] for i in idx], [clips[i].seed for i in idx],
                self.plan(clips[idx[0]]), control)
            for n, i in enumerate(idx):
                out[i] = (flats[n], main[n], aux[n])
        return out

    def stream(self, flat: np.ndarray, levels: np.ndarray) -> bytes:
        with self._timed("stream"):
            return frame_stream(flat, levels, self.mode)


def control_outputs(st: Setting, clips: List[ClipIn]) -> List[ClipOut]:
    """The control in the program's place, one precision step down."""
    targets = st.targets(clips, control=True)
    levels = [st.levels(c, control=True) for c in clips]
    encoded = st.encode_each(clips, targets, True)
    return [ClipOut(t, lv, st.stream(f, lv), (main, aux))
            for t, lv, (f, main, aux) in zip(targets, levels, encoded)]


def _bytes_differ(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], np.uint8)
    y = np.frombuffer(b[:n], np.uint8)
    return int((x != y).sum()) + abs(len(a) - len(b))


def judge(st: Setting, clips: List[ClipIn], outs: List[ClipOut],
          numbers) -> dict:
    """{number: value} of the judged side's outputs against the
    reference, for each of `numbers`."""
    n_banks = 2 if st.mode == VideoMode.DHGR else 1
    bad_t = tot_t = bad_l = tot_l = 0
    levels, sources = [], []
    for c, o, want in zip(clips, outs, st.targets(clips)):
        bad_clip = 0
        for b in range(n_banks):
            got = np.asarray(o.targets[b], np.uint8)
            bad_clip += int((got != want[b]).sum()) if got.shape == \
                want[b].shape else want[b].size
            tot_t += want[b].size
        bad_t += bad_clip
        sources.append(o.targets if bad_clip else want)
        lv = st.levels(c)
        got = np.asarray(o.levels)
        bad_l += int((got != lv).sum()) if got.shape == lv.shape \
            else lv.size
        tot_l += lv.size
        levels.append(got if "levels_bad_share" in numbers else lv)
    bad_s = bad_f = 0
    for o, lv, (flat, main, aux) in zip(outs, levels,
                                        st.encode_each(clips, sources)):
        bad_s += _bytes_differ(o.stream, st.stream(flat, lv))
        if "finals_bad_bytes" in numbers:
            for got, want in zip(o.finals, (main, aux)[:n_banks]):
                bad_f += int((np.asarray(got) != want).sum())
    out = {"targets_bad_share": bad_t / max(tot_t, 1),
           "levels_bad_share": bad_l / max(tot_l, 1),
           "stream_bad_bytes": bad_s, "finals_bad_bytes": bad_f}
    return {k: out[k] for k in numbers}


def load_limits(client: str, directory: Optional[str] = None) -> dict:
    with open(os.path.join(directory or LIMITS_DIR, client + ".json")) as f:
        return json.load(f)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= v for k, v in limits.items())

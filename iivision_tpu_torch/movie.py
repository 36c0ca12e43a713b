"""Single-movie transcoder on a torch device (counterpart of
iivision_tpu/movie.py, solo path), DHGR or HGR, with the window, yiq or
mono colour model and the default or joint content rule.

Host ingest (`frames.ingest`, or `frames.ingest_stream_array` for an
in-memory source: C++ resize, quantize and pack), the opcode plan, op
flattening and stream emission run on the host; the encode and the audio
resample run on `device`.  `Movie` picks the encoder as the JAX package's
does: an in-memory source with the ordered dither is ingested inside
`encode_ops` and, past `STREAM_MIN_FRAMES` encoded frames, streamed
through `encoder.encode_movie_streaming`; the rest run
`encoder.encode_movie_chunked` when `chunk_frames` is given or past 1024
encoded frames, else the whole-movie encode.  The final screens are kept
for playback verification.

`Movie.timings` holds the seconds of each stage (`trace.span`, perf
counter): the top-level stages `STAGES` (`frames_s` host ingest, `audio_s`,
`tables_s` the distance model, `levels_s` the audio levels' resample and
copy to the host, `plan_s`, `encode_s`, `flatten_s`, `emit_s`, `write_s`
the file's write), which `transcode` sums into `total_s`; nested in
`encode_s`, `targets_s`, `launch_s` and `wait_s` (see `encoder`), and the
count `body_launches`.  Under the streaming encoder the generator's pulls
are host ingest: they count in `frames_s`, not in `encode_s`.
"""

from typing import Optional

import numpy as np

from iivision_tpu_torch import audio as audio_mod
from iivision_tpu_torch import encoder, frames, require_device
from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.palettes import Palette, require_palette
from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
from iivision_tpu_torch.stream.framing import StreamFramer
from iivision_tpu_torch.stream.opcodes import Header
from iivision_tpu_torch.trace import span
from iivision_tpu_torch.video_mode import VideoMode, require_mode


# In-memory sources with more encoded frames than this take the streaming
# encoder; the rest run one whole-movie encode.  The JAX package's value,
# kept so that both packages pick the same encoder for the same input; the
# output is identical either way.
STREAM_MIN_FRAMES = 256

# the top-level stages of `Movie.timings`, in order; `total_s` is their sum
STAGES = ("frames", "audio", "tables", "levels", "plan", "encode", "flatten",
          "emit", "write")


def get_distance(mode: VideoMode, palette: Palette, model: str = "window",
                 *, device):
    """The encoder's distance model on `device` (store-cost table and
    substitution costs; model 'yiq' or 'mono' for those bases).  One
    model serves every movie of its mode, palette and colour model:
    pass it as `Movie(dist=...)`."""
    return distance.ComputedDistance(mode, palette, model,
                                     device=require_device(device))


class Movie:
    def __init__(
            self,
            filename: Optional[str] = None,
            *,
            device,
            every_n_video_frames: int = 1,
            audio_bitrate: int = 14700,
            audio_normalization: Optional[float] = None,
            max_bytes_out: Optional[int] = None,
            video_mode: VideoMode = VideoMode.DHGR,
            palette: Palette = Palette.NTSC,
            dither_mode: str = "ordered",
            k: int = 8,
            j: int = 1,
            seed: Optional[int] = 0,
            frames_source=None,
            audio_source=None,
            dist=None,
            frame_rate: Optional[float] = None,
            chunk_frames: Optional[int] = None,
            colour_model: str = "window",
            stream_chunk_frames: int = 64,
            joint_content: bool = False,
    ):
        self.device = require_device(device)
        self.every_n_video_frames = every_n_video_frames
        self.max_bytes_out = max_bytes_out
        self.video_mode = require_mode(video_mode)
        self.palette = require_palette(palette)
        # frames per segment of the chunked encoder (None: whole-movie up
        # to 1024 encoded frames, 512 past that) and of the streaming one
        self.chunk_frames = chunk_frames
        self.stream_chunk_frames = stream_chunk_frames
        self.k = k
        self.j = j
        self.seed = seed
        # joint content selection: each op's byte is chosen over all
        # content codes (--joint_content)
        self.joint_content = joint_content
        self.timings = t = {}

        with span("frames", t):
            source = (frames_source if frames_source is not None
                      else filename)
            # an in-memory source with the ordered dither is ingested
            # inside encode_ops (`self.frames` is filled in there), so that
            # the host's quantize can overlap the device's encode
            self._stream_source = None
            if (isinstance(source, np.ndarray) and dither_mode == "ordered"
                    and chunk_frames is None):
                self._stream_source = source
                self.frames = None
                self._n_frames_total = len(source)
                self._input_rate = float(frame_rate or 30.0)
            else:
                self.frames = frames.ingest(
                    source, video_mode, palette,
                    every_n_video_frames=every_n_video_frames,
                    dither_mode=dither_mode, frame_rate=frame_rate)
                self._n_frames_total = self.frames.n_frames_total
                self._input_rate = self.frames.input_frame_rate

        with span("audio", t):
            if audio_source is not None:
                self.audio = audio_source
            else:
                try:
                    self.audio = audio_mod.Audio(
                        filename, bitrate=audio_bitrate,
                        normalization=audio_normalization,
                        device=self.device)
                except Exception:
                    # no audio track: silent stream covering the whole video
                    seconds = self._n_frames_total / self._input_rate
                    self.audio = audio_mod.Audio(
                        data=np.zeros(int(seconds * audio_bitrate) + 1,
                                      np.float32),
                        rate=audio_bitrate, bitrate=audio_bitrate,
                        normalization=1.0, device=self.device)

        with span("tables", t):
            self.dist = dist if dist is not None else get_distance(
                video_mode, palette, colour_model, device=self.device)
            if self.dist.device != self.device:
                raise ValueError("distance model on %s, movie on %s"
                                 % (self.dist.device, self.device))

    def encode_ops(self):
        """Run the encoder; returns (flat ops (n, 6), audio levels (n,))."""
        t = self.timings
        with span("levels", t):
            levels = np.asarray(self.audio.levels())
        with span("plan", t):
            plan, n_enc = encoder.plan_movie(
                n_frames=self._n_frames_total,
                n_audio_ticks=len(levels),
                input_frame_rate=self._input_rate,
                ticks_per_second=self.audio.sample_rate,
                every_n_video_frames=self.every_n_video_frames,
                mode=self.video_mode, k=self.k, j=self.j)
        self.plan = plan
        self.encoder_used = None  # "streaming", "chunked" or "whole"
        enc = dict(seed=self.seed, joint=self.joint_content, into=t)

        if self._stream_source is not None:
            with span("frames", t):
                gen = frames.ingest_stream_array(
                    self._stream_source, self.video_mode, self.palette,
                    every_n_video_frames=self.every_n_video_frames)
            if n_enc > STREAM_MIN_FRAMES:
                # long movie: the host quantizes segment i + 1 while the
                # device encodes segment i; the pulls count as host ingest
                pulled = t["frames_s"]
                with span("encode", t):
                    ops, self.final_main, self.final_aux, tm, ta = \
                        encoder.encode_movie_streaming(
                            self.dist, _pulls(gen, t), plan,
                            self.video_mode,
                            chunk_frames=self.stream_chunk_frames, **enc)
                    gen.close()
                    self._set_frames(tm, ta)
                    self.encoder_used = "streaming"
                t["encode_s"] -= t["frames_s"] - pulled
                return self._flatten(ops, plan), levels[:plan.n_ops]
            # short movie: drain the generator, then encode below
            with span("frames", t):
                parts = list(gen)
                self._set_frames(
                    np.concatenate([m for m, _ in parts]),
                    np.concatenate([a for _, a in parts])
                    if self.video_mode == VideoMode.DHGR else None)

        n_use = max(n_enc, 1)
        if n_use > len(self.frames.targets_main):
            raise ValueError("plan needs %d encoded frames, ingest gave %d"
                             % (n_use, len(self.frames.targets_main)))
        tgt_main = self.frames.targets_main[:n_use]
        tgt_aux = (None if self.frames.targets_aux is None
                   else self.frames.targets_aux[:n_use])
        chunk = self.chunk_frames
        if chunk is not None and chunk <= 0:
            raise ValueError("chunk_frames must be positive, got %r"
                             % (chunk,))
        if chunk is None and n_enc > 1024:
            chunk = 512  # segment long movies
        with span("encode", t):
            if chunk:
                ops, self.final_main, self.final_aux = \
                    encoder.encode_movie_chunked(
                        self.dist, tgt_main, tgt_aux, plan, self.video_mode,
                        chunk_frames=chunk, **enc)
                self.encoder_used = "chunked"
            else:
                with span("encode.targets", t):
                    lanes, bytes_tgt = encoder.prepare_targets(
                        tgt_main, tgt_aux, self.video_mode, self.device)
                ops, fin_main, fin_aux = encoder.encode_movie(
                    self.dist, lanes, bytes_tgt, plan, self.video_mode,
                    **enc)
                with span("encode.wait", t):
                    ops = ops.cpu().numpy()
                    self.final_main = fin_main.cpu().numpy()
                    self.final_aux = fin_aux.cpu().numpy()
                self.encoder_used = "whole"
        return self._flatten(ops, plan), levels[:plan.n_ops]

    def _flatten(self, ops, plan):
        with span("flatten", self.timings):
            return encoder.flatten_ops(ops, plan)

    def _set_frames(self, targets_main, targets_aux):
        self.frames = frames.MovieFrames(
            targets_main=targets_main, targets_aux=targets_aux,
            n_frames_total=self._n_frames_total,
            input_frame_rate=self._input_rate)

    def emit_stream(self):
        """The movie's whole byte stream (header, ticks, ACKs, padding),
        chunk by chunk, through the object-level `StreamFramer`: the same
        bytes `transcode` writes."""
        flat, levels = self.encode_ops()
        framer = StreamFramer(self.video_mode,
                              max_bytes_out=self.max_bytes_out)

        def op_iter():
            yield Header(self.video_mode)
            yield from encoder.ops_to_ticks(flat, levels)

        yield from framer.emit_stream(op_iter())

    def transcode(self, out_path: str) -> dict:
        """Encode to an .a2m file; returns timing stats."""
        flat, levels = self.encode_ops()
        t = self.timings
        data = emit_stream_fast(flat, levels, self.video_mode,
                                max_bytes_out=self.max_bytes_out, into=t)
        with span("write", t):
            with open(out_path, "wb") as f:
                f.write(data)
        n_ops = self.plan.n_ops
        movie_seconds = n_ops / self.audio.sample_rate
        total = sum(t[s + "_s"] for s in STAGES)
        t.update(
            n_ops=n_ops, movie_seconds=movie_seconds, total_s=total,
            realtime_x=movie_seconds / total if total > 0 else 0.0)
        return dict(self.timings)


def _pulls(gen, into: dict):
    """`gen`'s items, each pull timed as host ingest (`frames`)."""
    while True:
        with span("frames", into):
            try:
                item = next(gen)
            except StopIteration:
                return
        yield item

"""Single-movie transcoder on a torch device (counterpart of
iivision_tpu/movie.py, solo path), DHGR or HGR, with the window, yiq or
mono colour model and the default or joint content rule.

Host ingest (`frames.ingest`: decode, C++ resize, quantize and pack), the
opcode plan, op flattening and stream emission run on the host; the
encode and the audio resample run on `device`.  The final screens are kept for playback verification.
"""

import time
from typing import Optional

import numpy as np

from iivision_tpu_torch import audio as audio_mod
from iivision_tpu_torch import encoder, frames, require_device
from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.palettes import Palette, require_palette
from iivision_tpu_torch.stream.emit_fast import emit_stream_fast
from iivision_tpu_torch.video_mode import VideoMode, require_mode


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
            frame_rate: Optional[float] = None,
            colour_model: str = "window",
            joint_content: bool = False,
    ):
        self.device = require_device(device)
        self.every_n_video_frames = every_n_video_frames
        self.max_bytes_out = max_bytes_out
        self.video_mode = require_mode(video_mode)
        self.palette = require_palette(palette)
        self.k = k
        self.j = j
        self.seed = seed
        # joint content selection: each op's byte is chosen over all
        # content codes (--joint_content)
        self.joint_content = joint_content
        self.timings = {}

        t0 = time.time()
        source = frames_source if frames_source is not None else filename
        self.frames = frames.ingest(
            source, video_mode, palette,
            every_n_video_frames=every_n_video_frames,
            dither_mode=dither_mode, frame_rate=frame_rate)
        self.timings["frames_s"] = time.time() - t0

        t0 = time.time()
        if audio_source is not None:
            self.audio = audio_source
        else:
            try:
                self.audio = audio_mod.Audio(
                    filename, bitrate=audio_bitrate,
                    normalization=audio_normalization, device=self.device)
            except Exception:
                # no audio track: silent stream covering the whole video
                seconds = (self.frames.n_frames_total
                           / self.frames.input_frame_rate)
                self.audio = audio_mod.Audio(
                    data=np.zeros(int(seconds * audio_bitrate) + 1,
                                  np.float32),
                    rate=audio_bitrate, bitrate=audio_bitrate,
                    normalization=1.0, device=self.device)
        self.timings["audio_s"] = time.time() - t0

        t0 = time.time()
        self.dist = distance.ComputedDistance(video_mode, palette,
                                              colour_model,
                                              device=self.device)
        self.timings["tables_s"] = time.time() - t0

    def encode_ops(self):
        """Run the encoder; returns (flat ops (n, 6), audio levels (n,))."""
        t0 = time.time()
        levels = np.asarray(self.audio.levels())
        plan, n_enc = encoder.plan_movie(
            n_frames=self.frames.n_frames_total,
            n_audio_ticks=len(levels),
            input_frame_rate=self.frames.input_frame_rate,
            ticks_per_second=self.audio.sample_rate,
            every_n_video_frames=self.every_n_video_frames,
            mode=self.video_mode, k=self.k, j=self.j)
        self.timings["plan_s"] = time.time() - t0

        n_use = max(n_enc, 1)
        if n_use > len(self.frames.targets_main):
            raise ValueError("plan needs %d encoded frames, ingest gave %d"
                             % (n_use, len(self.frames.targets_main)))
        t0 = time.time()
        aux = self.frames.targets_aux
        lanes, bytes_tgt = encoder.prepare_targets(
            self.frames.targets_main[:n_use],
            None if aux is None else aux[:n_use], self.video_mode,
            self.device)
        ops, fin_main, fin_aux = encoder.encode_movie(
            self.dist, lanes, bytes_tgt, plan, self.video_mode,
            seed=self.seed, joint=self.joint_content)
        flat = encoder.flatten_ops(ops.cpu().numpy(), plan)
        self.final_main = fin_main.cpu().numpy()
        self.final_aux = fin_aux.cpu().numpy()
        self.timings["encode_s"] = time.time() - t0
        self.plan = plan
        return flat, levels[:plan.n_ops]

    def transcode(self, out_path: str) -> dict:
        """Encode to an .a2m file; returns timing stats."""
        flat, levels = self.encode_ops()
        t0 = time.time()
        data = emit_stream_fast(flat, levels, self.video_mode,
                                max_bytes_out=self.max_bytes_out)
        with open(out_path, "wb") as f:
            f.write(data)
        self.timings["emit_s"] = time.time() - t0
        n_ops = self.plan.n_ops
        movie_seconds = n_ops / self.audio.sample_rate
        total = sum(self.timings.values())
        self.timings.update(
            n_ops=n_ops, movie_seconds=movie_seconds, total_s=total,
            realtime_x=movie_seconds / total if total > 0 else 0.0)
        return dict(self.timings)

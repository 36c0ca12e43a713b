"""Synthetic clips and audio, the stand-ins for decoded video and sound
(copied from iivision_tpu_torch/bench.py `synth_movies_device` and `tone`;
the phases, and each clip's tone, come from the run's seed).

A clip is a moving RGB pattern at the configuration's source size
(280x192 by default): red a sine along x travelling in time, green a sine
along y, blue a cosine along the diagonal, each shifted by the clip's
phase.  Every phase gives another picture and the same amount of work,
since the encoder's schedule depends only on the clip's length.  A long
clip is rolled copies of a short pattern (`rolled`, `rolled_encoded`).  A
clip's sound is a sine of its own frequency and phase (`tones`); clips of
one length get waves of one length, so the same audio work.
"""

import numpy as np
import torch

SRC_H, SRC_W = 192, 280


def source_size(cfg: dict) -> tuple:
    """(height, width) of a configuration's source frames."""
    return int(cfg["source_height"]), int(cfg["source_width"])


def phases(rng: np.random.Generator, n: int) -> np.ndarray:
    """n clip phases in [0, 2 pi), from the run's generator."""
    return rng.uniform(0.0, 2 * np.pi, size=n)


def synth_movies_device(phase: np.ndarray, F: int, device, h=SRC_H,
                        w=SRC_W) -> torch.Tensor:
    """(B, F, h, w, 3) uint8 frames made on `device` in float32, movie b at
    phase[b]; one movie's float32 temporaries are live at a time."""
    dev = torch.device(device)
    f32 = torch.float32
    t = torch.linspace(0, 1, F, dtype=f32, device=dev)[:, None, None]
    yy = torch.linspace(0, 1, h, dtype=f32, device=dev)[None, :, None]
    xx = torch.linspace(0, 1, w, dtype=f32, device=dev)[None, None, :]
    ph = torch.as_tensor(np.asarray(phase, np.float32), device=dev)
    out = torch.empty((len(phase), F, h, w, 3), dtype=torch.uint8,
                      device=dev)
    for b in range(len(phase)):
        p = ph[b]
        out[b, ..., 0] = 127.5 + 127.5 * torch.sin(7 * (xx + 2 * t) + p)
        out[b, ..., 1] = 255 * torch.abs(torch.sin(3 * (yy + t) + p))
        out[b, ..., 2] = 127.5 + 127.5 * torch.cos(5 * (xx + yy + t) + p)
    return out


def rolled(clip: np.ndarray, copies: int) -> np.ndarray:
    """A long clip of `copies` copies of `clip`, copy i rolled along x by
    35 i + 17 columns (the bench's 80 s soak)."""
    if copies == 1:
        return clip
    return np.concatenate([np.roll(clip, 35 * i + 17, axis=2)
                           for i in range(copies)])


def rolled_encoded(pattern: np.ndarray, n: int, every: int) -> np.ndarray:
    """`rolled(pattern, copies)[:n][::every]`, with as many copies as n
    frames need, made without the frames that every-n-th skipping drops."""
    P = len(pattern)
    copies = -(-n // P)
    src = np.arange(0, n, every)
    copy, idx = np.divmod(src, P)
    out = np.empty((len(src),) + pattern.shape[1:], np.uint8)
    for c in range(copies):
        sel = copy == c
        out[sel] = (pattern[idx[sel]] if copies == 1 else
                    np.roll(pattern[idx[sel]], 35 * c + 17, axis=2))
    return out


def tone(seconds: float, bitrate: int, freq: float) -> np.ndarray:
    """A sine of `freq` Hz sampled at `bitrate`, float32 at amplitude
    16000."""
    n = int(seconds * bitrate)
    return (np.sin(2 * np.pi * freq * np.arange(n) / bitrate)
            * 16000).astype(np.float32)


def tones(rng: np.random.Generator, n: int, seconds: float, bitrate: int,
          hz_range) -> np.ndarray:
    """(n, seconds x bitrate) float32: n sines at amplitude 16000, each at
    a frequency in `hz_range` (low, high) and a phase drawn from the run's
    generator."""
    lo, hi = (float(x) for x in hz_range)
    freq = rng.uniform(lo, hi, size=n)
    phase = rng.uniform(0.0, 2 * np.pi, size=n)
    t = np.arange(int(seconds * bitrate)) / bitrate
    return (np.sin(2 * np.pi * freq[:, None] * t[None, :] + phase[:, None])
            * 16000).astype(np.float32)

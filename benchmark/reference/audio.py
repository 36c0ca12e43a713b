"""Audio levels, plain: 5-bit speaker levels in -15..16, one per stream
tick, from samples already at the tick rate (frozen from
iivision_tpu_torch's `audio.Audio` and the batch path's device levels).

The normalization is the port's: 16384 over the larger magnitude of the
0.5th and 99.5th percentiles of the first 10 MB of mono int16 source's
worth of samples.  The solo path truncates in the host's numpy precision
(float64 once the normalization multiplies), the batch path in float32
on the device.  control=True goes one step down: float32 on the host,
bfloat16 on the device.
"""

import numpy as np
import torch


def normalization(wave: np.ndarray, rate: int, bitrate: int,
                  read_bytes: int = 10 * 1024 * 1024) -> float:
    """The levels' normalization of a signal already at `bitrate`."""
    if rate != bitrate:
        raise ValueError("the reference takes samples at the tick rate")
    max_samples = int(read_bytes // 2 * float(bitrate) / rate)
    a = np.asarray(wave, np.float32)[:max_samples]
    norm = np.max(np.abs(np.percentile(a, [0.5, 99.5])))
    return 1.0 if norm == 0 else 16384.0 / norm


def levels_host(wave: np.ndarray, norm, control: bool = False) -> np.ndarray:
    """The solo path's levels: numpy, truncated toward zero, clipped."""
    a = np.asarray(wave, np.float32)
    if control:
        norm = np.float32(norm)
    lv = np.trunc(a / 16384.0 * norm * 16).astype(np.int32)
    return np.clip(lv, -15, 16)


def levels_device(x: torch.Tensor, norm: float,
                  control: bool = False) -> torch.Tensor:
    """The batch path's levels of float32 samples on their device."""
    if control:
        x = x.to(torch.bfloat16)
    lv = torch.trunc(x / 16384.0 * norm * 16).to(torch.int32)
    return lv.clamp(-15, 16)

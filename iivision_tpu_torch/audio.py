"""Audio resampling on a torch device (counterpart of
iivision_tpu/audio.py `resample_fft`).

Decoding, normalisation, level quantisation and the streaming polyphase
path for long inputs are the shared `iivision_tpu.audio.Audio`; this
module replaces only its one-shot FFT resample, in float32 / complex64
like the JAX version.
"""

import numpy as np
import torch

from iivision_tpu import audio as audio_mod


def resample_fft(x, orig_sr: int, target_sr: float, device) -> torch.Tensor:
    """FFT resampling (scipy.signal.resample semantics) with torch.fft."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    n = x.shape[-1]
    num = int(round(n * float(target_sr) / orig_sr))
    X = torch.fft.rfft(x)
    n_out = num // 2 + 1
    if n_out <= X.shape[-1]:
        Xr = X[..., :n_out]
    else:
        Xr = torch.cat([X, torch.zeros(X.shape[:-1] + (n_out - X.shape[-1],),
                                       dtype=X.dtype, device=X.device)],
                       dim=-1)
    return torch.fft.irfft(Xr, n=num) * (num / n)


class Audio(audio_mod.Audio):
    """`iivision_tpu.audio.Audio` with its FFT resample on `device`."""

    def __init__(self, *args, device, **kwargs):
        self.device = torch.device(device)
        super().__init__(*args, **kwargs)

    def _resample(self) -> np.ndarray:
        if self._resampled is None:
            if self._streaming:
                raise RuntimeError(
                    "streaming Audio does not materialize the resampled "
                    "signal; use levels()")
            if self._rate == self.sample_rate:
                self._resampled = np.asarray(self._data, dtype=np.float32)
            else:
                self._resampled = resample_fft(
                    self._data, self._rate, self.sample_rate,
                    self.device).cpu().numpy()
        return self._resampled

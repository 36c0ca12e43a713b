"""Audio pipeline: decode -> resample -> percentile-normalize -> 5-bit
levels (the port's copy of iivision_tpu/audio.py, with its FFT resample in
torch on a device).

- the target sample rate is 14700 Hz (44100/3) by default, 22500 for //gs
  2.8 MHz playback;
- normalization scales so the 0.5/99.5 percentiles of the head of the
  signal reach full scale;
- levels are int(sample * 16) truncated toward zero and clipped to
  -15..16, each driving one 73-cycle speaker duty-cycle opcode.

Short inputs resample with one FFT (`resample_fft`, float32 / complex64 as
in the JAX version).  Above STREAM_AUTO_SAMPLES, inputs whose rate ratio is
an integer switch to a streaming polyphase decimator on the host (chunked
decode, windowed-sinc FIR with carried history), bit-identical however the
input is chunked.
"""

import functools
import os
import shutil
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

# beyond this many source samples (~6.3 min at 44.1 kHz), integral-ratio
# inputs resample via the streaming polyphase path instead of one FFT
STREAM_AUTO_SAMPLES = 1 << 24
_STREAM_CHUNK = 1 << 21  # source samples per streamed chunk (~47.5 s)


def decode_audio(filename: str) -> Tuple[np.ndarray, int]:
    """Decode an audio (or video) file to mono float32: WAV via scipy,
    anything else via ffmpeg.  Returns (data, rate)."""
    if filename.lower().endswith(".wav"):
        from scipy.io import wavfile
        rate, data = wavfile.read(filename)
        data = data.astype(np.float32)
        if data.ndim == 2:
            data = data.mean(axis=1)
        # normalize integer formats to int16 scale like audioread does
        if data.max() > 2 ** 15 or data.min() < -2 ** 15:
            data = data / (np.ptp(data) / 2 ** 16 + 1e-9)
        return data, int(rate)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not available; only .wav input is supported natively "
            "(or pass raw samples to Audio(data=...))")
    out = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", filename, "-f", "s16le",
         "-ac", "1", "-ar", "44100", "-"],
        check=True, capture_output=True)
    return np.frombuffer(out.stdout, dtype=np.int16).astype(np.float32), 44100


def decode_audio_chunks(filename: str,
                        chunk_samples: int = _STREAM_CHUNK
                        ) -> Iterator[np.ndarray]:
    """Chunked mono float32 decode at the file's native rate: 16-bit WAV
    through the stdlib wave module, anything else from an ffmpeg pipe."""
    if filename.lower().endswith(".wav"):
        import wave
        with wave.open(filename, "rb") as w:
            nch = w.getnchannels()
            if w.getsampwidth() != 2:
                data, _ = decode_audio(filename)
                for i in range(0, len(data), chunk_samples):
                    yield data[i:i + chunk_samples]
                return
            while True:
                raw = w.readframes(chunk_samples)
                if not raw:
                    return
                a = np.frombuffer(raw, np.int16).astype(np.float32)
                if nch > 1:
                    a = a.reshape(-1, nch).mean(axis=1)
                yield a
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not available for %s" % filename)
    cmd = ["ffmpeg", "-v", "error", "-i", filename, "-f", "s16le",
           "-ac", "1", "-ar", "44100", "-"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    ok = False
    try:
        while True:
            raw = proc.stdout.read(chunk_samples * 2)
            if not raw:
                break
            yield np.frombuffer(raw, np.int16).astype(np.float32)
        ok = True
    finally:
        proc.stdout.close()
        rc = proc.wait()
        # a failed decode raises like the one-shot path, once the
        # generator ran to completion
        if ok and rc != 0:
            raise subprocess.CalledProcessError(rc, cmd)


def probe_audio_rate(filename: str) -> int:
    """Native sample rate of a .wav; non-wav decodes at 44100."""
    if filename.lower().endswith(".wav"):
        import wave
        with wave.open(filename, "rb") as w:
            return w.getframerate()
    return 44100


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


@functools.lru_cache(None)
def _decimation_taps(ratio: int, per_branch: int = 48) -> np.ndarray:
    """Windowed-sinc lowpass for decimation by `ratio` (float32, odd
    length, DC gain 1, Kaiser beta 8.6); ratio 1 is the identity."""
    if ratio == 1:
        return np.ones(1, np.float32)
    from scipy.signal import firwin

    taps = firwin(per_branch * ratio + 1, 1.0 / ratio,
                  window=("kaiser", 8.6))
    return taps.astype(np.float32)


class StreamingDecimator:
    """Exact-streaming integer-ratio FIR decimator: output m is dot(h,
    x[m*ratio - half : m*ratio + half + 1]) with zero padding beyond the
    signal, so results are bit-identical however the input is chunked.
    feed() chunks, then flush() with the total length; n_out =
    round(n / ratio)."""

    def __init__(self, ratio: int):
        self.ratio = int(ratio)
        self.h = _decimation_taps(self.ratio)
        self.half = (len(self.h) - 1) // 2
        self.carry = np.zeros(0, np.float32)  # starts at absolute self.start
        self.start = 0
        self.next_m = 0

    def _emit(self, buf: np.ndarray, start: int, m_end: int) -> np.ndarray:
        """Outputs next_m..m_end-1 from buf (absolute start `start`), tap
        by tap in a fixed order so every output sees the same float ops
        under any chunking."""
        n_out = m_end - self.next_m
        if n_out <= 0:
            return np.zeros(0, np.float32)
        first = self.next_m * self.ratio - self.half - start
        acc = np.zeros(n_out, np.float64)
        span = (n_out - 1) * self.ratio + 1
        for k in range(len(self.h)):
            acc += np.float64(self.h[k]) * buf[first + k:
                                               first + k + span:self.ratio]
        self.next_m = m_end
        return acc.astype(np.float32)

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Consume a chunk; return the decimated samples now computable."""
        chunk = np.asarray(chunk, np.float32)
        if self.start == 0 and len(self.carry) == 0:
            # left edge: zero-pad so the first windows exist
            self.carry = np.zeros(self.half, np.float32)
            self.start = -self.half
        buf = np.concatenate([self.carry, chunk])
        end = self.start + len(buf)
        m_end = (end - 1 - self.half) // self.ratio + 1
        out = self._emit(buf, self.start, m_end)
        keep_from = self.next_m * self.ratio - self.half
        drop = max(0, keep_from - self.start)
        self.carry = buf[drop:]
        self.start += drop
        return out

    def flush(self, n_total: int) -> np.ndarray:
        """Zero-pad the right edge and emit through n_out-1."""
        n_out = int(round(n_total / self.ratio))
        if n_out <= self.next_m:
            return np.zeros(0, np.float32)
        pad_to = (n_out - 1) * self.ratio + self.half + 1
        buf = self.carry
        end = self.start + len(buf)
        if pad_to > end:
            buf = np.concatenate([buf, np.zeros(pad_to - end, np.float32)])
        return self._emit(buf, self.start, n_out)


def resample_polyphase(x: np.ndarray, ratio: int) -> np.ndarray:
    """One-shot wrapper over StreamingDecimator (bit-identical to any
    chunked run of the same signal)."""
    d = StreamingDecimator(ratio)
    head = d.feed(np.asarray(x, np.float32))
    return np.concatenate([head, d.flush(len(x))])


class Audio:
    """Audio stream encoder with its FFT resample on `device`.

    Accepts a filename or a raw (data, rate) pair.  `levels()` returns the
    int array of 5-bit speaker levels in -15..16, one per stream tick.
    stream: force (True) or forbid (False) the bounded-memory streaming
    path; None picks it for long inputs with an integral rate ratio."""

    def __init__(self, filename: Optional[str] = None, bitrate: int = 14700,
                 normalization: Optional[float] = None,
                 data: Optional[np.ndarray] = None,
                 rate: Optional[int] = None, stream: Optional[bool] = None,
                 *, device):
        self.device = torch.device(device)
        self.sample_rate = float(bitrate)
        self._filename = None
        if data is not None:
            self._data = np.asarray(data, dtype=np.float32)
            self._rate = int(rate or 44100)
            n_src = len(self._data)
        elif filename is not None:
            self._rate = probe_audio_rate(filename)
            n_src = self._source_length_estimate(filename)
            if self._decide_stream(stream, n_src):
                self._filename = filename
                self._data = None
            else:
                self._data, self._rate = decode_audio(filename)
                n_src = len(self._data)
        else:
            raise ValueError("need filename or data")
        self._streaming = self._decide_stream(stream, n_src)
        if stream and not self._streaming:
            raise ValueError(
                "stream=True needs an integral rate ratio (%s -> %s)"
                % (self._rate, self.sample_rate))
        self._resampled = None
        self._levels = None
        self.normalization = normalization or self._normalization()

    def _ratio_int(self) -> Optional[int]:
        if self._rate == self.sample_rate:
            return 1
        r = self._rate / self.sample_rate
        return int(round(r)) if abs(r - round(r)) < 1e-9 and r > 1 else None

    def _decide_stream(self, stream: Optional[bool], n_src: int) -> bool:
        if self._ratio_int() is None:
            return False
        if stream is not None:
            return stream
        return n_src > STREAM_AUTO_SAMPLES

    @staticmethod
    def _source_length_estimate(filename: str) -> int:
        """Source sample count: exact for wav, size-derived otherwise
        (feeds only the stream-auto threshold)."""
        if filename.lower().endswith(".wav"):
            import wave
            try:
                with wave.open(filename, "rb") as w:
                    return w.getnframes()
            except (OSError, EOFError, wave.Error):
                pass
        # compressed containers: assume >=1:4 vs 16-bit mono 44.1k PCM
        return os.path.getsize(filename) * 2

    def _source_chunks(self) -> Iterator[np.ndarray]:
        if self._data is not None:
            for i in range(0, len(self._data), _STREAM_CHUNK):
                yield self._data[i:i + _STREAM_CHUNK]
            return
        yield from decode_audio_chunks(self._filename)

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

    def _normalization(self, read_bytes: int = 10 * 1024 * 1024):
        """Percentile normalization over the head of the resampled signal:
        the resampled length of 10 MB of mono int16 source."""
        n_src = read_bytes // 2
        max_samples = int(n_src * self.sample_rate / self._rate)
        if self._streaming:
            dec = StreamingDecimator(self._ratio_int())
            parts, got, fed = [], 0, 0
            for chunk in self._source_chunks():
                out = (chunk if dec.ratio == 1 else dec.feed(chunk))
                fed += len(chunk)
                parts.append(out)
                got += len(out)
                if got >= max_samples:
                    break
            if got < max_samples and dec.ratio != 1:
                parts.append(dec.flush(fed))
            a = np.concatenate(parts)[:max_samples] if parts else \
                np.zeros(1, np.float32)
        else:
            a = self._resample()[:max_samples]
        norm = np.max(np.abs(np.percentile(a, [0.5, 99.5])))
        if norm == 0:
            return 1.0
        return 16384.0 / norm

    def _levels_of(self, a: np.ndarray) -> np.ndarray:
        # int() truncation toward zero, then clip
        lv = np.trunc(a / 16384.0 * self.normalization * 16).astype(np.int32)
        return np.clip(lv, -15, 16)

    def levels(self) -> np.ndarray:
        """5-bit speaker levels, one per tick (chunk by chunk, with
        bounded memory, when streaming)."""
        if self._levels is not None:
            return self._levels
        if not self._streaming:
            self._levels = self._levels_of(self._resample())
            return self._levels
        dec = StreamingDecimator(self._ratio_int())
        out, n_src = [], 0
        for chunk in self._source_chunks():
            n_src += len(chunk)
            a = chunk if dec.ratio == 1 else dec.feed(chunk)
            if len(a):
                out.append(self._levels_of(a))
        if dec.ratio != 1:
            tail = dec.flush(n_src)
            if len(tail):
                out.append(self._levels_of(tail))
        self._levels = np.concatenate(out) if out else np.zeros(0, np.int32)
        return self._levels

    @property
    def n_ticks(self) -> int:
        if self._streaming:
            return len(self.levels())
        return len(self._resample())

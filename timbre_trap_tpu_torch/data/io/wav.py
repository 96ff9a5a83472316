"""Host-side audio IO: decode, downmix, resample, normalize (the port's copy
of ``timbre_trap_tpu/data/io/wav.py``).

The reference delegates to torchaudio (``datasets/AudioDataset.py:49-86``).
Here audio loading is numpy-native: WAV via ``scipy.io.wavfile`` (all common
PCM/float encodings), AIFF via the stdlib, and a clear error for compressed
formats (mp3/ogg decode is gated until a native decoder lands). Resampling is
windowed polyphase (``scipy.signal.resample_poly``), which matches
torchaudio's default sinc interpolation quality class.
"""

import os
from fractions import Fraction

import numpy as np
import scipy.io.wavfile
import scipy.signal

__all__ = ["load_audio", "resample_audio", "save_wav"]

_INT_PEAKS = {np.dtype(np.int16): 32768.0,
              np.dtype(np.int32): 2147483648.0,
              np.dtype(np.uint8): 128.0}


def _use_native():
    # The C++ decoder/resampler runs outside the GIL in loader threads;
    # set TT_TPU_NATIVE_AUDIO=0 to force the numpy/scipy path.
    return os.environ.get("TT_TPU_NATIVE_AUDIO", "1") != "0"


def _decode_wav(path):
    fs, data = scipy.io.wavfile.read(path, mmap=False)
    data = np.asarray(data)
    if data.dtype in _INT_PEAKS:
        offset = 128.0 if data.dtype == np.dtype(np.uint8) else 0.0
        data = (data.astype(np.float32) - offset) / _INT_PEAKS[data.dtype]
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    return data.T, fs  # (channels, samples)


def resample_audio(audio, orig_sr, target_sr):
    """Polyphase resampling of (..., N) audio."""
    if orig_sr == target_sr:
        return audio
    frac = Fraction(int(target_sr), int(orig_sr)).limit_denominator(1 << 16)
    return scipy.signal.resample_poly(audio, frac.numerator, frac.denominator,
                                      axis=-1).astype(np.float32)


def load_audio(path, sample_rate=None, mono=True, normalize=True):
    """Load audio as float32 (1, N) in [-1, 1]; optionally resample.

    Matches the reference pipeline: channel-mean downmix, resample,
    infinity-norm normalization (``AudioDataset.py:67-77``).
    """
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".wav", ".wave"):
        if mono and _use_native():
            from . import native

            if native.available():
                try:
                    return native.load_audio_native(
                        path, sample_rate=sample_rate, normalize=normalize)
                except RuntimeError:
                    pass  # fall back to the numpy decoder
        audio, fs = _decode_wav(path)
    elif ext == ".mp3":
        from . import native

        if not native.mp3_available():
            raise ValueError(
                "mp3 decode requires the native loader + system libmpg123; "
                "neither a pure-numpy fallback nor another decoder exists")
        # Native path already downmixes/resamples/normalizes in C++.
        audio, fs = native.load_mp3_native(
            path, sample_rate=sample_rate, normalize=normalize)
        if not mono:
            raise ValueError("mp3 decode is mono-only (dataset pipeline "
                             "downmixes anyway, AudioDataset.py:67-70)")
        return audio.astype(np.float32), fs
    else:
        raise ValueError(
            f"unsupported audio format {ext!r} (native decoders beyond "
            f"WAV/MP3 are gated in this environment)")
    if mono:
        audio = np.mean(audio, axis=0, keepdims=True)
    if sample_rate is not None and fs != sample_rate:
        audio = resample_audio(audio, fs, sample_rate)
        fs = sample_rate
    if normalize:
        peak = np.abs(audio).max()
        if peak > 0:
            audio = audio / peak
    return audio.astype(np.float32), fs


def save_wav(path, audio, sample_rate):
    """Write float32 (C, N) or (N,) audio to a 16-bit PCM WAV file."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        audio = audio.T  # scipy expects (N, C)
    clipped = np.clip(audio, -1.0, 1.0)
    scipy.io.wavfile.write(path, int(sample_rate),
                           (clipped * 32767.0).astype(np.int16))

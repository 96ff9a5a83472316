"""Audio dataset layer (the port's copy of ``timbre_trap_tpu/data/audio.py``;
reference: timbre_trap/datasets/AudioDataset.py).

Adds audio loading (decode -> mono -> resample -> infinity-norm normalize,
with per-sample error degradation to empty audio, :49-86) and random/fixed
excerpting with two-sided zero padding of short audio (:88-143).
"""

from abc import abstractmethod

import numpy as np

from . import constants
from .base import BaseDataset
from .io.wav import load_audio

__all__ = ["AudioDataset"]


class AudioDataset(BaseDataset):
    """Dataset with audio tracks."""

    def __init__(self, sample_rate=16000, **kwargs):
        BaseDataset.__init__(self, **kwargs)
        self.sample_rate = sample_rate

    @abstractmethod
    def get_audio_path(self, track):
        """Path to a track's audio file."""

    def get_audio(self, track):
        """Load a track's audio as float32 (1, N); errors degrade to empty."""
        audio_path = self.get_audio_path(track)
        try:
            audio, _ = load_audio(audio_path, sample_rate=self.sample_rate,
                                  mono=True, normalize=True)
        except Exception as e:  # noqa: BLE001 — parity: degrade per sample
            print(f"Error loading track '{track}': {repr(e)}")
            audio = np.empty((1, 0), dtype=np.float32)
        return audio

    def slice_audio(self, audio, n_samples=None, offset_s=None):
        """Slice audio to ``n_samples``; short audio is zero-padded two-sided.

        Returns (audio, offset_t) where ``offset_t`` is the slice offset in
        seconds (negative when padding was added on the left).
        """
        if n_samples is None:
            n_samples = int(self.n_secs * self.sample_rate)

        length = audio.shape[-1]
        if length >= n_samples:
            if offset_s is None:
                start = self.rng.randint(0, length - n_samples + 1)
            else:
                start = offset_s
            offset_t = start / self.sample_rate
            audio = audio[..., start:start + n_samples]
        else:
            pad_total = n_samples - length
            if offset_s is None:
                pad_left = self.rng.randint(0, pad_total)
            else:
                pad_left = abs(offset_s)
            offset_t = -pad_left / self.sample_rate
            widths = [(0, 0)] * (audio.ndim - 1) + [(pad_left, pad_total - pad_left)]
            audio = np.pad(audio, widths)
        return audio, offset_t

    def __getitem__(self, index, offset_s=None):
        track = self.tracks[index]
        audio = self.get_audio(track)
        if self.n_secs is not None:
            audio, _ = self.slice_audio(audio, offset_s=offset_s)
        return {constants.KEY_TRACK: track, constants.KEY_AUDIO: audio}

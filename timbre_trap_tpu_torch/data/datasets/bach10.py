"""Bach10 dataset wrappers (reference: datasets/Common/Bach10.py,
MixedMultiPitch/Bach10.py, SoloMultiPitch/Bach10.py).

The port's copy of ``timbre_trap_tpu/data/datasets/bach10.py``.

Ground truth is a ``<track>-GTF0s.mat`` matrix of per-instrument MIDI
pitches on a 10 ms grid starting at 23 ms.
"""

import os

import numpy as np
import scipy.io

from ..base import BaseDataset
from ..mpe import MPEDataset
from ...transform.design import midi_to_hz

__all__ = ["Bach10Common", "Bach10Mixtures", "Bach10Stems"]


class Bach10Common(BaseDataset):
    """Top-level Bach10 wrapper: splits are two-digit piece numbers."""

    @classmethod
    def name(cls):
        return "Bach10"

    @staticmethod
    def available_splits():
        return [f"{i:02d}" for i in range(1, 11)]

    @classmethod
    def download(cls, save_dir):
        raise NotImplementedError("Bach10 must be downloaded manually")


def _load_gtf0s(mat_path):
    """(times, (instruments x frames) MIDI pitch matrix) from a GTF0s file."""
    multi_pitch = scipy.io.loadmat(mat_path)["GTF0s"]
    times = 0.023 + 0.010 * np.arange(multi_pitch.shape[-1])
    return times, multi_pitch


class Bach10Mixtures(MPEDataset, Bach10Common):
    """Full Bach10 mixtures with all instruments' F0s merged."""

    def get_tracks(self, split):
        return [d for d in os.listdir(self.base_dir) if d.startswith(split)]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, track, f"{track}.wav")

    def get_ground_truth_path(self, track):
        return os.path.join(self.base_dir, track, f"{track}-GTF0s.mat")

    def get_ground_truth(self, track):
        times, multi_pitch = _load_gtf0s(self.get_ground_truth_path(track))
        pitches = [midi_to_hz(p[p != 0]) for p in multi_pitch.T]
        return times, pitches


class Bach10Stems(MPEDataset, Bach10Common):
    """Individual Bach10 stems; tracks are ``<NN>-<piece>-<instrument>``."""

    INSTRUMENTS = ["violin", "clarinet", "saxphone", "bassoon"]

    def get_tracks(self, split):
        names = [d for d in os.listdir(self.base_dir) if d.startswith(split)]
        if not names:  # piece not present (partial corpus)
            return []
        return [f"{names[0]}-{ins}" for ins in self.INSTRUMENTS]

    def get_audio_path(self, track):
        n, mix, _ = track.split("-")
        return os.path.join(self.base_dir, f"{n}-{mix}", f"{track}.wav")

    def get_ground_truth_path(self, track):
        n, mix, _ = track.split("-")
        return os.path.join(self.base_dir, f"{n}-{mix}", f"{n}-{mix}-GTF0s.mat")

    def get_ground_truth(self, track):
        times, multi_pitch = _load_gtf0s(self.get_ground_truth_path(track))
        instrument_idx = self.INSTRUMENTS.index(track.split("-")[-1])
        row = multi_pitch[instrument_idx]
        pitches = [midi_to_hz(np.array([p])) if p != 0 else np.empty(0)
                   for p in row]
        return times, pitches

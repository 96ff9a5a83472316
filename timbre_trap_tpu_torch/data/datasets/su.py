"""Su dataset wrapper (reference: datasets/MixedMultiPitch/Su.py).

The port's copy of ``timbre_trap_tpu/data/datasets/su.py``.

Note-level ground truth: ``gt_Note/<track>_note.txt`` rows of
``onset offset frequency_hz``.
"""

import os

import numpy as np

from ..amt import AMTDataset
from ...transform.design import hz_to_midi

__all__ = ["Su"]


class Su(AMTDataset):
    """Classical chamber recordings with note annotations."""

    @staticmethod
    def available_splits():
        return ["PQ02", "PQ03", "PS01", "PS02", "PS03",
                "SQ01", "SQ02", "SQ03", "VS01", "VS04"]

    def get_tracks(self, split):
        audio_dir = os.path.join(self.base_dir, "audio")
        return [d.replace("_audio.wav", "") for d in os.listdir(audio_dir)
                if d.startswith(split)]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, "audio", f"{track}_audio.wav")

    def get_ground_truth_path(self, track):
        return os.path.join(self.base_dir, "gt_Note", f"{track}_note.txt")

    def get_ground_truth(self, track):
        notes = np.loadtxt(self.get_ground_truth_path(track), ndmin=2)
        pitches = hz_to_midi(notes[:, -1])
        intervals = notes[:, :2]
        return pitches, intervals

    @classmethod
    def download(cls, save_dir):
        raise NotImplementedError("Su must be downloaded manually")

"""URMP dataset wrappers (reference: datasets/Common/URMP.py,
MixedMultiPitch/URMP.py, SoloMultiPitch/URMP.py).

The port's copy of ``timbre_trap_tpu/data/datasets/urmp.py``.

Track layout: ``<base>/<NN>_<piece>_<ins1>_<ins2>.../AuMix_*.wav`` mixtures,
``AuSep_<i>_<ins>_<NN>_<piece>.wav`` stems, ``F0s_*`` frame-level F0 text
annotations (10 ms grid).
"""

import os

import numpy as np

from ..base import BaseDataset
from ..download import stream_url_resource, unzip_and_remove, change_base_dir
from ..mpe import MPEDataset

__all__ = ["URMPCommon", "URMPMixtures", "URMPStems"]


class URMPCommon(BaseDataset):
    """Top-level URMP wrapper: splits are two-digit piece numbers."""

    @classmethod
    def name(cls):
        return "URMP"

    @staticmethod
    def available_splits():
        return [f"{i:02d}" for i in range(1, 45)]

    @classmethod
    def download(cls, save_dir):
        BaseDataset.download(save_dir)
        url = "https://datadryad.org/stash/downloads/file_stream/99348"
        tar_path = os.path.join(save_dir, "URMP.tar.gz")
        stream_url_resource(url, tar_path)
        unzip_and_remove(tar_path, tar=True)
        change_base_dir(save_dir, os.path.join(save_dir, "Dataset"))


def _read_f0_txt(txt_path):
    """Read a URMP F0 annotation file -> (times, pitch column)."""
    data = np.loadtxt(txt_path)
    return data[:, 0], data[:, 1]


class URMPMixtures(MPEDataset, URMPCommon):
    """Full URMP mixtures with merged per-instrument F0 annotations."""

    def get_tracks(self, split):
        return [d for d in os.listdir(self.base_dir) if d.startswith(split)]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, track, f"AuMix_{track}.wav")

    def get_ground_truth_path(self, track, instrument):
        track_dir = os.path.join(self.base_dir, track)
        anno_file = [f for f in os.listdir(track_dir)
                     if f.startswith(f"F0s_{instrument}")][0]
        return os.path.join(track_dir, anno_file)

    def get_ground_truth(self, track):
        instruments = [(i + 1) for i in range(len(track.split("_")[2:]))]
        times, pitch_rows = None, []
        for instrument in instruments:
            _times, _pitches = _read_f0_txt(
                self.get_ground_truth_path(track, instrument))
            if times is None:
                times = _times
            elif not np.allclose(times, _times):
                raise ValueError(f"misaligned annotation times in {track}")
            pitch_rows.append(_pitches)
        pitch_rows = np.stack(pitch_rows, axis=0)
        pitches = [p[p != 0] for p in pitch_rows.T]
        return times, pitches


class URMPStems(MPEDataset, URMPCommon):
    """Individual URMP stems; tracks are ``<mixture>/<stem-suffix>``."""

    def get_tracks(self, split):
        names = [d for d in os.listdir(self.base_dir) if d.startswith(split)]
        if not names:  # piece not present (partial corpus)
            return []
        name = names[0]
        track_files = os.listdir(os.path.join(self.base_dir, name))
        tracks = [os.path.join(name, f) for f in track_files
                  if f.startswith("AuSep")]
        return [os.path.splitext(t)[0].replace("AuSep_", "") for t in tracks]

    def get_audio_path(self, track):
        mixture, stem = os.path.split(track)
        return os.path.join(self.base_dir, mixture, f"AuSep_{stem}.wav")

    def get_ground_truth_path(self, track):
        mixture, stem = os.path.split(track)
        return os.path.join(self.base_dir, mixture, f"F0s_{stem}.txt")

    def get_ground_truth(self, track):
        times, pitch_col = _read_f0_txt(self.get_ground_truth_path(track))
        pitches = [np.array([p]) if p != 0 else np.empty(0) for p in pitch_col]
        return times, pitches

"""MusicNet dataset wrappers (reference: datasets/Common/MusicNet.py,
MixedMultiPitch/MusicNet.py, SoloMultiPitch/MusicNet.py).

The port's copy of ``timbre_trap_tpu/data/datasets/musicnet.py``.

CSV note labels in samples at 44.1 kHz; the Solo variant keeps only tracks
with a single instrument class.
"""

import csv
import os

import numpy as np

from ..amt import AMTDataset
from ..download import stream_url_resource, unzip_and_remove, change_base_dir

__all__ = ["MusicNetCommon", "MusicNetMixtures", "MusicNetSolo"]


class MusicNetCommon(AMTDataset):
    """Top-level MusicNet wrapper: train/test splits of chamber recordings."""

    LABEL_RATE = 44100

    @classmethod
    def name(cls):
        return "MusicNet"

    @staticmethod
    def available_splits():
        return ["train", "test"]

    def get_tracks(self, split):
        tracks = os.listdir(os.path.join(self.base_dir, f"{split}_data"))
        return sorted(os.path.join(split, os.path.splitext(t)[0])
                      for t in tracks)

    def get_audio_path(self, track):
        split, name = os.path.split(track)
        return os.path.join(self.base_dir, f"{split}_data", f"{name}.wav")

    def get_ground_truth_path(self, track):
        split, name = os.path.split(track)
        return os.path.join(self.base_dir, f"{split}_labels", f"{name}.csv")

    def _read_label_rows(self, track):
        with open(self.get_ground_truth_path(track), newline="") as fh:
            return list(csv.DictReader(fh))

    def get_ground_truth(self, track):
        rows = self._read_label_rows(track)
        onsets = np.array([int(r["start_time"]) for r in rows], np.float64)
        offsets = np.array([int(r["end_time"]) for r in rows], np.float64)
        pitches = np.array([int(r["note"]) for r in rows], np.float64)
        intervals = np.stack([onsets, offsets], axis=-1) / self.LABEL_RATE
        return pitches, intervals

    @classmethod
    def download(cls, save_dir):
        AMTDataset.download(save_dir)
        base = "https://zenodo.org/record/5120004/files"
        for name, tar in (("musicnet.tar.gz", True),
                          ("musicnet_midis.tar.gz", True)):
            path = os.path.join(save_dir, name)
            stream_url_resource(f"{base}/{name}", path)
            unzip_and_remove(path, tar=tar)
        change_base_dir(save_dir, os.path.join(save_dir, "musicnet"))
        meta_path = os.path.join(save_dir, "musicnet_metadata.csv")
        stream_url_resource(f"{base}/musicnet_metadata.csv", meta_path)


class MusicNetMixtures(MusicNetCommon):
    """All MusicNet tracks (full recordings)."""


class MusicNetSolo(MusicNetCommon):
    """Only tracks whose labels contain a single instrument class."""

    def get_tracks(self, split):
        tracks = super().get_tracks(split)
        solo = []
        for t in tracks:
            rows = self._read_label_rows(t)
            instruments = {int(r["instrument"]) for r in rows}
            if len(instruments) <= 1:
                solo.append(t)
        return solo

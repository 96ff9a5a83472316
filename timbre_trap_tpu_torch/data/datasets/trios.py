"""TRIOS dataset wrappers (reference: datasets/Common/TRIOS.py,
MixedMultiPitch/TRIOS.py, SoloMultiPitch/TRIOS.py).

The port's copy of ``timbre_trap_tpu/data/datasets/trios.py``.

Per-multitrack directories with ``mix.wav``, per-instrument stems and
``<instrument>.mid`` note annotations.
"""

import os

import numpy as np

from ..amt import AMTDataset
from ..download import stream_url_resource, unzip_and_remove, change_base_dir
from ..io.midi import load_notes_midi

__all__ = ["TRIOSCommon", "TRIOSMixtures", "TRIOSStems"]


class TRIOSCommon(AMTDataset):
    """Top-level TRIOS wrapper: splits are multitrack names."""

    PITCHED_INSTRUMENTS = ["horn", "piano", "violin", "bassoon", "trumpet",
                           "clarinet", "viola", "cello", "saxophone"]

    @classmethod
    def name(cls):
        return "TRIOS"

    @staticmethod
    def available_splits():
        return ["brahms", "lussier", "mozart", "schubert", "take_five"]

    @classmethod
    def download(cls, save_dir):
        AMTDataset.download(save_dir)
        url = "https://zenodo.org/record/6797837/files/TRIOS Dataset.zip"
        zip_path = os.path.join(save_dir, os.path.basename(url))
        stream_url_resource(url, zip_path)
        unzip_and_remove(zip_path)
        change_base_dir(save_dir, os.path.join(save_dir, "TRIOS Dataset"))


class TRIOSMixtures(TRIOSCommon):
    """Multitrack mixtures with all pitched instruments' notes merged."""

    def get_tracks(self, split):
        return [split]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, track, "mix.wav")

    def get_ground_truth_path(self, track, instrument):
        return os.path.join(self.base_dir, track, f"{instrument}.mid")

    def get_ground_truth(self, track):
        all_files = os.listdir(os.path.join(self.base_dir, track))
        instruments = [os.path.splitext(i)[0] for i in all_files
                       if i.endswith(".mid")]
        valid = [i for i in instruments if i in self.PITCHED_INSTRUMENTS]

        pitches, intervals = np.empty(0), np.empty((0, 2))
        for instrument in valid:
            p, _, iv = load_notes_midi(
                self.get_ground_truth_path(track, instrument))
            pitches = np.append(pitches, p)
            intervals = np.append(intervals, iv, axis=0)
        return pitches, intervals


class TRIOSStems(TRIOSCommon):
    """Individual pitched-instrument stems; tracks are ``<multitrack>/<ins>``."""

    def get_tracks(self, split):
        all_files = os.listdir(os.path.join(self.base_dir, split))
        instruments = [os.path.splitext(i)[0] for i in all_files
                       if i.endswith(".mid")]
        return [os.path.join(split, i) for i in instruments
                if i in self.PITCHED_INSTRUMENTS]

    def get_audio_path(self, track):
        multitrack, instrument = os.path.split(track)
        return os.path.join(self.base_dir, multitrack, f"{instrument}.wav")

    def get_ground_truth_path(self, track):
        multitrack, instrument = os.path.split(track)
        return os.path.join(self.base_dir, multitrack, f"{instrument}.mid")

    def get_ground_truth(self, track):
        pitches, _, intervals = load_notes_midi(self.get_ground_truth_path(track))
        return pitches, intervals

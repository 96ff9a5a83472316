"""GuitarSet dataset wrapper (reference: datasets/SoloMultiPitch/GuitarSet.py).

The port's copy of ``timbre_trap_tpu/data/datasets/guitarset.py``.

Per-string ``pitch_contour`` annotations from JAMS files (plain JSON —
parsed directly, no jams dependency) aligned onto a uniform 256/44100-second
grid; ``resample_idcs=[0, 0]`` prevents extending the last pitch beyond the
annotated range.
"""

import json
import os

import numpy as np

from ..download import stream_url_resource, unzip_and_remove
from ..mpe import MPEDataset

__all__ = ["GuitarSet"]


class GuitarSet(MPEDataset):
    """Solo acoustic guitar with hexaphonic pitch annotations."""

    SAMPLING_RATE = 44100
    HOP_LENGTH = 256

    def __init__(self, **kwargs):
        resample_idcs = kwargs.pop("resample_idcs", None)
        if resample_idcs is None:
            # Do not extend pitches beyond the annotation boundaries.
            resample_idcs = [0, 0]
        kwargs["resample_idcs"] = resample_idcs
        super().__init__(**kwargs)

    @staticmethod
    def available_splits():
        return ["00", "01", "02", "03", "04", "05"]

    def get_tracks(self, split):
        jams_files = os.listdir(os.path.join(self.base_dir, "annotation"))
        return [os.path.splitext(t)[0] for t in jams_files if t.startswith(split)]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, "audio_mono-mic", f"{track}_mic.wav")

    def get_ground_truth_path(self, track):
        return os.path.join(self.base_dir, "annotation", f"{track}.jams")

    @staticmethod
    def load_pitches_jams(jams_path):
        """Collect all pitch_contour observations onto a uniform time grid."""
        with open(jams_path) as fh:
            jam = json.load(fh)

        slices = [a for a in jam.get("annotations", [])
                  if a.get("namespace") == "pitch_contour"]
        duration = jam["file_metadata"]["duration"]

        hop_length_s = GuitarSet.HOP_LENGTH / GuitarSet.SAMPLING_RATE
        num_entries = int(np.ceil(duration / hop_length_s)) + 1
        times = hop_length_s * np.arange(num_entries)
        pitches = [np.array([])] * num_entries

        for annotation in slices:
            for obs in annotation.get("data", []):
                value = obs["value"]
                freq = np.array([value["frequency"]])
                if np.sum(freq) == 0 or not value.get("voiced", True):
                    freq = np.empty(0)
                closest_idx = int(np.argmin(np.abs(times - obs["time"])))
                pitches[closest_idx] = np.append(pitches[closest_idx], freq)
        return times, pitches

    def get_ground_truth(self, track):
        return self.load_pitches_jams(self.get_ground_truth_path(track))

    @classmethod
    def download(cls, save_dir):
        MPEDataset.download(save_dir)
        for name in ("annotation", "audio_mono-mic"):
            url = f"https://zenodo.org/record/3371780/files/{name}.zip"
            target_dir = os.path.join(save_dir, name)
            os.makedirs(target_dir)
            zip_path = os.path.join(target_dir, os.path.basename(url))
            stream_url_resource(url, zip_path)
            unzip_and_remove(zip_path)

"""MAESTRO V3 dataset wrapper (reference: datasets/SoloMultiPitch/MAESTRO.py).

The port's copy of ``timbre_trap_tpu/data/datasets/maestro.py``.

CSV split table + per-performance ``.midi`` note annotations parsed with the
in-repo MIDI reader (sustain-pedal extension handled by
``data.io.midi.load_notes_midi``).
"""

import csv
import os

from ..amt import AMTDataset
from ..download import stream_url_resource, unzip_and_remove, change_base_dir
from ..io.midi import load_notes_midi

__all__ = ["MAESTRO"]


class MAESTRO(AMTDataset):
    """Solo-piano performances with aligned MIDI."""

    @staticmethod
    def available_splits():
        return ["train", "validation", "test"]

    def get_tracks(self, split):
        csv_path = os.path.join(self.base_dir, "maestro-v3.0.0.csv")
        tracks = []
        with open(csv_path, newline="") as fh:
            for row in csv.DictReader(fh):
                if row["split"] == split:
                    tracks.append(os.path.splitext(row["audio_filename"])[0])
        return sorted(tracks)

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, f"{track}.wav")

    def get_ground_truth_path(self, track):
        return os.path.join(self.base_dir, f"{track}.midi")

    # Expose the note parser under the reference's name for reuse by TRIOS.
    load_notes_midi = staticmethod(load_notes_midi)

    def get_ground_truth(self, track):
        pitches, _, intervals = load_notes_midi(self.get_ground_truth_path(track))
        return pitches, intervals

    @classmethod
    def download(cls, save_dir):
        AMTDataset.download(save_dir)
        url = ("https://storage.googleapis.com/magentadata/datasets/maestro/"
               "v3.0.0/maestro-v3.0.0.zip")
        zip_path = os.path.join(save_dir, os.path.basename(url))
        stream_url_resource(url, zip_path)
        unzip_and_remove(zip_path)
        change_base_dir(save_dir, os.path.join(save_dir, "maestro-v3.0.0"))

"""MedleyDB dataset family (reference: datasets/Common/MedleyDB.py,
AudioMixtures/MedleyDB.py, AudioStems/MedleyDB.py,
SoloMultiPitch/MedleyDB_Pitch.py, SoloMultiPitch/MedleyDB_Stem_Synth.py).

The port's copy of ``timbre_trap_tpu/data/datasets/medleydb.py``.

YAML multitrack metadata drives genre/instrument splits; the Pitch-Tracking
and Stem-Synth subsets carry per-track CSV F0 annotations. PyYAML is imported
where the metadata is read, so the package imports without it; a wrapper that
reads YAML metadata raises its ``ImportError`` there.
"""

import json
import os

import numpy as np

from .. import constants
from ..audio import AudioDataset
from ..base import BaseDataset
from ..download import stream_url_resource, unzip_and_remove, change_base_dir
from ..mpe import MPEDataset

__all__ = ["MedleyDBCommon", "MedleyDBMixtures", "MedleyDBStems",
           "MedleyDB_Pitch", "MedleyDB_Stem_Synth"]

# Pitched-instrument subset used for stem selection (reference
# AudioStems/MedleyDB.py:14-133; abbreviated to entries present in V1/V2).
PITCHED_INSTRUMENTS = [
    "erhu", "violin", "viola", "cello", "double bass", "violin section",
    "viola section", "cello section", "string section", "dilruba",
    "acoustic guitar", "banjo", "guzheng", "harp", "liuqin", "mandolin",
    "oud", "zhongruan", "sitar", "yangqin", "piano", "tack piano", "dizi",
    "flute", "flute section", "piccolo", "bamboo flute", "alto saxophone",
    "baritone saxophone", "bass clarinet", "clarinet", "clarinet section",
    "tenor saxophone", "soprano saxophone", "oboe", "bassoon", "trumpet",
    "cornet", "trombone", "french horn", "euphonium", "tuba",
    "brass section", "french horn section", "trombone section",
    "horn section", "trumpet section", "harmonica", "accordion", "melodica",
    "male singer", "female singer", "male speaker", "female speaker",
    "male rapper", "vocalists", "choir", "crowd", "male screamer", "chimes",
    "vibraphone", "glockenspiel", "whistle", "timpani",
    "clean electric guitar", "distorted electric guitar", "electric bass",
    "lap steel guitar", "drum machine", "electric piano", "electronic organ",
    "synthesizer", "fx/processed sound", "scratches", "sampler",
    "woodwind section",
]

GENRES = ["Classical", "Electronic/Fusion", "Jazz", "Musical Theatre",
          "Pop", "Rap", "Rock", "Singer/Songwriter", "World/Folk"]

# Pitched solo instruments of the Pitch-Tracking subset
# (reference SoloMultiPitch/MedleyDB_Pitch.py:44-75).
PITCH_SUBSET_INSTRUMENTS = [
    "erhu", "violin", "viola", "cello", "double bass", "dizi", "flute",
    "piccolo", "bamboo flute", "alto saxophone", "baritone saxophone",
    "bass clarinet", "clarinet", "tenor saxophone", "soprano saxophone",
    "oboe", "trumpet", "french horn", "male singer", "female singer",
    "electric bass",
]


class MedleyDBCommon(AudioDataset):
    """Top-level MedleyDB wrapper holding YAML multitrack metadata."""

    def __init__(self, **kwargs):
        base_dir = kwargs.pop("base_dir", None)
        if base_dir is None:
            base_dir = os.path.join(constants.DEFAULT_LOCATION, self.name())
        self.base_dir = base_dir
        self.metadata = None
        self.load_metadata()
        kwargs["base_dir"] = self.base_dir
        AudioDataset.__init__(self, **kwargs)

    @classmethod
    def name(cls):
        return "MedleyDB"

    def load_metadata(self):
        import yaml

        self.metadata = {}
        for multitrack in self.available_multitracks():
            yaml_path = os.path.join(self.base_dir, "Metadata",
                                     f"{multitrack}_METADATA.yaml")
            with open(yaml_path) as fh:
                self.metadata[multitrack] = yaml.safe_load(fh)

    def available_multitracks(self):
        audio_dir = os.path.join(self.base_dir, "Audio")
        return [d for d in os.listdir(audio_dir)
                if os.path.isdir(os.path.join(audio_dir, d))
                and not d.startswith("Bach10")]

    @staticmethod
    def available_genres():
        return list(GENRES)

    @staticmethod
    def available_instruments():
        return list(PITCHED_INSTRUMENTS)

    @classmethod
    def download(cls, save_dir):
        raise NotImplementedError(
            "MedleyDB requires requesting access; download manually")


class MedleyDBMixtures(MedleyDBCommon):
    """Audio-only full mixtures, split by genre."""

    @staticmethod
    def available_splits():
        return list(GENRES)

    def get_tracks(self, split):
        return [m for m in self.metadata
                if self.metadata[m]["genre"] == split]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, "Audio", track, f"{track}_MIX.wav")


class MedleyDBStems(MedleyDBCommon):
    """Audio-only raw stems, split by (pitched) instrument."""

    @staticmethod
    def available_splits():
        return list(PITCHED_INSTRUMENTS)

    def get_tracks(self, split):
        tracks = []
        for multitrack in self.metadata:
            for stem in self.metadata[multitrack]["stems"].values():
                for raw_audio in stem["raw"].values():
                    if split == raw_audio["instrument"]:
                        tracks.append(os.path.join(
                            multitrack,
                            os.path.splitext(raw_audio["filename"])[0]))
        return tracks

    def get_audio_path(self, track):
        mixture, stem = os.path.split(track)
        return os.path.join(self.base_dir, "Audio", mixture,
                            f"{mixture}_RAW", f"{stem}.wav")


class MedleyDB_Pitch(MPEDataset):
    """MedleyDB Pitch-Tracking subset: solo stems with CSV F0 annotations."""

    def __init__(self, **kwargs):
        resample_idcs = kwargs.pop("resample_idcs", None)
        if resample_idcs is None:
            resample_idcs = [0, 0]
        base_dir = kwargs.pop("base_dir", None)
        if base_dir is None:
            base_dir = os.path.join(constants.DEFAULT_LOCATION, self.name())
        self.base_dir = base_dir
        self.metadata = None
        self.load_metadata()
        kwargs.update({"resample_idcs": resample_idcs, "base_dir": base_dir})
        MPEDataset.__init__(self, **kwargs)

    @classmethod
    def name(cls):
        return "MedleyDB-Pitch"

    def load_metadata(self):
        json_path = os.path.join(self.base_dir, "medleydb_pitch_metadata.json")
        with open(json_path) as fh:
            self.metadata = json.load(fh)

    @staticmethod
    def available_instruments():
        return list(PITCH_SUBSET_INSTRUMENTS)

    @staticmethod
    def available_splits():
        return list(PITCH_SUBSET_INSTRUMENTS)

    def get_tracks(self, split):
        return [t for t in self.metadata
                if split in self.metadata[t]["instrument"]]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, "audio", f"{track}.wav")

    def get_ground_truth_path(self, track):
        return os.path.join(self.base_dir, "pitch", f"{track}.csv")

    def get_ground_truth(self, track):
        data = np.loadtxt(self.get_ground_truth_path(track), delimiter=",",
                          ndmin=2)
        times, pitch_col = data[:, 0], data[:, 1]
        pitches = [np.array([p]) if p != 0 else np.empty(0) for p in pitch_col]
        return times, pitches

    @classmethod
    def download(cls, save_dir):
        raise NotImplementedError(
            "MedleyDB-Pitch requires requesting access; download manually")


class MedleyDB_Stem_Synth(MedleyDB_Pitch):
    """Re-synthesized (perfect F0) MedleyDB stems."""

    @classmethod
    def name(cls):
        return "MedleyDB-Stem-Synth"

    def load_metadata(self):
        # Reuse the top-level YAML metadata, pruned to available stems.
        MedleyDBCommon.load_metadata(self)
        for multitrack in self.metadata:
            stems = [s.split("_STEM_")[-1].split(".")[0]
                     for s in self.available_stems()
                     if s.startswith(multitrack)]
            all_stems = list(self.metadata[multitrack]["stems"].keys())
            for k in all_stems:
                if k[1:] not in stems:
                    self.metadata[multitrack]["stems"].pop(k)

    # MedleyDBCommon.load_metadata needs these two:
    def available_multitracks(self):
        stems = self.available_stems()
        return sorted({anno.split("_STEM_")[0] for anno in stems})

    def available_stems(self):
        annotation_dir = os.path.join(self.base_dir, "annotation_stems")
        return [f for f in os.listdir(annotation_dir) if f.endswith(".csv")]

    def get_tracks(self, split):
        tracks = []
        for multitrack in self.metadata:
            for stem in self.metadata[multitrack]["stems"].values():
                if split == stem["instrument"]:
                    tracks.append(os.path.splitext(stem["filename"])[0])
        return tracks

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, "audio_stems", f"{track}.RESYN.wav")

    def get_ground_truth_path(self, track):
        return os.path.join(self.base_dir, "annotation_stems",
                            f"{track}.RESYN.csv")

    @classmethod
    def download(cls, save_dir):
        BaseDataset.download(save_dir)
        mdb_url = "https://github.com/marl/medleydb/archive/refs/heads/master.zip"
        mdb_path = os.path.join(save_dir, os.path.basename(mdb_url))
        stream_url_resource(mdb_url, mdb_path)
        unzip_and_remove(mdb_path)
        repo_dir = os.path.join(save_dir, "medleydb-master")
        metadata_dir = os.path.join(save_dir, "Metadata")
        os.makedirs(metadata_dir)
        change_base_dir(metadata_dir,
                        os.path.join(repo_dir, "medleydb", "data", "Metadata"))
        import shutil

        shutil.rmtree(repo_dir)
        tar_url = "https://zenodo.org/record/1481172/files/MDB-stem-synth.tar.gz"
        tar_path = os.path.join(save_dir, os.path.basename(tar_url))
        stream_url_resource(tar_url, tar_path)
        unzip_and_remove(tar_path, tar=True)
        change_base_dir(save_dir, os.path.join(save_dir, "MDB-stem-synth"))

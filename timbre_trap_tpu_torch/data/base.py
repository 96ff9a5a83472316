"""Dataset abstraction stack: base, combination, and stem-mixing wrappers
(the port's copy of ``timbre_trap_tpu/data/base.py``).

Semantics mirror ``timbre_trap/datasets/BaseDataset.py`` (base :13-155,
combo :158-219, stem mixing :222-332) on a numpy-native sample protocol:
a dataset is an indexable object yielding dicts of numpy arrays / strings
keyed by ``data.constants``.
"""

import os
import shutil
import warnings
from abc import ABC, abstractmethod

import numpy as np

from . import constants
from .collate import separate_ground_truth

__all__ = ["BaseDataset", "ComboDataset", "StemMixingDataset"]


class BaseDataset(ABC):
    """Bare-minimum dataset functionality: location, splits, track list, RNG."""

    def __init__(self, base_dir=None, splits=None, n_secs=None, seed=0):
        if base_dir is None:
            base_dir = os.path.join(constants.DEFAULT_LOCATION, self.name())
        self.base_dir = base_dir

        if not os.path.isdir(self.base_dir):
            warnings.warn(
                f"Could not find dataset at specified path '{self.base_dir}'."
                " Attempting to download...", category=RuntimeWarning)
            self.download(self.base_dir)

        if splits is None:
            splits = self.available_splits()

        self.tracks = []
        for split in splits:
            self.tracks += self.get_tracks(split)

        self.n_secs = n_secs
        self.rng = np.random.RandomState(seed)

    @classmethod
    def name(cls):
        """Identifier for the dataset (class name by default)."""
        return cls.__name__

    @staticmethod
    @abstractmethod
    def available_splits():
        """List of pre-defined dataset partitions."""

    @abstractmethod
    def get_tracks(self, split):
        """Track names belonging to one partition."""

    def __len__(self):
        return len(self.tracks)

    @abstractmethod
    def __getitem__(self, index):
        """Data dict for one sampled track."""

    @classmethod
    def download(cls, save_dir):
        """Create (or reset) the top-level directory; subclasses fetch data."""
        if os.path.isdir(save_dir):
            shutil.rmtree(save_dir)
        os.makedirs(save_dir)


class ComboDataset:
    """Concatenation of pre-instantiated datasets with index walking."""

    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, index):
        local_idx, dataset_idx = index, 0
        while local_idx >= len(self.datasets[dataset_idx]):
            local_idx -= len(self.datasets[dataset_idx])
            dataset_idx += 1
        return self.datasets[dataset_idx][local_idx]


class StemMixingDataset(ComboDataset):
    """On-the-fly random mixing of stems from several datasets.

    Sums the audio of ``n_min..n_max`` random stems; MPE ground truth is
    summed and clamped to [0, 1]. All member datasets must share ``n_secs``.
    """

    def __init__(self, datasets, tracks_per_epoch, n_min=2, n_max=5, seed=0):
        super().__init__(datasets)
        if len({d.n_secs for d in self.datasets}) != 1:
            raise ValueError("all datasets must share the same n_secs")
        self.tracks_per_epoch = tracks_per_epoch
        self.n_min = n_min
        self.n_max = n_max
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.tracks_per_epoch

    def __getitem__(self, index):
        n_mix = self.rng.randint(self.n_min, self.n_max + 1)
        track_idcs = np.arange(ComboDataset.__len__(self))
        self.rng.shuffle(track_idcs)
        stems = [ComboDataset.__getitem__(self, i) for i in track_idcs[:n_mix]]

        data_both, data_audio, _ = separate_ground_truth(stems)
        data = {constants.KEY_TRACK: str(index), constants.KEY_AUDIO: None}

        if data_audio is not None:
            data[constants.KEY_AUDIO] = np.sum(
                data_audio[constants.KEY_AUDIO], axis=0)
        if data_both is not None:
            mpe_audio = np.sum(data_both[constants.KEY_AUDIO], axis=0)
            if data[constants.KEY_AUDIO] is None:
                data[constants.KEY_AUDIO] = mpe_audio
            else:
                data[constants.KEY_AUDIO] = data[constants.KEY_AUDIO] + mpe_audio
            data[constants.KEY_GROUND_TRUTH] = np.clip(
                np.sum(data_both[constants.KEY_GROUND_TRUTH], axis=0), 0, 1)
            data[constants.KEY_TIMES] = np.asarray(
                data_both[constants.KEY_TIMES][0])
        return data

"""The host data pipeline: the port's copy of ``timbre_trap_tpu/data``
(datasets, collation, audio and MIDI IO, the threaded loader and the
prefetch thread, the download helpers; the corpus wrappers are in
``data.datasets``). Everything here is numpy on the host; the Trainer moves
batches to the card."""

from . import constants
from .base import BaseDataset, ComboDataset, StemMixingDataset
from .audio import AudioDataset
from .pitch import PitchDataset
from .mpe import MPEDataset
from .note import NoteDataset
from .amt import AMTDataset
from .collate import default_collate, separate_ground_truth
from .loader import DataLoader, device_prefetch
from .download import stream_url_resource, unzip_and_remove, change_base_dir

__all__ = [
    "constants",
    "BaseDataset",
    "ComboDataset",
    "StemMixingDataset",
    "AudioDataset",
    "PitchDataset",
    "MPEDataset",
    "NoteDataset",
    "AMTDataset",
    "default_collate",
    "separate_ground_truth",
    "DataLoader",
    "device_prefetch",
    "stream_url_resource",
    "unzip_and_remove",
    "change_base_dir",
]

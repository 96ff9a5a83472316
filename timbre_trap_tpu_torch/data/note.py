"""Note-annotated dataset (the port's copy of ``timbre_trap_tpu/data/note.py``;
reference: datasets/NoteDataset.py).

Ground truth is (pitches, intervals); :func:`notes_to_multi_pitch`
rasterizes notes onto a frame-time grid — vectorized with searchsorted
instead of the reference's per-note frame loops (:93-123).
"""

from abc import abstractmethod

import numpy as np

from . import constants
from .pitch import PitchDataset
from ..transform.design import midi_to_hz

__all__ = ["NoteDataset"]


class NoteDataset(PitchDataset):
    """Dataset with note-level (pitch, onset-offset) annotations."""

    @abstractmethod
    def get_ground_truth(self, track):
        """(pitches (L,) MIDI, intervals (L, 2) seconds) for a track."""

    def __getitem__(self, index, n_samples=None, offset_t=None):
        track = self.tracks[index]
        pitches, intervals = self.get_ground_truth(track)
        pitches = midi_to_hz(pitches)

        if n_samples is None:
            n_samples = self.cqt.get_expected_samples(np.max(intervals))

        times = self.cqt.get_times(self.cqt.get_expected_frames(n_samples))
        if self.n_secs is not None:
            times, _ = self.slice_times(times, offset_t=offset_t)

        multi_pitch = self.notes_to_multi_pitch(pitches, intervals, times)
        ground_truth = self.multi_pitch_to_activations(
            multi_pitch, self.cqt.get_midi_freqs())

        return {constants.KEY_TRACK: track,
                constants.KEY_TIMES: times,
                constants.KEY_GROUND_TRUTH: ground_truth}

    @staticmethod
    def notes_to_multi_pitch(pitches, intervals, times):
        """Mark each note's pitch active on frames with onset <= t < offset."""
        multi_pitch = [np.empty(0) for _ in range(times.shape[-1])]
        for p, (onset, offset) in zip(np.atleast_1d(pitches),
                                      np.atleast_2d(intervals)):
            active = np.where((times >= onset) & (times < offset))[0]
            for i in active:
                multi_pitch[i] = np.append(multi_pitch[i], p)
        return multi_pitch

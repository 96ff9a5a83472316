"""Pitch-annotated dataset layer (the port's copy of
``timbre_trap_tpu/data/pitch.py``; reference:
timbre_trap/datasets/PitchDataset.py). ``cqt`` is the port's ``transform.CQT``.

Frame-grid bookkeeping against the CQT, nearest-neighbor annotation
resampling (:194-231), and the rasterizer converting Hz pitch lists to
Gaussian-blurred bin activations (:233-307) — vectorized with a closed-form
nearest-bin computation (the CQT's MIDI grid is uniform) instead of
per-frame interpolation calls.
"""

import warnings
from abc import abstractmethod

import numpy as np
import scipy.interpolate
from scipy.ndimage import gaussian_filter1d

from . import constants
from .base import BaseDataset
from ..transform.design import hz_to_midi, midi_to_hz
from ..utils.processing import filter_non_peaks, threshold

__all__ = ["PitchDataset"]


class PitchDataset(BaseDataset):
    """Dataset with frame-level multi-pitch annotations."""

    def __init__(self, cqt, resample_idcs=None, **kwargs):
        BaseDataset.__init__(self, **kwargs)
        self.cqt = cqt
        if resample_idcs is None:
            resample_idcs = [0, -1]
        self.resample_idcs = resample_idcs

    @abstractmethod
    def get_ground_truth_path(self, track):
        """Path to a track's ground-truth file."""

    @abstractmethod
    def get_ground_truth(self, track):
        """(times (T,), pitches list of (.,) Hz arrays) for a track."""

    def slice_times(self, times, n_frames=None, offset_t=None):
        """Slice frame times to ``n_frames``; invalid (padded) frames get ±inf.

        Returns (times, offset_n) with the frame offset of the slice.
        """
        if n_frames is None:
            n_samples = self.cqt.get_expected_samples(self.n_secs)
            n_frames = self.cqt.get_expected_frames(n_samples)

        if len(times) >= n_frames:
            if offset_t is None:
                start = self.rng.randint(0, times.size - n_frames + 1)
                offset_n = start
                times = times[start:start + n_frames]
            else:
                times = self.cqt.get_times(n_frames) + offset_t
                offset_n = offset_t * (self.cqt.sample_rate / self.cqt.hop_length)
        else:
            pad_total = n_frames - len(times)
            if offset_t is None:
                pad_left = self.rng.randint(0, pad_total)
            else:
                # Use the CQT's sample rate: ``self.sample_rate`` only exists
                # on AudioDataset, so a bare PitchDataset would AttributeError.
                pad_left = round(abs(offset_t) * self.cqt.sample_rate / self.cqt.hop_length)
            offset_n = -pad_left
            times = np.pad(times, (pad_left, 0), constant_values=-np.inf)
            times = np.pad(times, (0, pad_total - pad_left), constant_values=np.inf)
        return times, offset_n

    def __getitem__(self, index, n_samples=None, offset_t=None):
        track = self.tracks[index]
        _times, _pitches = self.get_ground_truth(track)

        if n_samples is None:
            n_samples = self.cqt.get_expected_samples(_times[-1])

        times = self.cqt.get_times(self.cqt.get_expected_frames(n_samples))
        if self.n_secs is not None:
            times, _ = self.slice_times(times, offset_t=offset_t)

        multi_pitch = self.resample_multi_pitch(_times, _pitches, times)
        ground_truth = self.multi_pitch_to_activations(
            multi_pitch, self.cqt.get_midi_freqs())

        return {constants.KEY_TRACK: track,
                constants.KEY_TIMES: times,
                constants.KEY_GROUND_TRUTH: ground_truth}

    def resample_multi_pitch(self, _times, _multi_pitch, times):
        """Nearest-neighbor resampling of annotations onto a new time grid.

        Out-of-range target times clamp to the frames selected by
        ``resample_idcs`` (reference :194-231).
        """
        original_idcs = np.arange(len(_times))
        fill_values = (original_idcs[self.resample_idcs[0]],
                       original_idcs[self.resample_idcs[-1]])
        res_func_time = scipy.interpolate.interp1d(
            x=_times, y=original_idcs, kind="nearest", bounds_error=False,
            fill_value=fill_values, assume_sorted=True)
        return [_multi_pitch[t] for t in
                res_func_time(times).astype(np.int64)]

    @staticmethod
    def multi_pitch_to_activations(multi_pitch, midi_freqs, n_bins_blur_decay=2.5):
        """Rasterize per-frame Hz pitch lists onto the CQT bin grid.

        One-hot at the nearest bin, then Gaussian blur along frequency
        (sigma = 2 * decay / 5 bins), renormalized so ground-truth bins are
        exactly 1 and clipped to [0, 1] (reference :233-307).
        """
        midi_freqs = np.asarray(midi_freqs)
        n_bins = len(midi_freqs)
        n_frames = len(multi_pitch)
        activations = np.zeros((n_bins, n_frames))

        # Gather all (frame, midi) observations, dropping zero-Hz entries.
        frame_idcs, midis = [], []
        for i, frame in enumerate(multi_pitch):
            frame = np.asarray(frame, dtype=np.float64)
            frame = frame[frame != 0]
            if len(frame):
                frame_idcs.append(np.full(len(frame), i))
                midis.append(hz_to_midi(frame))
        if not frame_idcs:
            return activations
        frame_idcs = np.concatenate(frame_idcs)
        midis = np.concatenate(midis)

        lb, ub = midi_freqs.min(), midi_freqs.max()
        valid = (midis >= lb) & (midis <= ub)
        if not valid.all():
            warnings.warn("Could not fully represent ground-truth with "
                          "available frequency bins.", RuntimeWarning)
        frame_idcs, midis = frame_idcs[valid], midis[valid]
        if len(midis) == 0:
            return activations

        # Nearest bin on the uniform MIDI grid (closed form).
        spacing = (midi_freqs[-1] - midi_freqs[0]) / (n_bins - 1)
        bin_idcs = np.clip(np.round((midis - midi_freqs[0]) / spacing),
                           0, n_bins - 1).astype(np.int64)
        activations[bin_idcs, frame_idcs] = 1.0

        if n_bins_blur_decay:
            std_dev = (2 * n_bins_blur_decay) / 5
            activations = gaussian_filter1d(activations, sigma=std_dev,
                                            axis=0, mode="constant")
            activations /= np.min(activations[bin_idcs, frame_idcs])
            activations = np.clip(activations, 0.0, 1.0)
        return activations

    @staticmethod
    def activations_to_multi_pitch(activations, midi_freqs, peaks_only=False,
                                   t=0.5):
        """Binarize activations back into per-frame Hz pitch lists
        (threshold + optional vertical peak-picking, reference :309-349)."""
        midi_freqs = np.asarray(midi_freqs)
        if peaks_only:
            activations = filter_non_peaks(activations)
        activations = threshold(activations, t)

        multi_pitch = [np.empty(0)] * activations.shape[-1]
        non_silent = np.where(np.sum(activations, axis=-2) > 0)[-1]
        for i in non_silent:
            active = np.where(activations[..., i])[-1]
            multi_pitch[i] = midi_to_hz(midi_freqs[active])
        return multi_pitch

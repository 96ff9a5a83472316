"""Seeded synthetic training data: chord-and-noise tracks with their partials'
frequencies, and batches of them as compact int16 audio and sparse uint8
ground truth, made with numpy. Nothing is read from a dataset;
``chip_smoke.py`` and ``tools/profile_train_step`` train on these."""

import numpy as np

from .step import compact_audio, compact_ground_truth

__all__ = ["chord_crops", "chord_tracks", "synthetic_batch"]

# The partials of each chord, as multiples of its root.
CHORD_RATIOS = (1.0, 1.26, 1.5)


def chord_tracks(n_tracks, seconds, sr, seed=0):
    """Chords (three random-rooted partials each) plus noise, float32
    (n_tracks, 1, N), and each track's partial frequencies in Hz
    (n_tracks, 3)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = np.empty((n_tracks, 1, t.size), np.float32)
    freqs = np.empty((n_tracks, len(CHORD_RATIOS)))
    for i in range(n_tracks):
        f0 = 110.0 * 2 ** (rng.integers(0, 36) / 12)
        freqs[i] = [f0 * r for r in CHORD_RATIOS]
        out[i, 0] = sum(0.2 * np.sin(2 * np.pi * f0 * r * t
                                     + rng.uniform(0, 2 * np.pi))
                        for r in CHORD_RATIOS)
        out[i, 0] += 0.01 * rng.standard_normal(t.size)
    return out, freqs


def chord_crops(n_crops, seconds, sr, seed=0):
    """The audio of ``chord_tracks``: float32 (n_crops, 1, N)."""
    return chord_tracks(n_crops, seconds, sr, seed)[0]


def synthetic_batch(model, n_crops, seconds, seed=0):
    """A batch for ``model``: compact int16 audio (n_crops, 1, N) of
    ``chord_crops`` and uint8 ground truth (n_crops, F, frames) with about
    3 % of its cells on."""
    sr = model.sliCQ.sample_rate
    audio = chord_crops(n_crops, seconds, sr, seed)
    frames = model.sliCQ.get_expected_frames(audio.shape[-1])
    rng = np.random.default_rng(seed + 1)
    gt = rng.uniform(size=(n_crops, model.sliCQ.n_bins, frames)) > 0.97
    return compact_audio(audio), compact_ground_truth(gt)

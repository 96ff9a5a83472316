"""Seeded synthetic training batches: chord-and-noise crops as compact int16
audio and sparse uint8 ground truth, made with numpy. Nothing is read from
a dataset; ``chip_smoke.py`` and ``tools/profile_train_step`` train on
these."""

import numpy as np

from .step import compact_audio, compact_ground_truth

__all__ = ["chord_crops", "synthetic_batch"]


def chord_crops(n_crops, seconds, sr, seed=0):
    """Chords (three random-rooted partials each) plus noise, float32
    (n_crops, 1, N)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = np.empty((n_crops, 1, t.size), np.float32)
    for i in range(n_crops):
        f0 = 110.0 * 2 ** (rng.integers(0, 36) / 12)
        out[i, 0] = sum(0.2 * np.sin(2 * np.pi * f0 * r * t
                                     + rng.uniform(0, 2 * np.pi))
                        for r in (1.0, 1.26, 1.5))
        out[i, 0] += 0.01 * rng.standard_normal(t.size)
    return out


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

"""The one generator of every traffic mix: a traffic file of parameters
(``traffic/<name>.json``) and a seed give the requests or the batches.

Content: one seeded synthetic polyphony, made on the device at set-up.
``voices`` voices each play notes of random pitch (MIDI ``midi``) and
length (``note_s``), three harmonics with a decaying envelope; the mix is
scaled to a peak of 0.9. Requests are slices of it.

Sizes: the set of clip lengths is the same for every seed, ``n_lengths``
lengths spread evenly over ``lengths_s``; the seed orders them (the
closed loop cycles through that order) and places each slice. So runs
with different seeds do the same work in another order.

Training batches: crops of ``crop_s`` seconds at seeded places, the first
``mpe_crops`` of each batch annotated (the notes' bins, frame by frame),
the rest audio-only; a pool of ``pool_batches`` batches with no crop twice,
in the Trainer's upload encoding (int16 on the ±8 grid, uint8 truth).
Each crop has a seeded gain, uniform in decibels over ``gain_db``. The
published recipe has no such augmentation; it is here for the check: a
corpus's tracks differ in loudness, so the rows of a batch weigh
differently in its gradient, and a step that leaves rows out shows.
"""

import numpy as np
import torch

__all__ = ["Polyphony", "clip_plan", "train_pool"]


class Polyphony:
    """The seeded mix (host float32) and its notes."""

    def __init__(self, traffic, sample_rate, seed, device):
        rng = np.random.default_rng([seed, 1])
        n = int(traffic["polyphony_s"] * sample_rate)
        lo, hi = traffic["note_s"]
        self.sample_rate = sample_rate
        self.notes = []        # per voice: (start samples, midi pitch)
        t = torch.arange(n, device=device, dtype=torch.float64)
        mix = torch.zeros(n, device=device, dtype=torch.float64)
        for _ in range(traffic["voices"]):
            lengths = rng.uniform(lo, hi, size=int(n / sample_rate / lo) + 2)
            starts = np.concatenate(([0], np.cumsum(
                (lengths * sample_rate).astype(np.int64))))
            starts = starts[starts < n]
            counts = np.diff(np.append(starts, n))
            midi = rng.integers(traffic["midi"][0], traffic["midi"][1] + 1,
                                size=starts.size)
            self.notes.append((starts, midi))
            f = torch.as_tensor(440.0 * 2.0 ** ((midi - 69) / 12.0),
                                device=device)
            counts_d = torch.as_tensor(counts, device=device)
            f = torch.repeat_interleave(f, counts_d)
            since = t - torch.repeat_interleave(
                torch.as_tensor(starts, device=device, dtype=torch.float64),
                counts_d)
            phase = torch.cumsum(f * (2 * np.pi / sample_rate), 0)
            env = torch.exp(since * (-3.0 / sample_rate))
            mix += env * sum(torch.sin(h * phase) / h for h in (1, 2, 3))
            del f, since, phase, env, counts_d
        mix *= 0.9 / mix.abs().max()
        self.audio = mix.to(torch.float32).cpu().numpy()

    def clip(self, offset, length):
        return self.audio[offset:offset + length]

    def truth(self, offset, length, n_bins, bins_per_octave, fmin_midi,
              frames):
        """(n_bins, frames) uint8 on-cells (255) of the notes sounding at
        each frame of the slice."""
        out = np.zeros((n_bins, frames), np.uint8)
        pos = offset + (np.arange(frames) * length) // frames
        cols = np.arange(frames)
        for starts, midi in self.notes:
            pitch = midi[np.searchsorted(starts, pos, side="right") - 1]
            rows = np.rint((pitch - fmin_midi) * bins_per_octave / 12.0)
            rows = rows.astype(np.int64)
            ok = (rows >= 0) & (rows < n_bins)
            out[rows[ok], cols[ok]] = 255
        return out


def clip_plan(traffic, sample_rate, seed):
    """The requests of one cycle: (offset, length) in samples, in the
    seed's order."""
    rng = np.random.default_rng([seed, 2])
    lo, hi = traffic["lengths_s"]
    k = traffic["n_lengths"]
    lengths = [int((lo + (hi - lo) * (i + 0.5) / k) * sample_rate)
               for i in range(k)]
    n = int(traffic["polyphony_s"] * sample_rate)
    order = rng.permutation(k)
    return [(int(rng.integers(0, n - lengths[i] + 1)), lengths[i])
            for i in order]


def train_pool(traffic, polyphony, model, frames, seed, pin):
    """``pool_batches`` batches: (int16 audio (B, 1, N), uint8 truth
    (mpe, F, frames)), in pinned memory if ``pin``."""
    sr = polyphony.sample_rate
    n = int(traffic["crop_s"] * sr)
    m, a = traffic["mpe_crops"], traffic["audio_crops"]
    n_bins = model["n_octaves"] * model["bins_per_octave"]
    fmin_midi = 12.0 * (np.log2(sr / 2.0 / 2 ** model["n_octaves"])
                        - np.log2(440.0)) + 69.0
    total = len(polyphony.audio)
    slots = traffic["pool_batches"] * (m + a)
    rng = np.random.default_rng([seed, 3])
    # Places on a grid of whole crops, so no two crops overlap.
    grid = rng.permutation(total // n)[:slots] * n
    pool = []
    for b in range(traffic["pool_batches"]):
        offs = grid[b * (m + a):(b + 1) * (m + a)]
        audio = np.stack([polyphony.clip(o, n) for o in offs])[:, None]
        audio = audio * 10.0 ** (rng.uniform(*traffic["gain_db"],
                                             size=(m + a, 1, 1)) / 20.0)
        # The Trainer's compact grid: int16 steps of 1/audio_scale.
        audio = np.clip(np.rint(audio * traffic["audio_scale"]), -32768,
                        32767)
        truth = np.stack([polyphony.truth(o, n, n_bins,
                                          model["bins_per_octave"],
                                          fmin_midi, frames)
                          for o in offs[:m]])
        batch = (torch.from_numpy(audio.astype(np.int16)),
                 torch.from_numpy(truth))
        pool.append(tuple(t.pin_memory() for t in batch) if pin else batch)
    return pool

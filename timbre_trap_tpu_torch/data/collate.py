"""Batch collation on numpy arrays: the port's copy of
``timbre_trap_tpu/data/collate.py``.

``default_collate`` stacks a list of per-sample dicts into batched numpy
arrays; ``separate_ground_truth`` groups a mixed batch by data availability —
(audio + ground-truth, audio-only, ground-truth-only) — with the semantics
of ``timbre_trap/utils/data.py:142-204``.
"""

import numpy as np

from . import constants

__all__ = ["default_collate", "separate_ground_truth"]


def default_collate(samples):
    """Stack a list of dicts of (str | ndarray | scalar) into batch arrays."""
    if not samples:
        return None
    batch = {}
    for key in samples[0].keys():
        values = [s[key] for s in samples]
        if isinstance(values[0], str):
            batch[key] = list(values)
        else:
            batch[key] = np.stack([np.asarray(v) for v in values], axis=0)
    return batch


def separate_ground_truth(batch):
    """Split a list of sample dicts into (both, audio-only, score-only) batches."""
    data_both, data_audio, data_score = [], [], []
    for sample in batch:
        has_audio = constants.KEY_AUDIO in sample
        has_gt = constants.KEY_GROUND_TRUTH in sample
        if has_audio and has_gt:
            data_both.append(sample)
        elif has_audio:
            data_audio.append(sample)
        elif has_gt:
            data_score.append(sample)
        else:
            raise ValueError("sample has neither audio nor ground truth")
    return (default_collate(data_both),
            default_collate(data_audio),
            default_collate(data_score))

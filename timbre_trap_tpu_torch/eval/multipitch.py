"""Frame-level multi-pitch evaluation metrics (mir_eval-compatible).

The port's own numpy/scipy copy of ``timbre_trap_tpu/eval/multipitch.py``.

The reference evaluates with ``mir_eval.multipitch.evaluate`` at 0.5-semitone
tolerance (``timbre_trap/utils/experiments.py:354-396``). mir_eval is not a
dependency of this framework, so the metric suite is implemented here from
the metric definitions (Poliner & Ellis / MIREX multi-F0): per-frame optimal
matching of estimate and reference pitches within a semitone window,
aggregated precision / recall / accuracy and substitution / miss / false-
alarm / total error scores, plus chroma (octave-folded) variants.

Key names and value conventions mirror mir_eval so downstream consumers
(e.g. the MultipitchEvaluator) behave identically.
"""

from collections import OrderedDict

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

__all__ = [
    "MAX_FREQ",
    "MIN_FREQ",
    "resample_multipitch",
    "frequencies_to_midi",
    "midi_to_chroma",
    "compute_num_true_positives",
    "evaluate",
]


# Valid pitch range for frame-level evaluation (mir_eval convention).
MIN_FREQ = 20.0
MAX_FREQ = 5000.0


def resample_multipitch(times, frequencies, target_times):
    """Resample a multipitch sequence to new times via nearest-neighbor.

    Target times outside the original range map to empty (no estimate).
    """
    times = np.asarray(times, dtype=np.float64)
    target_times = np.asarray(target_times, dtype=np.float64)
    if target_times.size == 0:
        return []
    if times.size == 0:
        return [np.array([])] * len(target_times)

    empty = np.array([])
    # nearest original frame for each target time
    idcs = np.searchsorted(times, target_times)
    idcs = np.clip(idcs, 0, len(times) - 1)
    prev = np.clip(idcs - 1, 0, len(times) - 1)
    use_prev = np.abs(target_times - times[prev]) <= np.abs(times[idcs] - target_times)
    nearest = np.where(use_prev, prev, idcs)
    out_of_range = (target_times < times[0]) | (target_times > times[-1])
    return [empty if oob else frequencies[i]
            for i, oob in zip(nearest, out_of_range)]


def frequencies_to_midi(frequencies, ref_frequency=440.0):
    """Convert each frame's Hz array to (fractional) MIDI numbers."""
    return [69.0 + 12.0 * np.log2(np.asarray(f, dtype=np.float64) / ref_frequency)
            if len(f) else np.array([]) for f in frequencies]


def midi_to_chroma(midi):
    """Fold each frame's MIDI numbers onto a single octave [0, 12)."""
    return [np.mod(np.asarray(m), 12.0) if len(m) else np.array([]) for m in midi]


def _match_count(ref, est, window, chroma):
    """Size of the maximum matching between ref and est events within window."""
    if len(ref) == 0 or len(est) == 0:
        return 0
    dist = np.abs(ref[:, None] - est[None, :])
    if chroma:
        dist = np.minimum(dist, 12.0 - dist)
    hits = dist <= window
    if not hits.any():
        return 0
    graph = csr_matrix(hits)
    matching = maximum_bipartite_matching(graph, perm_type="column")
    return int(np.sum(matching != -1))


def compute_num_true_positives(ref_midi, est_midi, window=0.5, chroma=False):
    """Per-frame true-positive counts via optimal bipartite matching."""
    return np.array([
        _match_count(np.asarray(r, dtype=np.float64),
                     np.asarray(e, dtype=np.float64), window, chroma)
        for r, e in zip(ref_midi, est_midi)
    ], dtype=np.float64)


def _accuracy_metrics(true_positives, n_ref, n_est):
    tp = float(np.sum(true_positives))
    total_ref = float(np.sum(n_ref))
    total_est = float(np.sum(n_est))
    precision = tp / total_est if total_est > 0 else 0.0
    recall = tp / total_ref if total_ref > 0 else 0.0
    fp = total_est - tp
    fn = total_ref - tp
    denom = tp + fp + fn
    accuracy = tp / denom if denom > 0 else 0.0
    return precision, recall, accuracy


def _error_metrics(true_positives, n_ref, n_est):
    total_ref = float(np.sum(n_ref))
    if total_ref == 0:
        return 0.0, 0.0, 0.0, 0.0
    e_sub = float(np.sum(np.minimum(n_ref, n_est) - true_positives)) / total_ref
    e_miss = float(np.sum(np.maximum(n_ref - n_est, 0.0))) / total_ref
    e_fa = float(np.sum(np.maximum(n_est - n_ref, 0.0))) / total_ref
    return e_sub, e_miss, e_fa, e_sub + e_miss + e_fa


def evaluate(ref_time, ref_freqs, est_time, est_freqs, window=0.5):
    """Full multi-pitch metric suite; mir_eval-compatible key names.

    Parameters: reference/estimate frame times (seconds) and per-frame
    arrays of active pitches in Hz; ``window`` is the semitone tolerance.
    """
    ref_time = np.asarray(ref_time, dtype=np.float64)
    est_time = np.asarray(est_time, dtype=np.float64)
    if len(ref_freqs) != len(ref_time):
        raise ValueError("reference times and frequencies size mismatch")
    if len(est_freqs) != len(est_time):
        raise ValueError("estimate times and frequencies size mismatch")

    if est_time.shape != ref_time.shape or not np.allclose(est_time, ref_time):
        est_freqs = resample_multipitch(est_time, est_freqs, ref_time)

    ref_midi = frequencies_to_midi(ref_freqs)
    est_midi = frequencies_to_midi(est_freqs)
    n_ref = np.array([len(f) for f in ref_midi], dtype=np.float64)
    n_est = np.array([len(f) for f in est_midi], dtype=np.float64)

    tp = compute_num_true_positives(ref_midi, est_midi, window=window)
    precision, recall, accuracy = _accuracy_metrics(tp, n_ref, n_est)
    e_sub, e_miss, e_fa, e_tot = _error_metrics(tp, n_ref, n_est)

    ref_chroma = midi_to_chroma(ref_midi)
    est_chroma = midi_to_chroma(est_midi)
    tp_c = compute_num_true_positives(ref_chroma, est_chroma, window=window,
                                      chroma=True)
    c_precision, c_recall, c_accuracy = _accuracy_metrics(tp_c, n_ref, n_est)
    ce_sub, ce_miss, ce_fa, ce_tot = _error_metrics(tp_c, n_ref, n_est)

    return OrderedDict([
        ("Precision", precision),
        ("Recall", recall),
        ("Accuracy", accuracy),
        ("Substitution Error", e_sub),
        ("Miss Error", e_miss),
        ("False Alarm Error", e_fa),
        ("Total Error", e_tot),
        ("Chroma Precision", c_precision),
        ("Chroma Recall", c_recall),
        ("Chroma Accuracy", c_accuracy),
        ("Chroma Substitution Error", ce_sub),
        ("Chroma Miss Error", ce_miss),
        ("Chroma False Alarm Error", ce_fa),
        ("Chroma Total Error", ce_tot),
    ])

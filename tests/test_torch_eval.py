"""The port's evaluation metrics (timbre_trap_tpu_torch.eval and .utils)
against the JAX package's, on the synthetic cases of ``tests/test_eval.py``
and on seeded random ones: the numpy-level results agree to 1e-12."""

import random

import numpy as np
import pytest
import torch

from timbre_trap_tpu.eval import multipitch as jax_mp
from timbre_trap_tpu.eval import signal_distortion_ratio as jax_sdr
from timbre_trap_tpu.utils import MultipitchEvaluator as JaxEvaluator
from timbre_trap_tpu.utils import filter_non_peaks as jax_filter_non_peaks
from timbre_trap_tpu.utils import threshold as jax_threshold
from timbre_trap_tpu_torch.eval import multipitch as mp
from timbre_trap_tpu_torch.eval import signal_distortion_ratio
from timbre_trap_tpu_torch.utils import (MultipitchEvaluator,
                                         filter_non_peaks, seed_everything,
                                         threshold, to_array)

torch.set_num_threads(2)


def _hz(*midis):
    return np.array([440.0 * 2 ** ((m - 69) / 12) for m in midis])


def _random_frames(rng, n):
    return [_hz(*rng.uniform(40, 90, rng.integers(0, 5))) for _ in range(n)]


def _cases():
    """(ref_time, ref_freqs, est_time, est_freqs) of ``tests/test_eval.py``
    plus seeded random tracks on equal and on other time grids."""
    t3, t1 = np.arange(3) * 0.01, np.array([0.0])
    rng = np.random.default_rng(0)
    times = np.arange(40) * 0.02
    return {
        "perfect": (np.arange(4) * 0.01,
                    [_hz(60), _hz(60, 64), np.array([]), _hz(67)],
                    np.arange(4) * 0.01,
                    [_hz(60), _hz(60, 64), np.array([]), _hz(67)]),
        "empty": (t3, [_hz(60), _hz(62), _hz(64)], t3, [np.array([])] * 3),
        "within": (t1, [_hz(60)], t1, [_hz(60.4)]),
        "outside": (t1, [_hz(60)], t1, [_hz(60.6)]),
        "octave": (np.array([0.0, 0.01]), [_hz(60), _hz(55)],
                   np.array([0.0, 0.01]), [_hz(72), _hz(55)]),
        "false-alarm": (t1, [_hz(60)], t1, [_hz(60, 64, 67)]),
        "duplicates": (t1, [_hz(60)], t1, [_hz(60.0, 60.1)]),
        "resampled": (np.array([0.0, 0.1, 0.2]), [_hz(60)] * 3,
                      np.array([0.0, 0.05, 0.1, 0.15, 0.2]),
                      [_hz(60), _hz(62), _hz(60), _hz(62), _hz(60)]),
        "random": (times, _random_frames(rng, 40), times,
                   _random_frames(rng, 40)),
        "random-regrid": (times, _random_frames(rng, 40),
                          np.arange(57) * 0.0137, _random_frames(rng, 57)),
    }


_CASES = _cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_multipitch_evaluate_matches_jax(name):
    ref_time, ref_freqs, est_time, est_freqs = _CASES[name]
    want = jax_mp.evaluate(ref_time, ref_freqs, est_time, est_freqs)
    got = mp.evaluate(ref_time, ref_freqs, est_time, est_freqs)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-12), key


def test_multipitch_evaluate_known_values():
    scores = mp.evaluate(*_CASES["octave"])
    assert scores["Recall"] == pytest.approx(0.5)
    assert scores["Chroma Recall"] == pytest.approx(1.0)
    assert scores["Substitution Error"] == pytest.approx(0.5)
    scores = mp.evaluate(*_CASES["false-alarm"])
    assert scores["Precision"] == pytest.approx(1 / 3)
    assert scores["False Alarm Error"] == pytest.approx(2.0)
    assert mp.evaluate(*_CASES["within"])["Recall"] == 1.0
    assert mp.evaluate(*_CASES["outside"])["Recall"] == 0.0
    with pytest.raises(ValueError, match="size mismatch"):
        mp.evaluate(np.arange(2), [_hz(60)], np.arange(2), [_hz(60)] * 2)


def test_resample_multipitch_matches_jax():
    rng = np.random.default_rng(1)
    times = np.sort(rng.uniform(1.0, 2.0, 30))
    freqs = _random_frames(rng, 30)
    target = np.linspace(0.0, 3.0, 71)
    want = jax_mp.resample_multipitch(times, freqs, target)
    got = mp.resample_multipitch(times, freqs, target)
    assert len(got) == len(want) == 71
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 0 and len(got[-1]) == 0
    assert mp.resample_multipitch(times, freqs, np.array([])) == []


@pytest.mark.parametrize("case", ["identical", "scaled", "noisy", "batch"])
def test_signal_distortion_ratio_matches_jax(case):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4000) if case != "batch" else (2, 3, 4000))
    est = {"identical": x, "scaled": 0.5 * x,
           "noisy": x + 0.1 * rng.standard_normal(x.shape),
           "batch": x + 0.3 * rng.standard_normal(x.shape)}[case]
    want = jax_sdr(est, x)
    got = signal_distortion_ratio(est, x)
    assert got == pytest.approx(want, abs=1e-12)
    if case in ("identical", "scaled"):
        assert got > 80.0
    if case == "noisy":
        assert 15.0 < got < 25.0
    for kw in ({"zero_mean": True}, {"load_diag": 1e-3},
               {"filter_length": 64}):
        assert signal_distortion_ratio(est, x, **kw) == pytest.approx(
            jax_sdr(est, x, **kw), abs=1e-12)
    with pytest.raises(ValueError, match="shape"):
        signal_distortion_ratio(est[..., :-1], x)


def test_threshold_and_filter_non_peaks_match_jax():
    arr = np.array([[0.2, 0.5, 0.8]])
    assert np.array_equal(threshold(arr, 0.5), [[0.0, 1.0, 1.0]])
    col = np.array([[0.1], [0.5], [0.3], [0.7], [0.7]])
    assert filter_non_peaks(col)[:, 0].tolist() == [0.0, 0.5, 0.0, 0.0, 0.0]
    edges = filter_non_peaks(np.array([[0.9], [0.1], [0.8]]))
    assert edges[0, 0] == 0.9 and edges[2, 0] == 0.8
    a = np.random.default_rng(3).uniform(size=(2, 60, 300))
    for t in (0.5, 0.0, 0.9):
        np.testing.assert_array_equal(threshold(a, t), jax_threshold(a, t))
    np.testing.assert_array_equal(filter_non_peaks(a),
                                  jax_filter_non_peaks(a))


def test_to_array_takes_tensors():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    out = to_array(t * 2)
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.arange(6).reshape(2, 3) * 2)
    assert to_array([1, 2]).tolist() == [1, 2]


def test_multipitch_evaluator_matches_jax():
    rng = np.random.default_rng(4)
    times = np.arange(30) * 0.01
    tracks = [(_random_frames(rng, 30), _random_frames(rng, 30))
              for _ in range(3)]
    tracks.append(([np.array([])] * 30, _random_frames(rng, 30)))
    port, ref = MultipitchEvaluator(0.5), JaxEvaluator(0.5)
    for est, gt in tracks:
        got = port.evaluate(times, est, times, gt)
        want = ref.evaluate(times, est, times, gt)
        assert list(got) == list(want) and "mpe/f1-score" in got
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-12), key
        port.append_results(got)
        ref.append_results(want)
    for got, want in zip(port.average_results(), ref.average_results()):
        assert got == want
    port.reset_results()
    assert port.results == {}
    single = MultipitchEvaluator()
    single.append_results(single.evaluate(times[:2], [_hz(60), _hz(64)],
                                          times[:2], [_hz(60), _hz(64)]))
    assert single.average_results()[0]["mpe/f1-score"] == pytest.approx(1.0)


def test_seed_everything_seeds_every_generator():
    g = seed_everything(7)
    draws = (random.random(), np.random.rand(), torch.rand(1).item(),
             torch.rand(1, generator=g).item())
    g = seed_everything(7)
    assert draws == (random.random(), np.random.rand(), torch.rand(1).item(),
                     torch.rand(1, generator=g).item())

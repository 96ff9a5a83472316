"""The port's external baselines (timbre_trap_tpu_torch.eval.external)
against the JAX package's ``eval/external.py``:

* the Basic-Pitch runner on a stub TF SavedModel (a one-hot ``contour``
  emitter, as ``tests/test_external_baselines.py`` builds it): windowing,
  stitching and the frame-time correction give the same times and salience
  as the JAX runner on the same stub and audio, bit for bit;
* the refusals, each made deterministic: Basic-Pitch without a path (no
  ``basic_pitch`` package) and with a missing path; Deep-Salience in the
  JAX order -- TensorFlow, then librosa (blocked in ``sys.modules``), then
  the download (the port's download function patched to raise, so nothing
  touches the network).
"""

import sys
import types

import numpy as np
import pytest

from timbre_trap_tpu.eval import external as jax_external
from timbre_trap_tpu_torch.data import download
from timbre_trap_tpu_torch.eval import external
from timbre_trap_tpu_torch.eval.external import (BP_FFT_HOP, BP_MIDI_FREQS,
                                                 BP_SAMPLE_RATE,
                                                 ExternalBaselineUnavailable,
                                                 load_basic_pitch,
                                                 load_deep_salience)


def test_constants_match_jax():
    for name in ("BP_SAMPLE_RATE", "BP_FFT_HOP", "BP_AUDIO_N_SAMPLES",
                 "BP_N_OVERLAPPING_FRAMES", "BP_OVERLAP_LEN", "BP_HOP_SIZE",
                 "BP_ANNOTATIONS_FPS", "BP_ANNOT_N_FRAMES", "BP_N_BINS",
                 "BP_BINS_PER_OCTAVE", "DS_SCRIPT_URL", "DS_WEIGHTS_URL"):
        assert getattr(external, name) == getattr(jax_external, name), name
    np.testing.assert_array_equal(BP_MIDI_FREQS, jax_external.BP_MIDI_FREQS)


def _make_stub_saved_model(path, hot_bin):
    tf = pytest.importorskip("tensorflow")

    class Stub(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([None, 43844, 1], tf.float32)])
        def __call__(self, x):
            w = tf.shape(x)[0]
            frames = 43844 // 256
            # Each frame carries its window's index, so a stitching error
            # moves mass to another bin.
            idx = tf.cast(tf.range(w), tf.float32)[:, None, None]
            contour = tf.one_hot(tf.fill([w, frames], hot_bin), 264) \
                * (1.0 + idx)
            return {"contour": contour,
                    "note": contour[:, :, :88],
                    "onset": contour[:, :, :88]}

    tf.saved_model.save(Stub(), path)


def test_basic_pitch_runner_matches_jax(tmp_path):
    hot_bin = 117  # MIDI 60 on the Basic-Pitch grid: (60 - 21) * 3
    assert BP_MIDI_FREQS[hot_bin] == pytest.approx(60.0)
    path = str(tmp_path / "bp_model")
    _make_stub_saved_model(path, hot_bin)

    n = int(5.3 * BP_SAMPLE_RATE)
    audio = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    times, salience = load_basic_pitch(path)(audio)
    want_times, want_salience = jax_external.load_basic_pitch(path)(audio)
    np.testing.assert_array_equal(times, want_times)
    np.testing.assert_array_equal(salience, want_salience)

    n_frames = int(np.floor(n * (BP_SAMPLE_RATE // BP_FFT_HOP)
                            / BP_SAMPLE_RATE))
    assert salience.shape == (264, n_frames) and len(times) == n_frames
    assert times[0] == 0.0 and np.all(np.diff(times) > 0)
    assert np.count_nonzero(salience.sum(axis=1)) == 1
    assert salience[hot_bin].min() >= 1.0
    assert salience[hot_bin].max() > 1.0   # more than one window stitched


def test_basic_pitch_unavailable(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "basic_pitch", None)
    with pytest.raises(ExternalBaselineUnavailable, match="basic_pitch"):
        load_basic_pitch(None)
    with pytest.raises(ExternalBaselineUnavailable, match="not found"):
        load_basic_pitch(str(tmp_path / "missing"))


def _no_download(url, save_path, *args, **kwargs):
    raise AssertionError(f"download attempted: {url}")


def _failed_download(url, save_path, *args, **kwargs):
    raise OSError(f"no network for {url}")


def test_deep_salience_refuses_without_tensorflow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "librosa", None)
    monkeypatch.setattr(download, "stream_url_resource", _no_download)
    with pytest.raises(ExternalBaselineUnavailable,
                       match="Deep-Salience requires tensorflow"):
        load_deep_salience(str(tmp_path))


def test_deep_salience_refuses_without_librosa(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow",
                        types.ModuleType("tensorflow"))
    monkeypatch.setitem(sys.modules, "librosa", None)
    monkeypatch.setattr(download, "stream_url_resource", _no_download)
    with pytest.raises(ExternalBaselineUnavailable, match="librosa"):
        load_deep_salience(str(tmp_path))


def test_deep_salience_refuses_a_failed_download(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow",
                        types.ModuleType("tensorflow"))
    monkeypatch.setitem(sys.modules, "librosa", types.ModuleType("librosa"))
    monkeypatch.setattr(download, "stream_url_resource", _failed_download)
    with pytest.raises(ExternalBaselineUnavailable,
                       match="download failed.*no network"):
        load_deep_salience(str(tmp_path))

"""External comparison baselines (reference: experiments/comparison.py:54-119),
the port's copy of ``timbre_trap_tpu/eval/external.py``.

The reference benchmarks Timbre-Trap against two third-party systems:

* **Basic-Pitch** — a TensorFlow SavedModel (ICASSP 2022); the reference
  loads it via the ``basic_pitch`` pip package (comparison.py:54-66) and
  evaluates its ``contour`` salience head at threshold 0.27
  (comparison.py:272-287).
* **Deep-Salience** — a Keras model whose inference script + weights the
  reference downloads from GitHub and live-patches (comparison.py:69-119),
  evaluated via its own ``get_multif0`` at threshold 0.3 (:290-305).

Both have heavyweight, optional dependencies, so each loader either returns
a ready estimator or raises :class:`ExternalBaselineUnavailable` with an
actionable message — the comparison CLI turns that into a clean skip.

The Basic-Pitch runner here does not need the ``basic_pitch`` package when a
SavedModel path is given: the windowed inference (2-s windows of 43844
samples, 30-frame overlap, center padding, overlap trimming, and the
stitched frame->time correction) is implemented directly against public
Basic-Pitch constants, so any exported SavedModel with a ``contour`` output
works. TensorFlow is imported only when a loader runs.
"""

import os

import numpy as np

__all__ = [
    "ExternalBaselineUnavailable",
    "load_basic_pitch",
    "load_deep_salience",
    "BP_MIDI_FREQS",
]

# Basic-Pitch public constants (basic_pitch/constants.py of the upstream
# package; pinned by the reference's usage at comparison.py:60-66,272-287).
BP_SAMPLE_RATE = 22050
BP_FFT_HOP = 256
BP_AUDIO_N_SAMPLES = 2 * BP_SAMPLE_RATE - BP_FFT_HOP  # 43844, one 2-s window
BP_N_OVERLAPPING_FRAMES = 30
BP_OVERLAP_LEN = BP_N_OVERLAPPING_FRAMES * BP_FFT_HOP
BP_HOP_SIZE = BP_AUDIO_N_SAMPLES - BP_OVERLAP_LEN
BP_ANNOTATIONS_FPS = BP_SAMPLE_RATE // BP_FFT_HOP
BP_ANNOT_N_FRAMES = BP_ANNOTATIONS_FPS * 2
BP_N_BINS = 264
BP_BINS_PER_OCTAVE = 36

# MIDI frequency of every Basic-Pitch contour bin: A0 + n/3 semitones
# (reference comparison.py:60-66).
BP_MIDI_FREQS = 21.0 + np.arange(BP_N_BINS) / (BP_BINS_PER_OCTAVE / 12)


class ExternalBaselineUnavailable(RuntimeError):
    """An optional third-party baseline cannot run in this environment."""


def _require_tensorflow(what):
    try:
        import tensorflow as tf  # noqa: F401

        return tf
    except Exception as exc:  # pragma: no cover - TF present in CI image
        raise ExternalBaselineUnavailable(
            f"{what} requires tensorflow, which is not importable: {exc}"
        ) from exc


def load_basic_pitch(saved_model_path=None):
    """Return ``estimate(audio) -> (times, salience)`` for Basic-Pitch.

    ``saved_model_path`` points at the ICASSP-2022 TF SavedModel; when
    omitted, the path is resolved through the optional ``basic_pitch``
    package like the reference does (comparison.py:54-63). ``audio`` is
    mono float32 at 22050 Hz; ``salience`` is (264, n_frames) in [0, 1].
    """
    if saved_model_path is None:
        try:
            from basic_pitch import ICASSP_2022_MODEL_PATH

            saved_model_path = str(ICASSP_2022_MODEL_PATH)
        except ImportError as exc:
            raise ExternalBaselineUnavailable(
                "Basic-Pitch model path not given and the basic_pitch "
                "package is not installed; pass --basic-pitch "
                "PATH_TO_SAVED_MODEL or pip install basic-pitch."
            ) from exc
    if not os.path.exists(saved_model_path):
        raise ExternalBaselineUnavailable(
            f"Basic-Pitch SavedModel not found at {saved_model_path}")

    tf = _require_tensorflow("Basic-Pitch")
    model = tf.saved_model.load(saved_model_path)

    def estimate(audio):
        audio = np.asarray(audio, np.float32).reshape(-1)
        n = len(audio)
        # Center the first window: pad front by half the overlap, as the
        # upstream inference does, then cut overlapping windows.
        padded = np.concatenate([np.zeros(BP_OVERLAP_LEN // 2, np.float32),
                                 audio])
        n_windows = max(1, -(-len(padded) // BP_HOP_SIZE))
        total = (n_windows - 1) * BP_HOP_SIZE + BP_AUDIO_N_SAMPLES
        padded = np.pad(padded, (0, total - len(padded)))
        idx = (np.arange(BP_AUDIO_N_SAMPLES)[None, :]
               + BP_HOP_SIZE * np.arange(n_windows)[:, None])
        windows = padded[idx][..., None]                 # (W, 43844, 1)

        out = model(tf.constant(windows))
        contour = np.asarray(out["contour"])             # (W, F_w, 264)

        # Stitch: drop half the overlapping frames on each side of every
        # window, then trim to the true frame count of the input audio.
        olap = BP_N_OVERLAPPING_FRAMES // 2
        contour = contour[:, olap:-olap, :]
        contour = contour.reshape(-1, contour.shape[-1])
        n_frames = int(np.floor(n * BP_ANNOTATIONS_FPS / BP_SAMPLE_RATE))
        contour = contour[:n_frames]

        # Frame->time with the per-window stitching-drift correction used
        # by upstream model_frames_to_time.
        frames = np.arange(len(contour))
        times = frames * BP_FFT_HOP / BP_SAMPLE_RATE
        window_numbers = np.floor(frames / BP_ANNOT_N_FRAMES)
        window_offset = (BP_FFT_HOP / BP_SAMPLE_RATE) * (
            BP_ANNOT_N_FRAMES - BP_AUDIO_N_SAMPLES / BP_FFT_HOP) + 0.0018
        times = times - window_offset * window_numbers
        return times, contour.T                          # (264, n_frames)

    return estimate


DS_SCRIPT_URL = ("https://raw.githubusercontent.com/rabitt/"
                 "ismir2017-deepsalience/master/predict/predict_on_audio.py")
DS_WEIGHTS_URL = ("https://raw.githubusercontent.com/rabitt/"
                  "ismir2017-deepsalience/master/predict/weights/multif0.h5")


def load_deep_salience(cache_dir):
    """Return ``estimate(audio_path) -> (times, multi_pitch)`` for
    Deep-Salience, mirroring the reference's loader (comparison.py:69-119):
    download the upstream inference script + weights into ``cache_dir``,
    apply the same keras-compat patch, and drive its ``get_multif0`` at
    threshold 0.3.

    Requires tensorflow/keras AND librosa (the upstream script computes its
    HCQT features with librosa) AND network access for the first download —
    any missing piece raises :class:`ExternalBaselineUnavailable`.
    """
    _require_tensorflow("Deep-Salience")
    try:
        import librosa  # noqa: F401
    except ImportError as exc:
        raise ExternalBaselineUnavailable(
            "Deep-Salience requires librosa (used by the upstream "
            "predict_on_audio.py for HCQT features), which is not "
            "installed.") from exc

    script_path = os.path.join(cache_dir, "predict_on_audio.py")
    weights_path = os.path.join(cache_dir, "weights", "multif0.h5")
    os.makedirs(os.path.dirname(weights_path), exist_ok=True)
    if not (os.path.exists(script_path) and os.path.exists(weights_path)):
        from ..data.download import stream_url_resource

        try:
            stream_url_resource(DS_SCRIPT_URL, script_path)
            stream_url_resource(DS_WEIGHTS_URL, weights_path)
        except Exception as exc:
            raise ExternalBaselineUnavailable(
                f"Deep-Salience script/weights download failed ({exc}); "
                f"place predict_on_audio.py and weights/multif0.h5 under "
                f"{cache_dir} manually.") from exc
        _patch_deep_salience_script(script_path)

    import importlib.util

    spec = importlib.util.spec_from_file_location("deep_salience_predict",
                                                  script_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    model = mod.model_def()
    model.load_weights(weights_path)

    def estimate(audio_path):
        hcqt, freq_grid, time_grid = mod.compute_hcqt(audio_path)
        salience = mod.get_single_test_prediction(model, hcqt)
        return mod.get_multif0(salience, freq_grid, time_grid, thresh=0.3)

    return estimate


def _patch_deep_salience_script(script_path):
    """Apply the reference's keras-compat line edits (comparison.py:96-110)."""
    with open(script_path) as fh:
        lines = fh.readlines()
    lines[11] = ("from keras.layers import Input, Lambda, Conv2D, "
                 "BatchNormalization\n")
    lines[69] = ("\t\tBINS_PER_OCTAVE*N_OCTAVES, fmin=FMIN, "
                 "bins_per_octave=BINS_PER_OCTAVE\n")
    lines.pop(12)
    lines.pop(12)
    with open(script_path, "w") as fh:
        fh.writelines(lines)

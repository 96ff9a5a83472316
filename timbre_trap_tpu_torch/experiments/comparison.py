"""Compare Timbre-Trap against baseline transcription methods on the card
(the port's counterpart of the JAX package's ``experiments/comparison.py``;
reference: experiments/comparison.py).

Baselines implemented natively: amplitude-weighted peak-picking on the
linear-magnitude CQT (threshold 0.3) and on the rescaled log-magnitude CQT
(threshold 0.8), both on the port's ``CQT``; Timbre-Trap itself
(``--checkpoint``, through ``load_model`` and ``transcribe``) runs at
threshold 0.5. The external baselines of the reference -- Basic-Pitch (TF
SavedModel, threshold 0.27) and Deep-Salience (Keras, threshold 0.3) -- run
behind ``--basic-pitch`` / ``--deep-salience``; when their optional
dependencies (tensorflow, the model files, librosa, network) are missing
they skip cleanly with a message. Evaluation sets mirror the reference:
Bach10 mixtures, plus Su and GuitarSet player 05 when their directories are
supplied (comparison.py:130-146).

Example:
    python -m timbre_trap_tpu_torch.experiments.comparison \\
        --bach10-dir /data/Bach10 --checkpoint runs/base/models/model-250
"""

import argparse
import os

import numpy as np
import torch

from ..data import constants
from ..data.note import NoteDataset
from ..data.pitch import PitchDataset
from ..eval import MAX_FREQ
from ..eval.external import (BP_MIDI_FREQS, ExternalBaselineUnavailable,
                             load_basic_pitch, load_deep_salience)
from ..models import load_model
from ..transform import CQT
from ..transform.design import midi_to_hz
from ..utils import (MultipitchEvaluator, filter_non_peaks, print_and_log,
                     threshold, to_array)

__all__ = ["evaluate_method", "parse_args", "build_estimators",
           "build_eval_sets", "main"]


def evaluate_method(eval_set, estimator, log_path=None, tag=""):
    """Mean multipitch results of ``estimator(data, eval_set) -> (times,
    multi_pitch)`` over every track of ``eval_set``."""
    evaluator = MultipitchEvaluator()
    for data in eval_set:
        track = data[constants.KEY_TRACK]
        if isinstance(eval_set, NoteDataset):
            times_ref = data[constants.KEY_TIMES]
            pitches, intervals = eval_set.get_ground_truth(track)
            multi_pitch_ref = eval_set.notes_to_multi_pitch(
                midi_to_hz(pitches), intervals, times_ref)
        else:
            times_ref, multi_pitch_ref = eval_set.get_ground_truth(track)
        times_est, multi_pitch_est = estimator(data, eval_set)
        results = evaluator.evaluate(times_est, multi_pitch_est,
                                     times_ref, multi_pitch_ref)
        evaluator.append_results(results)
    mean, std = evaluator.average_results()
    print_and_log(f"[{tag}] mean={mean}", log_path)
    return mean


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="Timbre-Trap checkpoint (omit to skip the model)")
    p.add_argument("--bach10-dir", default=None)
    p.add_argument("--su-dir", default=None,
                   help="evaluate on the Su dataset too (reference :137-141)")
    p.add_argument("--gset-dir", default=None,
                   help="evaluate on GuitarSet player 05 too "
                        "(reference :143-146)")
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--log-path", default=None)
    p.add_argument("--thr-lin", type=float, default=0.3)
    p.add_argument("--thr-log", type=float, default=0.8)
    p.add_argument("--thr-tt", type=float, default=0.5)
    p.add_argument("--basic-pitch", action="store_true",
                   help="include the Basic-Pitch baseline (threshold 0.27)")
    p.add_argument("--basic-pitch-model", default=None,
                   help="path to the Basic-Pitch ICASSP-2022 TF SavedModel "
                        "(default: resolve through the basic_pitch package)")
    p.add_argument("--deep-salience", action="store_true",
                   help="include the Deep-Salience baseline (threshold 0.3)")
    p.add_argument("--deep-salience-dir",
                   default=os.path.join("generated", "deep_salience"),
                   help="cache directory for the Deep-Salience script and "
                        "weights")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the transform and the kernels' plain "
                        "PyTorch versions on the CPU; default the card (no "
                        "card raises)")
    return p.parse_args(argv)


def _padded_audio(data, block_length):
    """A track's audio as (1, 1, N) float32 numpy, zero-padded to whole
    blocks."""
    audio = np.asarray(data[constants.KEY_AUDIO], np.float32)[None]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, -audio.shape[-1] % block_length)]
    return np.pad(audio, pad)


def build_estimators(args, cqt):
    """Assemble the (tag, estimator) list; external loaders that cannot run
    report why and are skipped (never a crash)."""
    valid = midi_to_hz(cqt.midi_freqs) > MAX_FREQ

    def _mask(acts):
        acts = np.array(acts)
        acts[valid] = 0
        return acts

    def _times_for(audio):
        return cqt.get_times(cqt.get_expected_frames(audio.shape[-1]))

    def _magnitude(audio):
        """(1, F, T) magnitude of the CQT of numpy audio, on ``cqt``'s
        device."""
        coefficients = cqt.encode(torch.from_numpy(audio).to(cqt.device))
        return CQT.to_magnitude(CQT.to_real(coefficients))

    def lin_cqt(data, eval_set):
        audio = _padded_audio(data, cqt.block_length)
        mag = to_array(_magnitude(audio))[0]
        acts = _mask(mag / max(mag.max(), 1e-8))
        mp = PitchDataset.activations_to_multi_pitch(
            acts, cqt.midi_freqs, peaks_only=True, t=args.thr_lin)
        return _times_for(audio), mp

    def log_cqt(data, eval_set):
        audio = _padded_audio(data, cqt.block_length)
        acts = _mask(to_array(CQT.to_decibels(_magnitude(audio)))[0])
        mp = PitchDataset.activations_to_multi_pitch(
            acts, cqt.midi_freqs, peaks_only=True, t=args.thr_log)
        return _times_for(audio), mp

    estimators = [("lin-CQT", lin_cqt), ("log-CQT", log_cqt)]

    if args.checkpoint is not None:
        model = load_model(
            args.checkpoint, overrides=dict(device=args.device),
            defaults=dict(sample_rate=args.sample_rate, n_octaves=9,
                          bins_per_octave=60, secs_per_block=3,
                          latent_size=128, model_complexity=2))

        def timbre_trap(data, eval_set):
            audio = _padded_audio(data, model.sliCQ.block_length)
            acts = _mask(to_array(model.transcribe(audio))[0])
            mp = PitchDataset.activations_to_multi_pitch(
                acts, model.sliCQ.midi_freqs, peaks_only=True, t=args.thr_tt)
            return _times_for(audio), mp

        estimators.append(("timbre-trap", timbre_trap))

    if args.basic_pitch:
        try:
            bp_estimate = load_basic_pitch(args.basic_pitch_model)

            def basic_pitch(data, eval_set):
                audio = np.asarray(data[constants.KEY_AUDIO]).reshape(-1)
                times, salience = bp_estimate(audio)
                acts = threshold(filter_non_peaks(salience), 0.27)
                mp = PitchDataset.activations_to_multi_pitch(
                    acts, BP_MIDI_FREQS)
                return times, mp

            estimators.append(("basic-pitch", basic_pitch))
        except ExternalBaselineUnavailable as exc:
            print_and_log(f"[basic-pitch] SKIPPED: {exc}", args.log_path)

    if args.deep_salience:
        try:
            ds_estimate = load_deep_salience(args.deep_salience_dir)

            def deep_salience(data, eval_set):
                path = eval_set.get_audio_path(data[constants.KEY_TRACK])
                return ds_estimate(path)

            estimators.append(("deep-salience", deep_salience))
        except ExternalBaselineUnavailable as exc:
            print_and_log(f"[deep-salience] SKIPPED: {exc}", args.log_path)

    return estimators


def build_eval_sets(args, cqt):
    from ..data.datasets.MixedMultiPitch import Bach10

    eval_sets = [Bach10(base_dir=args.bach10_dir, splits=None,
                        sample_rate=args.sample_rate, cqt=cqt)]
    if args.su_dir is not None:
        from ..data.datasets.MixedMultiPitch import Su

        eval_sets.append(Su(base_dir=args.su_dir, splits=None,
                            sample_rate=args.sample_rate, cqt=cqt))
    if args.gset_dir is not None:
        from ..data.datasets.SoloMultiPitch import GuitarSet

        eval_sets.append(GuitarSet(base_dir=args.gset_dir, splits=["05"],
                                   sample_rate=args.sample_rate, cqt=cqt))
    return eval_sets


def main(argv=None):
    """Compare as the command line ``argv`` says; prints and returns
    {set name: {method tag: mean results}}."""
    args = parse_args(argv)
    cqt = CQT(n_octaves=9, bins_per_octave=60,
              sample_rate=args.sample_rate, secs_per_block=3,
              device=args.device)

    estimators = build_estimators(args, cqt)
    out = {}
    for eval_set in build_eval_sets(args, cqt):
        print_and_log(f"Results for {eval_set.name()}:", args.log_path)
        out[eval_set.name()] = {
            tag: evaluate_method(eval_set, estimator, args.log_path,
                                 f"{eval_set.name()}/{tag}")
            for tag, estimator in estimators}
    return out


if __name__ == "__main__":
    main()

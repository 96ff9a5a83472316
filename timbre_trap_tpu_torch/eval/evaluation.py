"""Dataset evaluation (reference: experiments/evaluate.py).

Counterpart of ``timbre_trap_tpu/eval/evaluation.py``. Per track: a
full-length forward pass through the model's public ``forward`` (the NCHW
network, cuDNN convolutions in IEEE float32 on the card), transcription
activations -> peak mask (``ops/peaks.py:peak_mask``, kernel K2 on the
card) -> multi-pitch -> metric suite; reconstruction SDR via the
projection-filter SDR (every family but ``TimbreTrapMag`` and
``TimbreTrapMagDB``, which carry no phase); loss accounting; optional
TensorBoard logging of scalars and coefficient images.

Losses are reduced to scalars on the device and predictions leave it as a
uint8 mask; full-resolution activations and coefficients are copied to
the host only when a writer needs images.
"""

import warnings

import numpy as np
import torch

from ..data import constants
from ..data.note import NoteDataset
from ..data.pitch import PitchDataset
from ..device import ieee_convs
from ..models import TimbreTrapMag
from ..objectives import (compute_consistency_loss,
                          compute_reconstruction_loss,
                          compute_transcription_loss)
from ..ops.peaks import peak_mask
from ..transform import CQT
from ..transform.design import midi_to_hz
from ..utils import MultipitchEvaluator, to_array
from .multipitch import MAX_FREQ
from .sdr import signal_distortion_ratio

__all__ = ["evaluate", "masked_peak_estimates"]


def masked_peak_estimates(transcription, invalid_freqs):
    """Activations (1, F, T) -> peak-picked binary mask (F, T) numpy.

    Zeroes activations at invalid frequencies BEFORE peak-picking, as the
    reference does (evaluate.py:105-110): the order matters at boundary
    bins, where a removed activation can promote or suppress a neighboring
    peak. The any-positive check is a scalar reduced on the activations'
    device; only the uint8 mask is copied to the host.
    """
    transcription = torch.as_tensor(transcription)
    invalid = torch.as_tensor(np.asarray(invalid_freqs),
                              device=transcription.device)[None, :, None]
    if float(torch.sum(torch.where(invalid, transcription, 0.0))):
        warnings.warn("Positive activations were generated for "
                      "invalid frequencies.", RuntimeWarning)
        transcription = torch.where(invalid, 0.0, transcription)
    return to_array(peak_mask(transcription))[0].astype(np.float64)


def _avg_pool_time(array, k=7):
    """Average-pool the trailing (time) axis by factor k for visualization."""
    t = array.shape[-1] // k * k
    trimmed = array[..., :t]
    return trimmed.reshape(*trimmed.shape[:-1], t // k, k).mean(axis=-1)


@torch.no_grad()
def evaluate(model, eval_set, multipliers, writer=None, i=0):
    """Evaluate a model over every track of a dataset; returns mean results."""
    with ieee_convs(model.device):
        return _evaluate(model, eval_set, multipliers, writer, i)


def _evaluate(model, eval_set, multipliers, writer, i):
    evaluator = MultipitchEvaluator()

    # Frequency bins outside the valid multi-pitch range (reference :47-48).
    invalid_freqs = midi_to_hz(model.sliCQ.midi_freqs) > MAX_FREQ

    last_vis = None
    for data in eval_set:
        track = data[constants.KEY_TRACK]
        audio = np.asarray(data[constants.KEY_AUDIO], np.float32)[None]
        targets_np = np.asarray(data[constants.KEY_GROUND_TRUTH])[None]

        if isinstance(eval_set, NoteDataset):
            times_ref = data[constants.KEY_TIMES]
            pitches, intervals = eval_set.get_ground_truth(track)
            pitches = midi_to_hz(pitches)
            multi_pitch_ref = eval_set.notes_to_multi_pitch(
                pitches, intervals, times_ref)
        else:
            times_ref, multi_pitch_ref = eval_set.get_ground_truth(track)

        audio = np.pad(audio, [(0, 0), (0, 0), (0, -audio.shape[-1]
                                                % model.sliCQ.block_length)])
        audio_dev = torch.from_numpy(audio).to(model.device)

        coefficients = model.features_from_audio(audio_dev).movedim(-1, 1)

        reconstruction, latents, transcription_coeffs, trn_rec, trn_scr, \
            losses = model.forward(audio_dev, bool(multipliers["consistency"]))

        transcription = model.to_activations(transcription_coeffs)

        times_est = model.sliCQ.get_times(
            model.sliCQ.get_expected_frames(audio.shape[-1]))

        mask = masked_peak_estimates(transcription, invalid_freqs)

        multi_pitch_est = PitchDataset.activations_to_multi_pitch(
            mask, model.sliCQ.midi_freqs, peaks_only=False)

        results = evaluator.evaluate(times_est, multi_pitch_est,
                                     times_ref, multi_pitch_ref)
        evaluator.append_results(results)

        if not isinstance(model, TimbreTrapMag):
            synth = to_array(model.sliCQ.decode(reconstruction))
            sdr = signal_distortion_ratio(synth, audio)
            evaluator.append_results({"reconstruction/SDR": sdr})

        # --- loss accounting (only scalars leave the device) ------------
        reconstruction_loss = float(compute_reconstruction_loss(
            reconstruction, coefficients))

        n_pad = len(times_est) - targets_np.shape[-1]
        targets = torch.from_numpy(np.pad(
            targets_np, [(0, 0), (0, 0), (0, n_pad)]).astype(np.float32)
        ).to(model.device)
        transcription_loss = float(compute_transcription_loss(
            transcription, targets, True))

        total_loss = (multipliers["reconstruction"] * reconstruction_loss
                      + multipliers["transcription"] * transcription_loss)

        if multipliers["consistency"]:
            loss_sp, loss_sc = compute_consistency_loss(
                trn_rec, trn_scr, transcription_coeffs)
            consistency_loss = float(loss_sp) + float(loss_sc)
            evaluator.append_results({"loss/consistency": consistency_loss})
            total_loss += multipliers["consistency"] * consistency_loss

        for key_loss, val_loss in losses.items():
            evaluator.append_results({f"loss/{key_loss}": float(val_loss)})
            total_loss += multipliers.get(key_loss, 1) * float(val_loss)

        evaluator.append_results({"loss/reconstruction": reconstruction_loss,
                                  "loss/transcription": transcription_loss,
                                  "loss/total": total_loss})
        last_vis = (coefficients, reconstruction, transcription, targets)

    average_results, _ = evaluator.average_results()

    if writer is not None:
        for key, value in average_results.items():
            writer.add_scalar(f"{eval_set.name()}/{key}", value, i)
        if last_vis is not None:
            # Full-resolution copies to the host happen only here.
            coefficients, reconstruction, transcription, targets = last_vis
            feats_db = CQT.to_decibels(CQT.to_magnitude(coefficients))
            recon_db = CQT.to_decibels(CQT.to_magnitude(reconstruction))
            for tag, img in (("magnitude CQT", feats_db),
                             ("reconstruction", recon_db),
                             ("ground-truth", targets),
                             ("transcription", transcription)):
                pooled = _avg_pool_time(to_array(img))
                writer.add_image(f"{eval_set.name()}/vis/{tag}",
                                 pooled[..., ::-1, :][0][None], i)

    return average_results

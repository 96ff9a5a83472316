"""Round-over-round quality regression harness, the port's counterpart of
``timbre_trap_tpu/eval/quality.py``.

The reference's de-facto correctness test is validation F1 measured during
training (``experiments/train.py:502-532``). This module reproduces that
signal hermetically (no corpora needed): train a model on deterministic
synthetic polyphony through the port's train step, then score peak-picked
transcription F1 with the multipitch suite. On the card the steps run K1
and K3 (packed backends) and the score runs K1 (``transcribe``) and K2
(``peak_mask``), so a numerics regression anywhere in the transform /
model / training / peak-picking / metric stack shows up as an F1 drop that
unit tests can miss.
"""

import numpy as np
import torch

__all__ = ["synthesize_polyphony", "quality_f1", "BENCH_PROBES"]

# bench.py's frozen quality-probe configurations (its QUALITY-PROBE
# CONTRACT) on the flagship model: ``mpe_f1`` (consistency off) and
# ``mpe_f1_consistency`` (on, at the reference learning rate).
BENCH_PROBES = {
    "consistency_off": dict(n_tracks=8, steps=120, lr=2e-3, seed=0,
                            batch_size=4, conv_backend="pallas_bf16"),
    "consistency_on": dict(n_tracks=8, steps=240, lr=1e-3, seed=0,
                           batch_size=4, conv_backend="pallas_bf16",
                           multiplier_consistency=1.0)}


def synthesize_polyphony(cqt, n_tracks, seed=0, midi_range=None,
                         max_poly=3, n_harmonics=3):
    """Deterministic chord corpus on the model's own frequency grid.

    Returns ``(audio (N, 1, L), targets (N, F, M), freqs list-of-arrays)``:
    one sliCQ block per track, each a mix of ``1..max_poly`` harmonic tones
    at randomly drawn MIDI pitches, with the Gaussian-blurred ground-truth
    rasterization used for training targets (``data/pitch.py``). numpy
    only: the same arrays as the JAX package's, bit for bit.
    """
    from ..data.pitch import PitchDataset
    from ..transform.design import midi_to_hz

    rng = np.random.default_rng(seed)
    L = cqt.block_length
    M = cqt.get_expected_frames(L)
    midi_freqs = cqt.get_midi_freqs()
    if midi_range is None:
        # Stay inside the representable grid (with margin for the blur) and
        # under the multipitch suite's MAX_FREQ so GT == scoreable GT.
        from ..transform.design import hz_to_midi
        from .multipitch import MAX_FREQ

        lo = int(np.ceil(midi_freqs[2]))
        hi = int(min(midi_freqs[-3], float(hz_to_midi(MAX_FREQ)) - 1.0))
        midi_range = (lo, max(lo + 12, hi))
    t = np.arange(L) / cqt.sample_rate

    audio, targets, freqs = [], [], []
    for _ in range(n_tracks):
        n_notes = int(rng.integers(1, max_poly + 1))
        midis = rng.choice(np.arange(*midi_range), size=n_notes,
                           replace=False).astype(np.float64)
        hz = np.asarray(midi_to_hz(midis), dtype=np.float64)
        sig = np.zeros(L, np.float64)
        for f in hz:
            for h in range(1, n_harmonics + 1):
                if h * f >= cqt.sample_rate / 2:
                    break
                sig += (0.5 ** h) * np.sin(2 * np.pi * h * f * t)
        sig /= max(1e-9, np.abs(sig).max())
        audio.append(sig.astype(np.float32))
        targets.append(PitchDataset.multi_pitch_to_activations(
            [hz] * M, midi_freqs).astype(np.float32))
        freqs.append(hz)
    return (np.stack(audio)[:, None, :], np.stack(targets), freqs)


def quality_f1(model, n_tracks=8, steps=120, lr=2e-3, seed=0,
               batch_size=None, conv_backend="flax",
               multiplier_consistency=0.0):
    """Train ``model`` on synthetic polyphony and return its ``mpe/f1-score``.

    Mirrors the reference training-validation loop in miniature: seeded
    train step (``train.make_train_step``; consistency off by default, for
    speed -- pass ``multiplier_consistency=1.0`` to exercise the
    consistency-branch gradients of the flagship recipe), then one
    ``transcribe`` of every track -> invalid bins zeroed -> ``peak_mask``
    -> multipitch metrics, the evaluation path of ``eval/evaluation.py``.
    Runs where the model lies (the card unless it was built on the CPU).
    Deterministic given (model weights, seed, steps).

    On the ``"flax"`` backend a model without ``remat`` trains a remat twin
    built from ``seed`` (the JAX package's rule; the twin's weights are
    drawn by the port's initialisers) and is scored with the twin's trained
    weights. The model's parameters are as they were after the call.
    """
    from ..data.pitch import PitchDataset
    from ..ops.peaks import peak_mask
    from ..train import TrainConfig, init_train_state, make_train_step
    from ..transform.design import midi_to_hz
    from ..utils import MultipitchEvaluator, to_array
    from .multipitch import MAX_FREQ

    audio, targets, freqs = synthesize_polyphony(model.sliCQ, n_tracks, seed)
    batch = batch_size or n_tracks
    device = model.device

    train_model = model
    if conv_backend == "flax" and not model.net.remat:
        # Flagship-size training needs rematerialized backward boundaries
        # to fit device memory; train on a remat twin, score on the
        # caller's model (identical forward math, same parameter names).
        hp = {k: v for k, v in model.hparams.items() if k != "variant"}
        train_model = type(model)(seed=seed, remat=True, fused=model.fused,
                                  device=device, **hp)

    cfg = TrainConfig(multiplier_consistency=multiplier_consistency)
    step = make_train_step(train_model, cfg, mpe_batch_size=batch,
                           conv_backend=conv_backend)
    saved = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
    try:
        opt = init_train_state(train_model, cfg)
        audio_d = torch.from_numpy(audio).to(device)
        targets_d = torch.from_numpy(targets).to(device)
        order = np.random.default_rng(seed + 1)
        for _ in range(steps):
            idx = torch.from_numpy(order.permutation(n_tracks)[:batch])
            idx = idx.to(device)
            metrics = step(opt, audio_d[idx], targets_d[idx], lr)
        if not np.isfinite(float(metrics["loss/total"])):
            return 0.0

        if train_model is not model:
            model.load_state_dict(train_model.net.state_dict())
        invalid = torch.as_tensor(midi_to_hz(model.sliCQ.midi_freqs)
                                  > MAX_FREQ, device=device)
        acts = model.transcribe(audio_d)                # (N, F, T)
        acts = torch.where(invalid[None, :, None], 0.0, acts)
        masks = to_array(peak_mask(acts)).astype(np.float64)
    finally:
        model.load_state_dict(saved)
        for p in model.net.parameters():
            p.grad = None

    evaluator = MultipitchEvaluator()
    times = model.sliCQ.get_times(
        model.sliCQ.get_expected_frames(audio.shape[-1]))
    for i in range(n_tracks):
        est = PitchDataset.activations_to_multi_pitch(
            masks[i], model.sliCQ.midi_freqs, peaks_only=False)
        ref = [np.asarray(freqs[i], np.float64)] * len(times)
        evaluator.append_results(
            evaluator.evaluate(times, est, times, ref))
    mean, _ = evaluator.average_results()
    return float(mean["mpe/f1-score"])

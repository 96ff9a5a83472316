"""Sonify model outputs for Bach10 on the card (the port's counterpart of the
JAX package's ``experiments/sonify.py``; reference: experiments/sonify.py).

For each track writes three WAV files: ``*_ref.wav`` (pure invertible-CQT
round trip), ``*_rec.wav`` (decoded model reconstruction) and ``*_scr.wav``
(decoded — "sonified" — transcription coefficients).

Example:
    python -m timbre_trap_tpu_torch.experiments.sonify \\
        --checkpoint runs/base/models/model-250 --bach10-dir /data/Bach10
"""

import argparse
import os

import numpy as np
import torch

from ..data import constants
from ..data.io import save_wav
from ..models import load_model
from ..utils import to_array

__all__ = ["main"]


def main(argv=None):
    """Sonify as the command line ``argv`` says."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--bach10-dir", default=None)
    p.add_argument("--output-dir", default=os.path.join("generated", "sonify"))
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--n-octaves", type=int, default=9)
    p.add_argument("--bins-per-octave", type=int, default=60)
    p.add_argument("--latent-size", type=int, default=128)
    p.add_argument("--model-complexity", type=int, default=2)
    p.add_argument("--stems", action="store_true",
                   help="process Bach10 stems instead of mixtures")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the kernels' plain PyTorch versions on "
                        "the CPU; default the card (no card raises)")
    args = p.parse_args(argv)

    model = load_model(
        args.checkpoint,
        overrides=dict(device=args.device),
        defaults=dict(sample_rate=args.sample_rate,
                      n_octaves=args.n_octaves,
                      bins_per_octave=args.bins_per_octave, secs_per_block=3,
                      latent_size=args.latent_size,
                      model_complexity=args.model_complexity))

    if args.stems:
        from ..data.datasets.SoloMultiPitch import Bach10
    else:
        from ..data.datasets.MixedMultiPitch import Bach10

    eval_set = Bach10(base_dir=args.bach10_dir, splits=None,
                      sample_rate=args.sample_rate, cqt=model.sliCQ)
    os.makedirs(args.output_dir, exist_ok=True)

    def write(track, kind, coefficients):
        audio = to_array(model.sliCQ.decode(coefficients))[0]
        save_wav(os.path.join(args.output_dir, f"{track}_{kind}.wav"),
                 audio, args.sample_rate)

    for data in eval_set:
        track = data[constants.KEY_TRACK].replace(os.sep, "-")
        audio = torch.from_numpy(np.asarray(data[constants.KEY_AUDIO])[None])
        audio = model.sliCQ.pad_to_block_length(audio)

        # Pure transform round trip
        write(track, "ref", model.sliCQ.encode(audio))
        # Decoded reconstruction
        write(track, "rec", model.inference(audio, transcribe=False))
        # Sonified transcription
        write(track, "scr", model.inference(audio, transcribe=True))
        print(f"sonified {track}")


if __name__ == "__main__":
    main()

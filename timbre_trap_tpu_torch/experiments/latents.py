"""Visualize time-averaged stem latents with t-SNE, on the card (the port's
counterpart of the JAX package's ``experiments/latents.py``; reference:
experiments/latents.py).

Computes the latent code of each Bach10 stem (``collect_latents``),
averages it over time, and saves a 2-D t-SNE scatter colored by instrument
(``utils.visualization.plot_latents``: needs matplotlib and scikit-learn).

Example:
    python -m timbre_trap_tpu_torch.experiments.latents \\
        --checkpoint runs/base/models/model-250 --bach10-dir /data/Bach10
"""

import argparse
import os

import numpy as np
import torch

from ..data import constants
from ..device import ieee_convs
from ..models import load_model
from ..utils import to_array

__all__ = ["collect_latents", "main"]


@torch.no_grad()
def collect_latents(model, eval_set):
    """The time-averaged latent code (D,) of every track of ``eval_set``
    through ``model.encode`` (float32 NCHW network, cuDNN in IEEE float32
    on the card) and each track's instrument label (the last ``-`` field of
    its name): returns ``(latents (n_tracks, D) numpy, labels)``."""
    latents, labels = [], []
    with ieee_convs(model.device):
        for data in eval_set:
            track = data[constants.KEY_TRACK]
            audio = np.asarray(data[constants.KEY_AUDIO], np.float32)[None]
            audio = torch.from_numpy(audio).to(model.device)
            z, _, _ = model.encode(model.sliCQ.pad_to_block_length(audio))
            latents.append(to_array(z[0].mean(dim=-1)))
            labels.append(track.split("-")[-1])
            print(f"encoded {track}")
    return np.stack(latents), labels


def main(argv=None):
    """Plot the latents as the command line ``argv`` says; returns the
    output path."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--bach10-dir", default=None)
    p.add_argument("--output", default=os.path.join("generated",
                                                    "latents.pdf"))
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--n-octaves", type=int, default=9)
    p.add_argument("--bins-per-octave", type=int, default=60)
    p.add_argument("--latent-size", type=int, default=128)
    p.add_argument("--model-complexity", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cpu' runs on the CPU; default the card (no card "
                        "raises)")
    args = p.parse_args(argv)

    model = load_model(
        args.checkpoint, overrides=dict(device=args.device),
        defaults=dict(sample_rate=args.sample_rate,
                      n_octaves=args.n_octaves,
                      bins_per_octave=args.bins_per_octave, secs_per_block=3,
                      latent_size=args.latent_size,
                      model_complexity=args.model_complexity))

    from ..data.datasets.SoloMultiPitch import Bach10
    from ..utils.visualization import plot_latents

    eval_set = Bach10(base_dir=args.bach10_dir, splits=None,
                      sample_rate=args.sample_rate, cqt=model.sliCQ)
    latents, labels = collect_latents(model, eval_set)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    plot_latents(latents, labels, seed=args.seed, save_path=args.output)
    print(f"saved {args.output}")
    return args.output


if __name__ == "__main__":
    main()

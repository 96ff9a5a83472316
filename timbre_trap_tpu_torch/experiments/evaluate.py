"""Evaluate a checkpoint on the standard evaluation sets, on the card (the
port's counterpart of the JAX package's ``experiments/evaluate.py``).

Example:
    python -m timbre_trap_tpu_torch.experiments.evaluate \\
        --checkpoint runs/base/models/model-250 --datasets Bach10 URMP
"""

import argparse

from ..eval.evaluation import evaluate
from ..models import load_model
from ..utils import print_and_log
from .train import URMP_VAL_SPLITS

__all__ = ["DATASETS", "evaluation_set", "main"]

DATASETS = ["Bach10", "URMP", "Su", "TRIOS", "GuitarSet"]


def evaluation_set(name, base_dir, sample_rate, cqt):
    """The evaluation set the CLI names ``name`` (one of ``DATASETS``): the
    mixtures of Bach10, URMP (its validation pieces), Su and TRIOS, and
    GuitarSet's player 05."""
    from ..data.datasets.MixedMultiPitch import URMP, Bach10, Su, TRIOS
    from ..data.datasets.SoloMultiPitch import GuitarSet

    # (wrapper, splits) per name; None means every split.
    cls, splits = {"Bach10": (Bach10, None),
                   "URMP": (URMP, URMP_VAL_SPLITS),
                   "Su": (Su, None),
                   "TRIOS": (TRIOS, None),
                   "GuitarSet": (GuitarSet, ["05"])}[name]
    return cls(base_dir=base_dir, splits=splits, sample_rate=sample_rate,
               cqt=cqt)


def main(argv=None):
    """Evaluate as the command line ``argv`` says; prints and returns
    {dataset: results}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--datasets", nargs="+", default=["Bach10"],
                   choices=DATASETS)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--n-octaves", type=int, default=9)
    p.add_argument("--bins-per-octave", type=int, default=60)
    p.add_argument("--latent-size", type=int, default=128)
    p.add_argument("--model-complexity", type=int, default=2)
    p.add_argument("--skip-connections", action="store_true", default=None,
                   help="override for legacy checkpoints without "
                        "hparams.json (hparams-carrying checkpoints "
                        "rebuild their trained configuration themselves)")
    p.add_argument("--variant", default=None,
                   choices=["base", "film", "mag", "magdb"],
                   help="override for legacy checkpoints (see above)")
    p.add_argument("--base-dirs", nargs="*", default=None,
                   help="base dir per dataset, aligned with --datasets")
    p.add_argument("--compat", default=None,
                   choices=["native", "cqt_pytorch"],
                   help="transform frame; 'cqt_pytorch' evaluates weights "
                        "trained on the reference frame. Default: the "
                        "checkpoint's trained frame (else native)")
    p.add_argument("--tables", default=None,
                   help=".npz of measured cqt_pytorch tables "
                        "(transform.save_tables); default: analytic "
                        "compat construction")
    p.add_argument("--log-path", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the kernels' plain PyTorch versions on "
                        "the CPU; default the card (no card raises)")
    args = p.parse_args(argv)

    tables = None
    if args.tables:
        from ..transform import load_tables
        tables = load_tables(args.tables)

    model = load_model(
        args.checkpoint,
        overrides=dict(transform_compat=args.compat, compat_tables=tables,
                       skip_connections=args.skip_connections,
                       variant=args.variant, device=args.device),
        defaults=dict(sample_rate=args.sample_rate,
                      n_octaves=args.n_octaves,
                      bins_per_octave=args.bins_per_octave, secs_per_block=3,
                      latent_size=args.latent_size,
                      model_complexity=args.model_complexity))

    multipliers = {"reconstruction": 1, "transcription": 1, "consistency": 1}
    base_dirs = args.base_dirs or [None] * len(args.datasets)
    out = {}
    for name, base in zip(args.datasets, base_dirs):
        eval_set = evaluation_set(name, base, args.sample_rate, model.sliCQ)
        out[name] = evaluate(model, eval_set, multipliers)
        print_and_log(f"[{name}] {out[name]}", args.log_path)
    return out


if __name__ == "__main__":
    main()

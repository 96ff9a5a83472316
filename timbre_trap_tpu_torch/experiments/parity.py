"""One-command BASELINE parity table for the released reference checkpoint,
on the card (the port's counterpart of the JAX package's
``experiments/parity.py``).

Reproduces the reference evaluation protocol
(``reference/experiments/evaluate.py:29-48,113-127``) with the released
``tt-orig.pt`` weights:

    python -m timbre_trap_tpu_torch.experiments.parity \\
        --checkpoint /path/to/tt-orig.pt \\
        --datasets Bach10 URMP Su TRIOS GuitarSet \\
        --base-dirs /data/Bach10 /data/URMP /data/Su /data/TRIOS /data/GuitarSet \\
        --out parity_results.json

The model runs on the ``cqt_pytorch``-compatible transform frame
(``transform/design.py:design_cqt_pytorch``) -- the frame the checkpoint was
trained on. The checkpoint is read by ``interop.load_torch_checkpoint`` (a
bare state_dict or a whole-module save), imported into the flax layout and
validated against the model's parameters (``import_torch_state_dict``: a
missing, extra or misshapen tensor raises), then loaded under the port's
module names (``state_dict_from_jax``), so both reference-named keys
(``encoder.convin.0.weight``) and keys exported without them
(``encoder.convin.weight``) load. Pass ``--tables`` (from
``transform.calibrate``) to pin the frame to a measured install of the
``cqt_pytorch`` package instead of the analytic rebuild.

Emits one row per evaluation set -- MPE F1 (0.5-semitone tolerance) and
reconstruction SDR -- the "Parity targets" table of ``BASELINE.md``.
"""

import argparse
import json

from ..eval.evaluation import evaluate
from ..interop import (hwio_params, import_torch_state_dict,
                       load_torch_checkpoint, state_dict_from_jax)
from ..models import TimbreTrap
from ..utils import print_and_log
from .evaluate import DATASETS, evaluation_set

__all__ = ["load_checkpoint_into", "main"]


def load_checkpoint_into(model, path):
    """Load the torch checkpoint at ``path`` into ``model`` through the
    importer (validated against the model's parameters); returns the number
    of tensors read."""
    state_dict = load_torch_checkpoint(path)
    params = import_torch_state_dict(state_dict, hwio_params(model.net))
    model.load_state_dict(state_dict_from_jax(params))
    return len(state_dict)


def main(argv=None):
    """Build the parity table as the command line ``argv`` says; prints it
    and returns {dataset: results}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="released reference .pt checkpoint (tt-orig.pt)")
    p.add_argument("--datasets", nargs="+", default=list(DATASETS),
                   choices=DATASETS)
    p.add_argument("--base-dirs", nargs="*", default=None,
                   help="base dir per dataset, aligned with --datasets")
    p.add_argument("--tables", default=None,
                   help=".npz of measured cqt_pytorch tables "
                        "(transform.save_tables); default: analytic "
                        "compat construction")
    p.add_argument("--compat", default="cqt_pytorch",
                   choices=["cqt_pytorch", "native"],
                   help="transform frame; 'native' quantifies how much the "
                        "checkpoint depends on the training frame")
    # Released-model hyperparameters (reference experiments/train.py:39-161).
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--n-octaves", type=int, default=9)
    p.add_argument("--bins-per-octave", type=int, default=60)
    p.add_argument("--secs-per-block", type=float, default=3.0)
    p.add_argument("--latent-size", type=int, default=128)
    p.add_argument("--model-complexity", type=int, default=2)
    p.add_argument("--out", default=None, help="write results JSON here")
    p.add_argument("--log-path", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the kernels' plain PyTorch versions on "
                        "the CPU; default the card (no card raises)")
    args = p.parse_args(argv)

    tables = None
    if args.tables:
        from ..transform import load_tables
        tables = load_tables(args.tables)

    model = TimbreTrap(
        sample_rate=args.sample_rate, n_octaves=args.n_octaves,
        bins_per_octave=args.bins_per_octave,
        secs_per_block=args.secs_per_block, latent_size=args.latent_size,
        model_complexity=args.model_complexity,
        transform_compat=args.compat, compat_tables=tables,
        device=args.device)

    n = load_checkpoint_into(model, args.checkpoint)
    print_and_log(f"imported {n} tensors from {args.checkpoint} onto the "
                  f"{args.compat} frame", args.log_path)

    base_dirs = args.base_dirs or [None] * len(args.datasets)
    if len(base_dirs) != len(args.datasets):
        raise SystemExit("--base-dirs must align with --datasets")

    multipliers = {"reconstruction": 1, "transcription": 1, "consistency": 1}
    table = {}
    for name, base in zip(args.datasets, base_dirs):
        eval_set = evaluation_set(name, base, args.sample_rate, model.sliCQ)
        results = evaluate(model, eval_set, multipliers)
        table[name] = {k: float(v) for k, v in results.items()}
        print_and_log(f"[{name}] f1={results.get('mpe/f1-score', float('nan')):.4f} "
                      f"sdr={results.get('reconstruction/SDR', float('nan')):.2f} dB",
                      args.log_path)

    print_and_log("| set | mpe/f1-score | reconstruction SDR (dB) |",
                  args.log_path)
    print_and_log("|---|---|---|", args.log_path)
    for name, res in table.items():
        print_and_log(
            f"| {name} | {res.get('mpe/f1-score', float('nan')):.4f} "
            f"| {res.get('reconstruction/SDR', float('nan')):.2f} |",
            args.log_path)

    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"checkpoint": args.checkpoint, "compat": args.compat,
                       "results": table}, fh, indent=2)
        print_and_log(f"wrote {args.out}", args.log_path)
    return table


if __name__ == "__main__":
    main()

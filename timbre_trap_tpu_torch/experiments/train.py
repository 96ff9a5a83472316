"""Train a Timbre-Trap model on the card (the port's counterpart of the JAX
package's ``experiments/train.py``; reference: experiments/train.py).

Dataset assembly follows the reference recipe: URMP mixtures for MPE
training (debug mode uses the URMP validation mixtures only), URMP
validation split per MT3, and TRIOS / Bach10 / Su / GuitarSet player 05 as
additional validation sets. Config is argparse + JSON dump (the sacred
replacement); logging goes to TensorBoard via tensorboardX where it is
installed, else nowhere.

Example:
    python -m timbre_trap_tpu_torch.experiments.train --root-dir runs/base \\
        --debug --urmp-dir /data/URMP

Data-parallel over N cards of one machine, one process per card (the JAX
CLI drives N devices from one process):
    torchrun --nproc-per-node N -m timbre_trap_tpu_torch.experiments.train \\
        --n-devices N --distributed --root-dir runs/base --debug ...
"""

import argparse
import os

import torch

from ..data import ComboDataset, DataLoader
from ..models import TimbreTrap
from ..parallel import initialize
from ..parallel.distributed import process_count, process_index
from ..parallel.mesh import torchrun_hint
from ..train import Trainer, TrainerConfig, load_checkpoint
from ..utils import seed_everything

__all__ = ["URMP_VAL_SPLITS", "parse_args", "main"]

# URMP validation set per the MT3 paper (reference train.py:177).
URMP_VAL_SPLITS = ["01", "02", "12", "13", "24", "25", "31", "38", "39"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root-dir", default=os.path.join("generated",
                                                      "experiments", "Base"))
    p.add_argument("--checkpoint-path", default=None)
    p.add_argument("--max-epochs", type=int, default=5000)
    p.add_argument("--checkpoint-interval", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--n-secs", type=float, default=9)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--mult-reconstruction", type=float, default=1)
    p.add_argument("--mult-transcription", type=float, default=1)
    p.add_argument("--mult-consistency", type=float, default=1)
    p.add_argument("--n-epochs-warmup", type=int, default=50)
    p.add_argument("--n-epochs-late-start", type=int, default=0)
    p.add_argument("--n-epochs-decay", type=int, default=500)
    p.add_argument("--n-epochs-cooldown", type=int, default=100)
    p.add_argument("--n-epochs-early-stop", type=int, default=None)
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel over N devices: N processes, one per "
                        "device, of one torch.distributed group (start them "
                        "with torchrun --nproc-per-node N and --distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun describes "
                        "(parallel.initialize: NCCL on the card, gloo on the "
                        "CPU); each rank then loads only its rows of the "
                        "global batch (parallel.plan_local_rows)")
    p.add_argument("--conv-backend", default="pallas_bf16",
                   choices=["pallas_bf16", "pallas", "packed", "flax"],
                   help="train-step conv path: 'pallas_bf16' (the "
                        "hand-written conv-chain kernels and their backward, "
                        "bf16 storage / f32 accumulation), 'pallas' (the "
                        "same kernels in float32), 'packed' (their plain "
                        "PyTorch versions) or 'flax' (autograd through the "
                        "NCHW network)")
    p.add_argument("--skip-connections", action="store_true",
                   help="learnable per-level encoder->decoder skips "
                        "(reference modules.py:61-66); supported on every "
                        "conv backend")
    p.add_argument("--weight-decay", type=float, default=0.01,
                   help="AdamW weight decay (reference train.py:334)")
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help="average gradients over k steps before the update")
    p.add_argument("--no-compact-uploads", action="store_true",
                   help="disable int16/uint8 batch-upload quantization")
    p.add_argument("--audio-datasets", default="",
                   help="comma-separated audio-only corpora mixed into each "
                        "batch: fma, medleydb_mixtures, medleydb_stems "
                        "(reference train.py:196-255; when set, the batch "
                        "and workers split half MPE / half audio-only per "
                        "train.py:261-270)")
    p.add_argument("--fma-dir", default=None)
    p.add_argument("--medleydb-dir", default=None)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--n-octaves", type=int, default=9)
    p.add_argument("--bins-per-octave", type=int, default=60)
    p.add_argument("--n-workers", type=int, default=8)
    p.add_argument("--debug", action="store_true",
                   help="lightweight setup: URMP validation mixtures only")
    p.add_argument("--urmp-dir", default=None)
    p.add_argument("--bach10-dir", default=None)
    p.add_argument("--su-dir", default=None)
    p.add_argument("--trios-dir", default=None)
    p.add_argument("--gset-dir", default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the kernels' plain PyTorch versions on "
                        "the CPU; default this rank's card (no card raises)")
    return p.parse_args(argv)


def main(argv=None):
    """Train as the command line ``argv`` says; returns the Trainer's
    (best checkpoint, best results)."""
    args = parse_args(argv)
    if args.distributed:
        initialize()
    if args.n_devices not in (None, process_count()):
        raise SystemExit(
            f"--n-devices {args.n_devices}: this process has "
            f"{process_count()} rank(s); each device is one process. Start "
            f"them as: {torchrun_hint(args.n_devices)}")
    device = args.device
    if device is None and torch.distributed.is_initialized() \
            and torch.cuda.is_available():
        device = f"cuda:{torch.cuda.current_device()}"
    seed_everything(args.seed)

    model = TimbreTrap(sample_rate=args.sample_rate, n_octaves=args.n_octaves,
                       bins_per_octave=args.bins_per_octave, secs_per_block=3,
                       latent_size=128, model_complexity=2,
                       skip_connections=args.skip_connections, seed=args.seed,
                       # remat matters only for the "flax" backend; the
                       # packed backends checkpoint each level themselves.
                       remat=(args.conv_backend == "flax"), device=device)

    if args.checkpoint_path is not None:
        state = load_checkpoint(args.checkpoint_path)
        model.load_state_dict(state["params"])

    from ..data.datasets.MixedMultiPitch import (
        URMP as URMP_Mixtures, Bach10 as Bach10_Mixtures, Su, TRIOS)
    from ..data.datasets.SoloMultiPitch import GuitarSet

    urmp_train_splits = [s for s in URMP_Mixtures.available_splits()
                         if s not in URMP_VAL_SPLITS]

    mpe_train = [URMP_Mixtures(
        base_dir=args.urmp_dir,
        splits=URMP_VAL_SPLITS if args.debug else urmp_train_splits,
        sample_rate=args.sample_rate, cqt=model.sliCQ,
        n_secs=args.n_secs, seed=args.seed)]

    # Audio-only corpora (reconstruction-only rows appended to each batch —
    # reference train.py:196-255, where they are present but commented out).
    # When requested, batch and workers split half MPE / half audio-only
    # (train.py:261-270).
    audio_train = []
    for name in filter(None, args.audio_datasets.split(",")):
        if name == "fma":
            from ..data.datasets.AudioMixtures import FMA as cls
            base_dir = args.fma_dir
        elif name == "medleydb_mixtures":
            from ..data.datasets.AudioMixtures import MedleyDB as cls
            base_dir = args.medleydb_dir
        elif name == "medleydb_stems":
            from ..data.datasets.AudioStems import MedleyDB as cls
            base_dir = args.medleydb_dir
        else:
            raise SystemExit(f"unknown --audio-datasets entry: {name!r}")
        audio_train.append(cls(base_dir=base_dir, splits=None,
                               sample_rate=args.sample_rate,
                               n_secs=args.n_secs, seed=args.seed))

    if audio_train:
        if args.batch_size < 2:
            raise SystemExit("--audio-datasets splits the batch half MPE / "
                             "half audio-only (reference train.py:261-270); "
                             "--batch-size must be >= 2")
        audio_batch_size = args.batch_size // 2
        audio_workers = args.n_workers // 2
    else:
        audio_batch_size, audio_workers = 0, 0
    mpe_batch_size = args.batch_size - audio_batch_size
    mpe_workers = args.n_workers - audio_workers

    mpe_loader = DataLoader(ComboDataset(mpe_train),
                            batch_size=mpe_batch_size, shuffle=True,
                            num_workers=mpe_workers, drop_last=True,
                            seed=args.seed)
    if audio_train:
        audio_loader = DataLoader(ComboDataset(audio_train),
                                  batch_size=audio_batch_size, shuffle=True,
                                  num_workers=audio_workers, drop_last=True,
                                  seed=args.seed + 1)
    else:
        audio_loader = None

    validation_sets = [URMP_Mixtures(
        base_dir=args.urmp_dir, splits=URMP_VAL_SPLITS,
        sample_rate=args.sample_rate, cqt=model.sliCQ, seed=args.seed)]
    if not args.debug:
        for cls, base, splits in ((TRIOS, args.trios_dir, None),
                                  (Bach10_Mixtures, args.bach10_dir, None),
                                  (Su, args.su_dir, None),
                                  (GuitarSet, args.gset_dir, ["05"])):
            try:
                validation_sets.append(cls(base_dir=base, splits=splits,
                                           sample_rate=args.sample_rate,
                                           cqt=model.sliCQ, seed=args.seed))
            except Exception as e:  # dataset not present locally
                print(f"skipping validation set {cls.__name__}: {e}")

    config = TrainerConfig(
        max_epochs=args.max_epochs,
        checkpoint_interval=args.checkpoint_interval,
        batch_size=args.batch_size,
        n_secs=args.n_secs,
        learning_rate=args.learning_rate,
        multipliers={"reconstruction": args.mult_reconstruction,
                     "transcription": args.mult_transcription,
                     "consistency": args.mult_consistency},
        n_epochs_warmup=args.n_epochs_warmup,
        validation_criteria_set=validation_sets[0].name(),
        n_epochs_late_start=args.n_epochs_late_start,
        n_epochs_decay=args.n_epochs_decay,
        n_epochs_cooldown=args.n_epochs_cooldown,
        n_epochs_early_stop=args.n_epochs_early_stop,
        n_devices=args.n_devices,
        conv_backend=args.conv_backend,
        weight_decay=args.weight_decay,
        grad_accum_steps=args.grad_accum_steps,
        compact_uploads=not args.no_compact_uploads,
        seed=args.seed,
        root_dir=args.root_dir,
    )

    writer = None
    if process_index() == 0:  # one rank logs (the metrics are global)
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(os.path.join(args.root_dir, "models"))
        except ImportError:
            pass

    trainer = Trainer(model, mpe_loader, audio_loader, validation_sets,
                      config, writer=writer)
    best_ckpt, best_results = trainer.run()
    print(f"Achieved best results at {best_ckpt} iterations...")
    for name, results in (best_results or {}).items():
        print(f"[{name}] {results}")
    return best_ckpt, best_results


if __name__ == "__main__":
    main()

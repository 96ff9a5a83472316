"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 11 12 ...
        [--program-only] [--look]

For each seed, in one process: the program's numbers on the requests the
check compares (a run's own sample, its requests driven in order until
each is done) or, for training, on the first steps set-up runs; then the
control's, the reference computed one precision below what the
configuration states (``reference/precision.py``) in the program's
place, on the same requests or steps; and for training the planted fault
of half the batch left out (the reference on the other half, the mean
taken over it). One JSON line a seed. The benchmark's own runs never run
this. Needs a CUDA device.

Training readings are wider than what a run compares: every objective's
gap at the first and at the worst step, and by leaf the worst and the
median gap of norms and norm of the difference, with the worst leaf's
name. ``--look`` adds two witnesses of where the program's gaps come
from: the program's float32 step (``conv_backend`` "pallas") against the
reference, and the reference with the convs' operands and cotangents
rounded to bfloat16 (the precision the bfloat16 step stores them in)
against the float32 reference.
"""

import argparse
import copy
import json
import sys

import numpy as np
import torch


def _loss_gap(p, r, key):
    return abs(p[key] - r[key]) / max(abs(r[key]), 1e-30)


def train_readings(prog, ref, weights):
    """Every training number of ``prog`` against ``ref`` (each a triple of
    losses, first gradients and parameters after the steps)."""
    from . import bench
    from .reference.model import OBJECTIVES

    losses_p, grads_p, after_p = prog
    losses_r, grads_r, after_r = ref
    out = {}
    for key in OBJECTIVES:
        gaps = [_loss_gap(p, r, key) for p, r in zip(losses_p, losses_r)]
        name = key.split("/", 1)[1].replace("/", "_")
        out[f"loss_first.{name}"] = gaps[0]
        out[f"loss_worst.{name}"] = max(gaps)
    moved = bench.moved_leaves(grads_r)
    for what, table in (
            ("grad", bench.leaf_gaps(grads_p, grads_r, sorted(grads_r))),
            ("change", bench.leaf_gaps(
                {k: after_p[k] - weights[k] for k in moved},
                {k: after_r[k] - weights[k] for k in moved}, moved))):
        gaps = {k: g for k, (g, _) in table.items()}
        diffs = {k: d for k, (_, d) in table.items()}
        worst_gap = max(gaps, key=gaps.get)
        worst_diff = max(diffs, key=diffs.get)
        out[f"{what}_gap_worst"] = gaps[worst_gap]
        out[f"{what}_gap_worst_leaf"] = worst_gap
        out[f"{what}_gap_median"] = float(np.median(list(gaps.values())))
        out[f"{what}_diff_worst"] = diffs[worst_diff]
        out[f"{what}_diff_worst_leaf"] = worst_diff
        out[f"{what}_diff_median"] = float(np.median(list(diffs.values())))
    out["left_out_leaves"] = len(grads_r) - len(moved)
    return out


def _train(cell, seed, device, program, with_control, look):
    from . import bench
    from .reference.precision import ROUNDINGS

    spans = bench._Spans(False)
    runner = bench.Train(cell, seed, device, program, spans)
    runner.free()
    ref = runner.reference_run()
    out = {"seed": seed}

    def add(name, side):
        out[name] = bench.train_numbers(side, ref, runner.weights)
        out[name + "_all"] = train_readings(side, ref, runner.weights)

    add("program", (runner.first_losses, runner.first_grads, runner.after))
    if with_control:
        add("control", runner.reference_run(
            quant=ROUNDINGS[cell.config["control"]["train"]]))
        m, a = cell.traffic["mpe_crops"], cell.traffic["audio_crops"]
        add("half_batch", runner.reference_run(
            rows=list(range(m // 2)) + list(range(m, m + a // 2))))
    if look:
        add("reference_bf16", runner.reference_run(quant=ROUNDINGS["bf16"]))
        f32 = copy.copy(cell)
        f32.traffic = dict(cell.traffic, conv_backend="pallas")
        other = bench.Train(f32, seed, device, program, spans)
        other.free()
        add("program_f32", (other.first_losses, other.first_grads,
                            other.after))
    return out


def readings(cell, seed, device, program, with_control=True, look=False):
    from . import bench
    from .reference.model import peak_mask as plain_peak_mask
    from .reference.precision import ROUNDINGS

    if cell.traffic["kind"] == "train":
        return _train(cell, seed, device, program, with_control, look)
    spans = bench._Spans(False)
    runner = bench.Inference(cell, seed, device, program, spans)
    out = {"seed": seed}
    rounding = ROUNDINGS[cell.config["control"][runner.kind]]
    for i in range(max(runner.check_ids) + 1):
        runner.request(i)
    runner.free()
    out["program"] = runner.numbers()
    if with_control:
        from .reference.model import Reference

        ctl = Reference(cell.config, runner.weights, device, rounding)
        kept = {}
        for i in runner.check_ids:
            clip = runner.clip(i)
            if runner.kind == "transcribe":
                act = ctl.activations(clip)
                kept[i] = (act, plain_peak_mask(act).cpu())
            else:
                kept[i] = (ctl.reconstruct(clip).cpu(),)
        runner.kept = kept
        out["control"] = runner.numbers()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--look", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from . import program, spec

    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        r = readings(cell, seed, torch.device("cuda", 0), program,
                     not args.program_only, args.look)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a training step's time goes on the card.

    python -m timbre_trap_tpu_torch.tools.profile_train_step [--steps N]
        [--trace PATH]

Builds the flagship base model (22.05 kHz, 9 x 60 bins, 3-s blocks, latent
128, complexity 2, random weights of seed 1) and the recipe batch that
``chip_smoke.py`` trains on (``train.synthetic_batch``: 8 chord-and-noise
9-s crops as compact int16, sparse uint8 ground truth, seed 0), runs two
warm-up ``"pallas_bf16"`` steps, then:

1. phases: the parts of ``make_train_step``'s step (``step.parts``; the
   step defines them) run one after another with a synchronize after each,
   host clock, mean of ``--steps`` steps;
2. kernels: ``torch.profiler`` over ``--steps`` whole steps; the device
   time summed by kernel group, the device busy share (the union of kernel
   intervals over the profiled wall time) and launches per step.

Prints one JSON line with both and the card's name and power limit. Needs
a CUDA device; exits non-zero without one.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

BACKEND = "pallas_bf16"
# (group, substring of the kernel's name), first match wins; the port's
# kernels live in an anonymous namespace of their .cu file.
_OURS = "(anonymous namespace)::"
GROUPS = (("K3 dW partial", _OURS + "banded_conv_dw_partial_kernel"),
          ("K3 dW reduce", _OURS + "banded_conv_dw_reduce_kernel"),
          ("K3 dX", _OURS + "banded_conv_dx_kernel"),
          ("K3 ELU seed", _OURS + "elu_backward_kernel<"),
          ("K1 banded conv", _OURS + "banded_conv_kernel"),
          ("cuFFT", "fft"), ("matmul", "gemm"), ("matmul", "cutlass"),
          ("index", "index"), ("reduce", "reduce"))


def _group(name):
    low = name.lower()
    for group, key in GROUPS:
        if key.lower() in low:
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    from ..models import TimbreTrap
    from ..train import (TrainConfig, init_train_state, make_train_step,
                         synthetic_batch)

    model = TimbreTrap(22050, 9, 60, 3, latent_size=128, model_complexity=2,
                       seed=1)
    audio, gt = synthetic_batch(model, 8, 9.0)
    cfg = TrainConfig()
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, audio.shape[0], BACKEND,
                           compact_audio_grid=True)
    for _ in range(2):
        float(step(state, audio, gt, 1e-4)["loss/total"])

    # 1. phases, each ended by a synchronize
    upload, loss_fn, update = step.parts
    phases = {"upload+features": 0.0, "forward": 0.0, "backward": 0.0,
              "update": 0.0}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] += (time.perf_counter() - t0) * 1e3 / args.steps
        return out

    for _ in range(args.steps):
        feats, g = timed("upload+features", lambda: upload(audio, gt))
        total, metrics = timed("forward", lambda: loss_fn(feats, g))
        timed("backward", total.backward)
        timed("update", lambda: update(state, metrics, 1e-4))

    # 2. kernels over whole steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            float(step(state, audio, gt, 1e-4)["loss/total"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups, launches = {}, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    for e in kernels:
        k = _group(e.name)
        groups[k] = groups.get(k, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e3
        launches[k] = launches.get(k, 0) + 1
    if args.trace:
        prof.export_chrome_trace(args.trace)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    n = args.steps
    print(json.dumps({
        "card": card, "backend": BACKEND, "steps": n,
        "phase_ms": phases,
        "step_wall_ms_profiled": wall_ms / n,
        "device_busy_share": busy / 1e3 / wall_ms if kernels else None,
        "kernel_ms_per_step": {k: v / n for k, v in sorted(groups.items())},
        "launches_per_step": {k: v / n for k, v in sorted(launches.items())},
        "peak_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

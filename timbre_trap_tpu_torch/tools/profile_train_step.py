"""Where a training step's time goes on the card.

    python -m timbre_trap_tpu_torch.tools.profile_train_step [--steps N]
        [--backend pallas_bf16|pallas] [--variant base|film|mag|magdb]
        [--skip] [--trace PATH]

Builds a flagship model of the family ``--variant`` (default the base
model; ``--skip`` adds skip connections; 22.05 kHz, 9 x 60 bins, 3-s
blocks, latent 128, complexity 2, random weights of seed 1) and the recipe
batch that
``chip_smoke.py`` trains on (``train.synthetic_batch``: 8 chord-and-noise
9-s crops as compact int16, sparse uint8 ground truth, seed 0), runs two
warm-up steps of ``--backend`` (default ``"pallas_bf16"``, the recipe's
mixed precision; ``"pallas"`` is the float32 step), then:

1. phases: the parts of ``make_train_step``'s step (``step.parts``; the
   step defines them) run one after another with a synchronize after each,
   host clock, mean of ``--steps`` steps;
2. kernels: ``torch.profiler`` over ``--steps`` whole steps; the device
   time summed by kernel group, the device busy share (the union of kernel
   intervals over the profiled wall time) and launches per step; and the
   bytes the K3 ELU' seed moves in a step (its inputs read once, its
   outputs written once) over the card's 3.35 TB/s, its bound;
3. the inference forward (the bf16 forward of ``transcribe``: the
   60-stage chain, or the skip route's 58 stages, on a 4-chunk group of
   seeded features, 1024 frames): wall time per forward (host clock,
   synchronized) beside its device time by kernel group, so that
   host-bound launching shows as a busy share below 1;
4. the forward's stages one by one, in bfloat16 and in float32 (CUDA
   events, each stage on the input its chain gives it; the skip route's
   levels chained without the bridge and the skip adds): device time,
   band GFLOP and bytes in and out, summed by conv kind.

Prints one JSON line with both and the card's name and power limit. Needs
a CUDA device; exits non-zero without one.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

BACKENDS = ("pallas_bf16", "pallas")
VARIANTS = ("base", "film", "mag", "magdb")
# HBM rate of an H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BYTES = 3.35e12
# (group, substring of the kernel's name), first match wins; the port's
# kernels live in an anonymous namespace of their .cu file. Both steps run
# the tensor-core kernels of band_mma.cu (bf16 products in the bf16 step,
# split-TF32 in the float32 one; the dW reduction serves both), the bf16
# step's K1 stage that of band_wgmma.cu, and the ELU' seed of
# banded_conv_bwd.cu.
_OURS = "(anonymous namespace)::"
GROUPS = (("K3 dW partial, mma", _OURS + "band_dw_partial_kernel"),
          ("K3 dW partial f32, 3xTF32", _OURS + "band_dw_tf32_kernel"),
          ("K3 dW reduce", _OURS + "band_dw_reduce_kernel"),
          ("K3 dX, mma", _OURS + "band_product_kernel<float, true"),
          ("K1 stage, wgmma", _OURS + "band_wgmma_kernel"),
          ("K3 dX f32, 3xTF32", _OURS + "band_tf32_kernel<true"),
          ("K1 stage f32, 3xTF32", _OURS + "band_tf32_kernel<false"),
          ("K3 ELU seed", _OURS + "elu_backward_kernel<"),
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
    ap.add_argument("--backend", choices=BACKENDS, default=BACKENDS[0])
    ap.add_argument("--variant", choices=VARIANTS, default=VARIANTS[0])
    ap.add_argument("--skip", action="store_true",
                    help="skip connections")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    from .. import models
    from ..train import (TrainConfig, init_train_state, make_train_step,
                         synthetic_batch)

    family = {"base": models.TimbreTrap, "film": models.TimbreTrapFiLM,
              "mag": models.TimbreTrapMag,
              "magdb": models.TimbreTrapMagDB}[args.variant]
    model = family(22050, 9, 60, 3, latent_size=128, model_complexity=2,
                   skip_connections=args.skip, seed=1)
    audio, gt = synthetic_batch(model, 8, 9.0)
    cfg = TrainConfig()
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, audio.shape[0], args.backend,
                           compact_audio_grid=True)
    for _ in range(2):
        float(step(state, audio, gt, 1e-4)["loss/total"])
    seed_bytes = _seed_bytes(lambda: step(state, audio, gt, 1e-4))

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
    busy, groups, launches = _device_time(prof)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    chain = _profile_chain(model, args.steps)
    stages = _stage_times(model, 10)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    n = args.steps
    print(json.dumps({
        "card": card, "backend": args.backend, "variant": args.variant,
        "skip_connections": args.skip, "steps": n,
        "phase_ms": phases,
        "step_wall_ms_profiled": wall_ms / n,
        "device_busy_share": busy / wall_ms if groups else None,
        "kernel_ms_per_step": {k: v / n for k, v in sorted(groups.items())},
        "launches_per_step": {k: v / n for k, v in sorted(launches.items())},
        "elu_seed_bytes_per_step": seed_bytes,
        "elu_seed_bound_ms_per_step": seed_bytes / PEAK_BYTES * 1e3,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "forward_chain": chain, "chain_stages": stages}))
    return 0


def _seed_bytes(run_step):
    """Bytes the K3 ELU' seed moves in one step: every launch's inputs
    read once and outputs written once (the level backward's seed op is
    wrapped for that step)."""
    from ..ops import fused_level as fl

    total = 0

    def seed(dy, elu=None, keep_raw=False):
        nonlocal total
        out = fl.elu_backward(dy, elu, keep_raw)
        total += sum(t.numel() * t.element_size()
                     for t in (dy, *(elu or ()), *out) if t is not None)
        return out

    ops = fl._KERNEL_OPS
    fl._KERNEL_OPS = ops[:3] + (seed,)
    try:
        float(run_step()["loss/total"])
    finally:
        fl._KERNEL_OPS = ops
    return total


def _device_time(prof):
    """(busy ms: the union of kernel intervals, ms by kernel group,
    launches by kernel group) of a profile."""
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
    return busy / 1e3, groups, launches


def _features(model):
    """Seeded features of a 4-chunk group, (4, F, 1024, C_in) NHWC."""
    net = model.net
    g = torch.Generator(device="cuda").manual_seed(3)
    return 0.3 * torch.randn((4, net.feature_size, 1024, net.in_channels),
                             generator=g, device="cuda")


def _profile_chain(model, reps):
    """Wall and device time per bf16 inference forward on ``_features``."""
    from ..models.fused import fused_forward

    spec = model._spec(True)
    x = _features(model)

    def forward():
        fused_forward(model.net, x, True, torch.bfloat16, spec)

    for _ in range(2):
        forward()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = run()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_ms = run()
    busy, groups, launches = _device_time(prof)
    return {"shape": list(x.shape), "wall_ms": wall_ms / reps,
            "wall_ms_profiled": prof_ms / reps,
            "device_busy_share_profiled": busy / prof_ms,
            "kernel_ms": {k: v / reps for k, v in sorted(groups.items())},
            "launches": {k: v / reps for k, v in sorted(launches.items())}}


def _conv_kind(cb):
    if cb.per_block:
        return f"dense {cb.r_in}->{cb.r_out}"
    if cb.f_out != cb.f_in:
        return "sconv" if cb.f_out < cb.f_in else "tconv"
    return "1x1" if len(cb.dts) == 1 else f"3x3 d={max(cb.dts)}"


def _stage_times(model, reps):
    """Each conv stage of the inference forward on ``_features`` timed alone
    (CUDA events, mean of ``reps`` launches on the input the chain gives
    it), in bfloat16 and float32: {dtype: {kind: {stages, ms, band GFLOP,
    GB in and out}}}, ms and GB summed over the kind's stages."""
    from ..ops.fused_level import _apply_chain, band_flops, banded_conv
    from ..ops.packed_conv import pack_nhwc

    spec = model._spec(True)
    specs = spec.especs + spec.dspecs if hasattr(spec, "especs") else [spec]
    x = pack_nhwc(_features(model))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        kinds = out.setdefault(str(dtype).replace("torch.", ""), {})

        def stage(v, cb, act=False, residual=None):
            y = banded_conv(v, cb, act, residual)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                banded_conv(v, cb, act, residual)
            end.record()
            torch.cuda.synchronize()
            k = kinds.setdefault(_conv_kind(cb), {"stages": 0, "ms": 0.0,
                                                  "band_gflop": 0.0,
                                                  "gb": 0.0})
            k["stages"] += 1
            k["ms"] += start.elapsed_time(end) / reps
            k["band_gflop"] += band_flops([cb], v.shape[0] * v.shape[-1]) / 1e9
            k["gb"] += sum(t.numel() * t.element_size() for t in
                           (v, y, residual) if t is not None) / 1e9
            return y

        with torch.no_grad():
            cur = x
            for s in specs:
                cur = _apply_chain(cur, s, dtype, stage)
    return out


if __name__ == "__main__":
    sys.exit(main())

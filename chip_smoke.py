#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (timbre_trap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build   — compile every CUDA kernel of the port from ``csrc/`` (nvcc,
             sm_90a, in parallel) and print the build time, the ptxas
             lines and the SASS counts (HMMA in ``band_mma``; HGMMA and
             UTMALDG, the TMA loads, in ``band_wgmma`` and in its float32
             kernel ``band_wgmma_f32_kernel`` alone, all required);
2. parity  — hold each kernel against its plain PyTorch version on the
             card at the flagship shapes: the conv chain kernel (K1) item
             by item and as the whole 36-item chain at (4, 1080, 1024), in
             float32 (max abs error <= 1e-4 * max|ref|, TF32 off) and in
             bfloat16 (<= 5e-2 * max|ref| against the float32 plain
             version; the float32 route runs split-TF32 products on
             TF32 wgmma, ``tt_band_conv_wgmma_f32``, held to the IEEE
             plain version); the peak-mask
             kernel (K2) exactly, at t = 0.5 and 0;
             the whole reconstruction-spec chain (decoder switch off, as
             reconstruct runs it) in float32 within 1e-4 * max|ref|;
             the level backward (K3) on each of the 8 training levels at
             (2, R_in, 1024): dX and every parameter's gradient against
             torch autograd of the plain chain, float32 within
             1e-4 * max|ref|, bfloat16 within 5e-2 * max|ref|; and at the
             recipe step's (8, R_in, 3072) against its plain twin on the
             same tensors: dX, dW and dBias float32 within 1e-4 * max|ref|,
             bfloat16 within 1e-2 * max|ref|, and the same bits in two
             runs;
2b. f32    — ``tools/f32_accuracy.py`` in its own process: every item
             and every stage of the float32 chain, and the whole chain,
             against float64 beside the IEEE plain version; each item and
             stage within 3x the plain version's error;
2c. c4     — model complexity 4 (widths 16 -> 256): K1 in both dtypes
             and K3's dX and dW on its two period-2 stages (the strided
             conv 65 -> 31 frequencies, 128 -> 256 channels, and the
             transposed conv 31 -> 65, 256 -> 128; a 256-channel
             frequency spans two 128-row blocks) and their adjoints at
             (4, R, 1024) and a ragged T against their twins, with phase
             2's tolerances and two-run checks; each stage's device time
             in both dtypes beside its byte floor and its share of the
             chain; the flagship c4 model transcribes the clip, counted:
             60 bf16 K1 launches a forward, all on the TMA epilogue, no
             cuDNN kernel, within 5e-2 of its float32 run, whose K1
             stages all run the split-TF32 kernel;
3. main    — the flagship model (22.05 kHz, 9 x 60 bins, 3-s blocks,
             latent 128, complexity 2, seeded random weights) transcribes a
             ~100-s chord clip (3 pieces of 16 blocks), then peak_mask,
             counted (60 K1 kernels a forward, one K2); activations must
             be finite, in [0, 1],
             of shape (1, 540, frames), and within 5e-2 of a float32 run;
             the mask must equal the plain version's on those activations;
             the float32 transcribe of the same clip, counted: every K1
             stage runs the split-TF32 band kernel; a small model on the
             card matches the same weights on the CPU.
             The flagship sliCQ on the card: a native white-noise round
             trip over 2 blocks (> 60 dB), a compat-frame chord round trip
             (> 30 dB), the card's decode against the CPU's on the same
             coefficients (<= 1e-5 * max|x|). reconstruct() of the same
             100-s clip, counted: every K1 launch split-TF32, K2 never
             launched, output (1, 1, n_blocks * L), finite, max|y| = 1
             within 1e-6; the streamed result against one pass over the
             clip as a card tensor (<= 2e-5); a compat-frame flagship
             model reconstructs a 9-s clip with the same checks; a small
             model's reconstruct on the card against the CPU (<= 1e-4).
             The model families and skip connections: the flagship base
             model with skips transcribes the 100-s clip, then peak_mask,
             counted (58 bf16 K1 launches a forward, K2 launched, within
             5e-2 of its float32 run or, where bf16 storage with skip adds
             departs further, within 1.5x the plain bf16 route's
             departure; the mask equal to the plain
             version's), and reconstructs it, counted (58 split-TF32
             launches a forward, no K2, max|y| = 1); one flagship forward
             of base + skips, FiLM, Mag, MagDB and FiLM + skips through the
             kernels against the same route through the plain twins on the
             card (float32 <= 1e-4 * max|ref|, bf16 <= 5e-2 * max|ref|),
             and each of the last four transcribes a 9-s clip through K2
             (exact); a small model of every family x skips on the card
             against the CPU (<= 1e-4, or, where their float32 roundings
             part by more, the card within 3x the CPU's distance from a
             float64 run of the same model; MagDB's CPU model reads the card's
             features, whose dB form amplifies the FFTs' rounding near the
             floor); save -> load_model round trips on
             the card, bit for bit.
             Then training at the reference recipe: 5 ``"pallas_bf16"``
             steps on one seeded batch of 8 chord-and-noise 9-s crops
             (int16 compact uploads, uint8 ground truth), the first
             counted (K1 and K3 run), every metric finite, the loss
             falling; one bf16 step against one float32
             ``"packed"`` (plain twin) step from the same weights on 2 of
             the crops (the twin's batch is cut for its time and memory),
             loss within 2e-2 and the whole gradient within 5e-2 in
             relative L2; on those crops and at the small geometry one
             float32 ``"pallas"`` step against ``"packed"``, losses within
             1e-5 and gradients within 1e-4 * each leaf's max|g|; one
             counted float32 recipe step, whose K1 stages and K3 dX and dW
             launches must all run the split-TF32 band kernels.
             Every family trains (3e): base + skips, FiLM, Mag + skips
             and MagDB at the flagship width, 2 counted ``"pallas_bf16"``
             recipe steps each (K1, K3 dX and dW and the ELU' seed
             launched, all on the bf16 route; every metric finite;
             ``skip_weights`` and ``film_layer.*`` move), the step's time
             and peak memory by ``train.reference_recipe_step_time``; one
             float32 ``"pallas"`` step against ``"packed"`` from the same
             weights on 2 flagship crops (FiLM + skips, Mag + skips,
             MagDB) and at the small geometry for every family x skips,
             losses within 1e-5 and gradients within 1e-4 * each leaf's
             max|g| (or, where leaves' two float32 gradients part by more,
             the kernel's largest distance from a float64 run over those
             leaves within 3x the twin's);
             ``grad_accum_steps=2`` over 2 x 4 crops against one step on
             the 8 (float32 ``"pallas"``): the parameters unchanged bit
             for bit after micro-step 1, Adam's moments within 1e-5 * max
             and the parameters within 1e-5 * max|p| after micro-step 2
             (entries whose gradient sits at float32's noise floor within
             2 lr); a bf16 run saved after step 1 and loaded into a fresh
             model takes step 2 bit for bit as the run that went on.
             The Trainer (3f), fed by the data package: a synthetic
             corpus on disk (8 x 12-s chord tracks to train, 2 x 20-s to
             validate, a .wav and an annotated .f0.npy each), the CLI's
             split (an MPE loader of 4 shuffled 9-s crops and an
             audio-only loader of 4), ``"pallas_bf16"``, a checkpoint and
             a validation sweep through ``evaluate`` every 2 steps, 4
             steps: every logged
             metric finite, ``mpe/f1-score``, ``reconstruction/SDR`` and
             ``loss/total`` in ``metrics.json``, the checkpoints and
             ``hparams.json`` written, ``load_model`` of the last
             checkpoint bit for bit; a fresh Trainer restored from the
             first checkpoint runs to the same parameters, Adam moments
             and trainer state bit for bit, counted (K1 and K3 bf16 only,
             K2 exactly once a validation track); with cuDNN's TF32
             default on,
             ``evaluate`` of a small model on the card against the CPU
             (losses within 1e-4 relative, SDR within 1e-3 dB, ``mpe/*``
             equal, or where masks part, the card's activations within
             3x the CPU's distance from float64) and one ``"flax"`` step
             (losses within 1e-5, gradients within 1e-4 * each leaf's
             max|g| or the float64 yardstick), both leaving the flag as
             it was.
             The CLIs (3g), through their ``main(argv)`` on synthetic
             corpora in the wrappers' layouts (9 URMP pieces, 2 tracks
             each of Bach10, Su and GuitarSet, TRIOS's 5 multitracks):
             the train CLI with ``--debug`` and its defaults (batch 8 of
             9-s crops, 8 loader threads, ``"pallas_bf16"``) but
             ``--max-epochs 2 --checkpoint-interval 2``, counted: K1 348,
             K3 173 dX, 174 dW (partial sums and reduction) and 24 seeds
             a step, all bf16, K2 once a validation track; then timed
             with ``--max-epochs 4``: ``metrics.json`` finite,
             ``load_model`` of its last checkpoint bit for bit; the
             ``"flax"`` recipe step's time and peak memory; the evaluate
             CLI on that checkpoint over the five sets, K2 once a track,
             its printed results equal to ``evaluate`` on the model it
             loaded; a small model through the evaluate CLI on the card
             against ``--device cpu`` (3f's bars); the sonify CLI on the
             Bach10 mixtures: K1 in both routes, three finite WAVs a
             track, ``_ref`` > 60 dB against the padded input.
             Multi-device (3h): the ``"flax"`` recipe step with ``remat``
             against the step without (losses within 1e-5, gradients
             within 1e-4 * each leaf's max|g|), its time and peak memory
             beside 3g's; an NCCL group of one rank on the card
             (``parallel.initialize``): the sharded ``"pallas_bf16"``
             recipe step on 4 MPE + 4 audio-only crops and the sharded
             transcription of the 100-s clip equal the plain step and
             ``chunked_inference`` bit for bit, counted; two gloo ranks
             sharing the card (``chip_smoke.py --parallel-rank``; NCCL
             takes one rank a card), 2 + 2 crops each: the sharded
             float32 step against one rank's (1e-5, 1e-4 * max|g|, or
             the float64 rule), the bf16 one within 2e-2 (loss) and 5e-2
             (gradient L2), both ranks the same bits, each rank's step
             counted (one rank's launches), the sharded transcription
             within 2e-5 * max|ref| of ``chunked_inference``, the ranks'
             K1 launches summing to one rank's (up to a chunk group);
             the ranks' step and gradient all-reduce times (two ranks on
             one card: no scaling numbers).
             The last modules (3i), on 3g's corpora (plus four stems a
             Bach10 piece) and the flagship model: its weights exported
             to a reference state_dict and imported back bit for bit; a
             bare state_dict save and a whole-module save through
             ``load_torch_checkpoint`` into a fresh card model whose 9-s
             transcribe equals the original's bit for bit; the parity CLI
             on the flagship weights exported without ``.0`` names
             (compat frame, Bach10: K2 once a track, K1 0, finite results,
             the JSON written) and a small model's run on the card
             against ``--device cpu`` (3f's bars); the comparison CLI on
             the saved model (the lin-CQT, log-CQT and Timbre-Trap rows,
             60 bf16 K1 launches a forward, no K2) and with
             ``--basic-pitch --deep-salience`` (SKIP, no download);
             ``quality_f1`` at ``bench.py``'s two frozen probe
             configurations, F1 >= 0.9 each, K1, K3 and K2 counted
             against the launches of a step worked out from its forwards;
             ``collect_latents`` of the Bach10 stems (finite) and a small
             model's on the card against the CPU (<= 1e-4 * max|ref|);
             ``trace`` and ``annotate`` around a transcribe (the trace
             names the band kernel and the range) with ``Timer``.
             K1 and K3's dX and dW are band-tiled tensor-core kernels:
             the K1 stage ``tt_band_conv_wgmma`` (bf16) and
             ``tt_band_conv_wgmma_f32`` (float32) of
             ``csrc/band_wgmma.cu`` (TMA-fed wgmma), dX and dW in both
             dtypes those of ``csrc/band_mma.cu``: phase 2 also
             holds them, on one conv of each kind at flagship widths (3x3
             at dilation 1, 2 and 3, 1x1, sconv, tconv, the dense bridge)
             and on the stages the variants add (the standalone convin
             2 -> 4 and convout 4 -> 2 of the skip route, Mag's convin
             1 -> 4 and convout 4 -> 1, built with their adjoints)
             at T = 3072 and a ragged T = 1001, against their twins on the
             same tensors: the stage, dX and dW (band entries, the twin
             masked with the same bands) and dBias within 1e-4 * max|ref|
             in float32 (split-TF32 against the IEEE twin) and 1e-2 *
             max|ref| in bf16, dW and dBias the same bits in two runs, the
             stage too; K3
             also against its twin at (2, R_in, 1024) on every level; the
             main paths must launch the tensor-core kernels;
4. numbers — the bf16 forward at (4, 1080, 1024) on ``tt_band_conv_wgmma``
             (the TMA epilogue), on the same kernel's staged epilogue
             and through cuDNN, in turns, beside the bound and the
             stage-by-stage byte floor, and one stage of each kind alone;
             the float32 forward the same way on ``tt_band_conv_wgmma_f32``
             and cuDNN (TF32 off), the reconstruction spec, and one stage
             of each kind alone; the wrappers' host microseconds a launch
             on both K1 routes;
             kernel, plain-version and library times, the least time the
             card could take (bound), the real-time factor of a second
             call at the clip's length (bf16 and float32; the first call
             is the counted one), ``reconstruct_rtf`` (second call) with
             the reconstruction chain's forward time and the synthesis
             time of the clip, the base + skips model's
             ``transcribe_rtf`` and ``reconstruct_rtf`` (second call) and
             its route's forward time, ``trainer_step_ms``
             (``run()``'s wall less its checkpoints and sweeps, a step)
             beside the bare step's, ``evaluate_s`` a sweep and the
             validation RTF, K1 alone on each variant
             stage and K3's dX and dW alone on each at the recipe's
             (8, R, 3072) in both dtypes, each family's bf16 step time,
             peak memory and K1 / K3 launches a step, and the train step's
             time, audio rate
             and peak memory; float32 yardsticks (cuDNN with TF32 off) for
             K1 and K3; the flops the
             bf16 kernels compute beside those the convs need, the bytes a
             stage-by-stage run must move, and the HMMA/HGMMA count of the
             tensor-core library's SASS; phase 3g's ``trainer_step_ms``
             (the CLI's threaded loader) beside 3f's, its sweep, evaluate
             and sonify walls.

"Counted" means the kernels the card ran in a call, by name, from the
profiler's device records (``utils.profiling.kernel_counts``; K1
``band_wgmma_kernel`` in bf16, on the TMA epilogue
``band_wgmma_kernel<true>`` or the staged one ``band_wgmma_kernel<false>``
by ``kernel_instance``, ``band_wgmma_f32_kernel`` in float32; K3
dX ``band_product_kernel`` / ``band_tf32_kernel``, dW
``band_dw_partial_kernel`` / ``band_dw_tf32_kernel`` and
``band_dw_reduce_kernel``, the seed ``elu_backward_kernel``; K2
``peak_mask_kernel``). The profiler slows the call it watches, so no
counted call is timed.

Prints the kernels' JSON line (with phase 2c's ``c4``: its bf16 K1
launches a forward, its period-2 stages' errors and device times; with
each kernel's launches per rank in
phase 3h, ``launches_parallel``, and phase 3i's ``launches_cli`` parity
and comparison and ``launches_quality``), the ``parallel`` and
``last_modules`` JSON lines and the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.
"""

import collections
import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

SR, N_OCT, BPO, SECS = 22050, 9, 60, 3
LATENT, COMPLEXITY = 128, 2
CLIP_SECS = 100.0
# The reference training recipe (experiments/train.py): batch 8 x 9-s
# crops, all 8 annotated, base learning rate 1e-3 under the Trainer's
# cosine warm-up, here cut to 4 steps so the rate reaches its base value
# within the run.
TRAIN_CROPS, TRAIN_SECS, TRAIN_STEPS = 8, 9.0, 5
TRAIN_LR, TRAIN_WARMUP = 1e-3, 4
SMALL = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
             secs_per_block=0.5, latent_size=16, model_complexity=1)
# bf16 peak rate of the tensor cores and HBM rate of an H100 SXM
# (NVIDIA data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def f32_ops_ms(flops):
    """The least time for float32-accurate products of ``flops``: the
    lesser of FFMA at the float32 rate and three TF32 tensor-core products
    (a split hi/lo operand each) at the TF32 rate."""
    return min(flops / PEAK_F32_FLOPS, 3 * flops / PEAK_TF32_FLOPS) * 1e3


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def chord(seconds, sr, seed=0):
    """A C-major chord with a little noise, float32 (1, 1, N)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    audio = sum(0.2 * np.sin(2 * np.pi * f * t) for f in (261.63, 329.63, 392.0))
    audio = audio + 0.01 * rng.standard_normal(t.shape)
    return audio[None, None, :].astype(np.float32)


def flagship(cls, **kw):
    """A flagship-geometry model of family ``cls`` (on the card unless
    ``device`` says otherwise)."""
    return cls(SR, N_OCT, BPO, SECS, latent_size=LATENT,
               model_complexity=COMPLEXITY, **kw)


def time_ms(torch, fn, reps=10):
    """Mean milliseconds per call, by CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps=10):
    """Device milliseconds a call of ``fn``: the CUDA kernels' time under
    ``torch.profiler`` over ``reps`` calls after a warm-up call, so the
    host's time between launches is left out. A profile that recorded no
    kernel at all (it happens now and then) is taken again, up to three
    times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0.0)
                    for e in prof.key_averages())
        if total > 0:
            break
    return total / reps / 1e3


def rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, scale


# The port's kernels by the name the card records them under: K1, K3's dX
# and dW partial sums in bf16 and in float32; dW's reduction (both
# dtypes), the ELU' seed and K2.
K1, K1_F32 = "band_wgmma_kernel", "band_wgmma_f32_kernel"
# The bf16 K1 kernel's instances by epilogue (``kernel_instance``): the
# TMA epilogue, where T % 8 == 0, and the staged one.
K1_TMA, K1_STAGED = "band_wgmma_kernel<true>", "band_wgmma_kernel<false>"
DX, DX_F32 = "band_product_kernel", "band_tf32_kernel"
DW, DW_F32 = "band_dw_partial_kernel", "band_dw_tf32_kernel"
DW_REDUCE, SEED, K2 = ("band_dw_reduce_kernel", "elu_backward_kernel",
                       "peak_mask_kernel")
BF16_BANDS, F32_BANDS = (K1, DX, DW), (K1_F32, DX_F32, DW_F32)
KERNELS = BF16_BANDS + F32_BANDS + (DW_REDUCE, SEED, K2)
# The kernels of one recipe step of the base model on "pallas_bf16": K1
# stages, K3's dX, dW (a partial-sum and a reduction kernel a call) and
# the ELU' seeds; and on "pallas", the same on the float32 kernels.
RECIPE_STEP_LAUNCHES = {K1: 348, DX: 173, DW: 174, DW_REDUCE: 174, SEED: 24}
RECIPE_STEP_LAUNCHES_F32 = {dict(zip(BF16_BANDS, F32_BANDS)).get(k, k): n
                            for k, n in RECIPE_STEP_LAUNCHES.items()}


@contextlib.contextmanager
def counting():
    """Yields a dict that, when the block ends, holds how many times the
    card ran each of the port's ``KERNELS`` in it (graph replays
    included), and the bf16 K1 launches on each epilogue."""
    from timbre_trap_tpu_torch.utils.profiling import (kernel_counts,
                                                       kernel_instance,
                                                       kernel_name)

    out = {}
    with kernel_counts(kernel_instance) as counts:
        yield out
    names = collections.Counter()
    for k, n in counts.items():
        names[kernel_name(k)] += n
    out.update((k, names[k]) for k in KERNELS)
    out.update((k, counts[k]) for k in (K1_TMA, K1_STAGED))


@contextlib.contextmanager
def staged_epilogue():
    """Every bf16 K1 stage in the block on the staged epilogue: the plan's
    last integer, the kernel's pick, set to 0 whatever T is."""
    import ctypes

    from timbre_trap_tpu_torch.ops import fused_level

    real = fused_level._wgmma_plan

    def staged_plan(cb, t, width):
        t_pad, ints = real(cb, t, width)
        return t_pad, (ctypes.c_int * len(ints))(*ints[:-1], 0)

    fused_level._wgmma_plan = staged_plan
    try:
        yield
    finally:
        fused_level._wgmma_plan = real


def on_tma_epilogue(launches):
    """Whether every bf16 K1 launch counted took the TMA epilogue."""
    return launches[K1_TMA] == launches[K1] and launches[K1_STAGED] == 0


def bf16_only(launches):
    """Whether K1, dX and dW all ran, and only on their bf16 kernels."""
    return (all(launches[k] > 0 for k in BF16_BANDS)
            and not any(launches[k] for k in F32_BANDS))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def needed_flops(spec, batch, frames):
    """Flops the chain's convolutions need on (batch, R, frames) input: 2 per
    nonzero weight that meets an input row in [0, r_in) and a column in
    [0, frames) and feeds an output row in [0, r_out). The weights are
    random, so a zero entry of a banded block is structural; K1 computes
    those zeros as well (``chain_flops``), but the bound does not count them.
    """
    from timbre_trap_tpu_torch.ops.packed_conv import BLOCK_ROWS

    total = 0
    for cb in spec.convs():
        nz = (cb.blocks != 0).cpu()
        ks = np.arange(cb.k)
        for j in range(cb.n_out_blocks):
            # Block j = J*P + p: the pattern's block p, input window J.
            p0 = j % cb.period * BLOCK_ROWS
            rows = min(BLOCK_ROWS, cb.r_out - j * BLOCK_ROWS)
            src = j // cb.period * cb.col_adv - cb.margin + ks
            ok = np.flatnonzero((src >= 0) & (src < cb.r_in))
            for di, dt in enumerate(cb.dts):
                cols = max(frames - abs(dt), 0)
                total += int(nz[di, p0:p0 + rows][:, ok].sum()) * cols
    return 2 * batch * total


def phase_build(_build):
    secs, logs = _build.build_all()
    print(f"build: {secs:.1f} s for {len(logs)} libraries")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    counts = {"band_mma": sass_counts(_build, "band_mma"),
              "band_wgmma": sass_counts(_build, "band_wgmma"),
              "band_wgmma_f32_kernel": sass_counts(
                  _build, "band_wgmma", "band_wgmma_f32_kernel")}
    print(f"  SASS: {counts}")
    check(counts["band_mma"]["HMMA"] + counts["band_mma"]["HGMMA"] > 0,
          "the tensor-core library holds no HMMA or HGMMA instruction")
    check(counts["band_wgmma"]["HGMMA"] > 0
          and counts["band_wgmma"]["UTMALDG"] > 0,
          "the bf16 stage's library holds no HGMMA or no UTMALDG")
    check(counts["band_wgmma_f32_kernel"]["HGMMA"] > 0
          and counts["band_wgmma_f32_kernel"]["UTMALDG"] > 0,
          "tt_band_conv_wgmma_f32's kernel holds no HGMMA or no UTMALDG")
    return counts


def sass_counts(_build, name, function=None):
    """Tensor-core (HMMA, HGMMA) and TMA load (UTMALDG) instructions in the
    SASS of library ``name``, or of its kernels whose (mangled) name
    contains ``function``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    sass = out.stdout
    if function is not None:
        parts = [p for p in sass.split("Function : ")[1:]
                 if function in p.split("\n", 1)[0]]
        check(len(parts) > 0, f"no kernel named {function} in {name}'s SASS")
        sass = "".join(parts)
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "HGMMA", "UTMALDG")}


def conv_kind(cb):
    if cb.col_adv == 0:
        return "dense"
    if cb.f_out != cb.f_in:
        return "sconv" if cb.f_out < cb.f_in else "tconv"
    return "1x1" if len(cb.dts) == 1 else f"3x3 d={max(cb.dts)}"


def phase_band_parity(torch, fwd_spec, train_specs, stages=(),
                      ts=(3072, 1001), batch=2):
    """The tensor-core kernels on the first conv of each kind in the
    flagship specs (training levels with adjoints; the dense bridge from
    the inference chain; ``fwd_spec`` may be None) and on the variants'
    ``stages`` ((name, conv) pairs built with adjoints: the standalone
    convin and convout of the skip route, the one-channel convin and
    convout of Mag and MagDB; complexity 4's period-2 stages), at each T
    of ``ts``, ``batch`` rows, against their twins on the same tensors,
    in float32 (split-TF32 products against the IEEE twin) within
    1e-4 * max|ref| and in bf16 within 1e-2 * max|ref|: the stage (ELU,
    residual; the variant stages also without either), dX (residual, raw,
    ELU') and dW/dBias (band entries), dW and dBias bitwise stable. The
    stage (``tt_band_conv_wgmma``, float32 ``tt_band_conv_wgmma_f32``)
    gives the same bits in two runs. Returns the largest relative errors
    (bf16, float32) and per variant stage and dtype its largest K3
    relative error."""
    from timbre_trap_tpu_torch.ops.fused_level import (
        banded_conv, banded_conv_dw, banded_conv_dw_reference, banded_conv_dx,
        banded_conv_dx_reference, banded_conv_reference)

    picks = {}
    for spec in train_specs + [fwd_spec] * (fwd_spec is not None):
        for cb in spec.convs():
            picks.setdefault(conv_kind(cb), cb)
    bf16 = torch.bfloat16
    dev = (list(picks.values()) + [cb for _, cb in stages])[0].blocks.device
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rel(got, ref, what, tol):
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        check(err <= tol * scale, f"band kernels: {what} error {err} > "
              f"{tol} * {scale}")
        return err / max(scale, 1e-30)

    worst = {torch.float32: 0.0, bf16: 0.0}
    k3_stages = {name: {} for name, _ in stages}
    for t in ts:
        for kind, cb in list(picks.items()) + list(stages):
            dense = kind == "dense"
            x32 = rand(batch, cb.r_in, t)
            res32 = None if dense else rand(batch, cb.r_out, t)
            line = []
            for dtype, tol in ((torch.float32, 1e-4), (bf16, 1e-2)):
                what = f"{kind} T={t} {str(dtype)[6:]}"
                x = x32.to(dtype)
                res = None if dense else res32.to(dtype)
                forms = [(not dense, res)]
                if kind in k3_stages:
                    forms.append((False, None))
                errs = [max(rel(banded_conv(x, cb, act, r),
                                banded_conv_reference(x, cb, act, r),
                                f"{what} stage", tol) for act, r in forms)]
                for act, r in forms:
                    check(torch.equal(banded_conv(x, cb, act, r),
                                      banded_conv(x, cb, act, r)),
                          f"band kernels: {what} stage differs in two runs")
                if not dense:
                    adj = cb.adjoint
                    c = rand(batch, adj.r_in, t)
                    kw = dict(residual=rand(batch, adj.r_out, t), keep_raw=True,
                              elu=(rand(batch, adj.r_out, t, dtype=dtype),
                                   rand(batch, adj.r_out, t, dtype=dtype)))
                    got = banded_conv_dx(c, adj, dtype, **kw)
                    want = banded_conv_dx_reference(c, adj, dtype, **kw)
                    errs += [rel(g, w, f"{what} dX", tol)
                             for g, w in zip(got, want)]
                    dz = rand(batch, cb.r_out, t)
                    runs = [banded_conv_dw(dz, x, cb) for _ in range(2)]
                    want = banded_conv_dw_reference(dz, x, cb)
                    check(all(torch.equal(a, b) for a, b in zip(*runs)),
                          f"band kernels: {what} dW differs in two runs")
                    errs += [rel(g, w, f"{what} dW/dBias", tol)
                             for g, w in zip(runs[0], want)]
                worst[dtype] = max([worst[dtype]] + errs)
                if kind in k3_stages:
                    key = str(dtype)[6:]
                    k3_stages[kind][key] = max(
                        [k3_stages[kind].get(key, 0.0)] + errs[1:])
                line.append(f"{str(dtype)[6:]} rel "
                            + " ".join(f"{e:.2e}" for e in errs))
            print(f"  band {kind:12s} T={t} (c_in {cb.c_in}, c_out "
                  f"{cb.c_out}, bands {cb.bands}): stage"
                  + ("" if dense else ", dX, raw, dW, dBias")
                  + "; " + "; ".join(line))
    print("  band stage, bf16 and float32: two runs bit-equal on every kind")
    return worst[bf16], worst[torch.float32], k3_stages


# The model complexity of phase 2c, whose widths (16 -> 256) take two
# stages past 128 channels: their band pattern spans P = 2 blocks.
WIDE_COMPLEXITY = 4


def phase_c4(torch, audio, card):
    """Model complexity 4 on the card (phase 2c). Its two period-2 stages,
    encoder level 4's strided conv (65 -> 31 frequencies, 128 -> 256
    channels) and decoder level 1's transposed conv (31 -> 65, 256 ->
    128), built with their adjoints from the seeded flagship c4 net: K1
    in both dtypes, K3's dX and dW at (4, R, 1024) and at a ragged T
    against their twins, with phase 2's tolerances and two-run checks
    (``phase_band_parity``); each stage's device time in both dtypes
    beside its byte floor and the whole chain's. Then the flagship c4
    model transcribes ``audio``, counted: 60 bf16 K1 launches a forward,
    all on the TMA epilogue, and no float32 K1 and no cuDNN kernel;
    activations finite, in [0, 1], within 5e-2 of the float32 transcribe,
    whose K1 launches all run the split-TF32 kernel. Returns the numbers
    for the kernels' JSON line and the bf16 transcribe's launches."""
    from timbre_trap_tpu_torch.interop import hwio_params
    from timbre_trap_tpu_torch.models import TimbreTrap
    from timbre_trap_tpu_torch.models.fused import level_specs
    from timbre_trap_tpu_torch.ops.fused_level import (banded_conv,
                                                       fused_level_apply)
    from timbre_trap_tpu_torch.utils.profiling import (kernel_counts,
                                                       kernel_instance,
                                                       kernel_name)

    model = TimbreTrap(SR, N_OCT, BPO, SECS, latent_size=LATENT,
                       model_complexity=WIDE_COMPLEXITY, seed=0)
    with torch.no_grad():
        train_specs = sum(level_specs(hwio_params(model.net), model.net,
                                      True), [])
    stages = [(f"c4 {conv_kind(cb)}", cb) for spec in train_specs
              for cb in spec.convs() if cb.col_adv and cb.period > 1]
    check([(name, cb.period, cb.adjoint.period) for name, cb in stages]
          == [("c4 sconv", 2, 2), ("c4 tconv", 2, 2)],
          f"c4 period-2 stages {[(n, cb.period) for n, cb in stages]}")
    worst16, worst32, k3_err = phase_band_parity(torch, None, [], stages,
                                                 ts=(1024, 1001), batch=4)

    spec = model._spec(True)
    convs = list(spec.convs())
    periods = sorted(cb.period for cb in convs if cb.col_adv)
    check(periods == [1] * 56 + [2] * 2, f"c4 forward periods {periods}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    chain_in = torch.randn(4, spec.r_in, 1024, generator=gen, device="cuda")
    stage_ms = {}
    with torch.no_grad():
        chain_ms = {str(dt)[6:]: device_ms(torch, lambda x=chain_in.to(dt),
                                           dt=dt: fused_level_apply(x, spec,
                                                                    dt), 5)
                    for dt in (torch.bfloat16, torch.float32)}
        for cb in convs:
            if cb.col_adv == 0 or cb.period == 1:
                continue
            x = torch.randn(4, cb.r_in, 1024, generator=gen, device="cuda")
            for dt in (torch.bfloat16, torch.float32):
                xd = x.to(dt)
                size = xd.element_size()
                nbytes = ((cb.r_in + cb.r_out) * 4 * 1024
                          + int((cb.blocks != 0).sum())) * size
                key = f"{conv_kind(cb)} {str(dt)[6:]}"
                stage_ms[key] = {
                    "ms": device_ms(torch, lambda: banded_conv(xd, cb, True),
                                    20),
                    "bytes_ms": nbytes / PEAK_BYTES * 1e3}
                stage_ms[key]["chain_share"] = (stage_ms[key]["ms"]
                                                / chain_ms[str(dt)[6:]])
    for key, row in stage_ms.items():
        print(f"  c4 {key:14s} (4, R, 1024): {row['ms']:.4f} ms device, "
              f"byte floor {row['bytes_ms']:.4f} ms, "
              f"{100 * row['chain_share']:.2f} % of the chain")
    print(f"  c4 chain (4, {spec.r_in}, 1024) device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in chain_ms.items()) + f"; {card}")

    n_frames = -(-audio.shape[-1] // model.sliCQ.block_length) * \
        model.sliCQ.max_window_length
    forwards = count_forwards(model)
    with kernel_counts(kernel_instance) as counts:
        acts = model.transcribe(audio)
    n = forwards.n
    names = collections.Counter()
    for k, v in counts.items():
        names[kernel_name(k)] += v
    model.fused = "f32"
    with counting() as launches32:
        acts32 = model.transcribe(audio)
    forwards.restore()
    library = sorted(k for k in names if any(
        w in k.lower() for w in ("cudnn", "xmma", "implicit", "convolve")))
    check(names[K1] == 60 * n > 0 and names[K1_F32] == 0 and not library,
          f"the c4 transcribe ran {names[K1]} bf16 K1 launches in {n} "
          f"forwards, {names[K1_F32]} float32, library kernels {library}")
    check(counts[K1_TMA] == names[K1],
          f"a c4 bf16 K1 stage took the staged epilogue: {dict(counts)}")
    check(launches32[K1_F32] > 0 and launches32[K1] == 0,
          f"the c4 float32 transcribe's K1 stages: {launches32}")
    check(tuple(acts.shape) == (1, N_OCT * BPO, n_frames)
          and bool(torch.isfinite(acts).all())
          and 0.0 <= acts.min().item() and acts.max().item() <= 1.0,
          f"c4 activations {tuple(acts.shape)} leave [0, 1] or are not "
          f"finite")
    diff = (acts - acts32).abs().max().item()
    check(diff <= 5e-2, f"c4 bf16 activations differ from f32 by {diff}")
    launches = {k: names[k] for k in KERNELS}
    print(f"c4: transcribe {audio.shape[-1] / SR:.0f} s, {n} forwards, "
          f"{names[K1] / n:.0f} bf16 K1 launches a forward ({counts[K1_TMA]} "
          f"on the TMA epilogue), library kernels none; bf16 vs f32 "
          f"activations max abs diff {diff:.3e}")
    return {"launches_per_forward": names[K1] / n, "forwards": n,
            "band_max_rel_err": worst16, "band_max_rel_err_f32": worst32,
            "k3_max_rel_err": k3_err, "stage_ms": stage_ms,
            "chain_device_ms": chain_ms, "bf16_vs_f32": diff}, launches


class ByteCount:
    """Bytes a stage-by-stage run moves: every kernel call's inputs read
    once and its outputs written once (``ops``, wrapping the kernels, feed
    ``_level_backward``; ``stage`` alone feeds a forward chain)."""

    def __init__(self, torch):
        from timbre_trap_tpu_torch.ops import fused_level as fl

        self.n = 0

        def stage(x, cb, act=False, residual=None):
            y = fl.banded_conv(x, cb, act, residual)
            self.add(x, residual, y, *cb.band_operands(x.dtype))
            return y

        def dx(c, adj, dtype, residual=None, elu=None, keep_raw=False,
               out_dtype=torch.float32):
            out = fl.banded_conv_dx(c, adj, dtype, residual, elu, keep_raw,
                                    out_dtype)
            self.add(c, residual, *(elu or ()), *out,
                     adj.band_operands(dtype)[0])
            return out

        def dw(dz, x, cb):
            out = fl.banded_conv_dw(dz, x, cb)
            self.add(dz, x, *out)
            return out

        def seed(dy, elu=None, keep_raw=False):
            out = fl.elu_backward(dy, elu, keep_raw)
            self.add(dy, *(elu or ()), *out)
            return out

        self.stage, self.ops = stage, (stage, dx, dw, seed)

    def add(self, *tensors):
        self.n += sum(t.numel() * t.element_size() for t in tensors
                      if t is not None)


def phase_parity(torch, model, x, acts_for_mask, n_frames):
    """K1 item by item and as the whole chain; K2 exactly, on real
    activations and on random ones of the main path's (1, F, n_frames).
    Returns the chain's float32 max abs error (against the plain version)
    and K2's, over every mask it compared."""
    from timbre_trap_tpu_torch.ops.fused_level import (
        LevelSpec, fused_level_apply, packed_level_apply)
    from timbre_trap_tpu_torch.ops.peaks import peak_mask, peak_mask_reference

    spec = model._spec(True)
    cur = x.float()
    kinds = {}
    for idx, it in enumerate(spec.items):
        one = LevelSpec([it], it[1].r_in)
        ref32 = packed_level_apply(cur, one, torch.float32)
        got32 = fused_level_apply(cur, one, torch.float32)
        got16 = fused_level_apply(cur, one, torch.bfloat16)
        torch.cuda.synchronize()
        e32, scale = rel_err(got32, ref32)
        e16, _ = rel_err(got16, ref32)
        cb = it[1]
        if it[0] == "rb":
            kind = f"residual 3x3 d={max(cb.dts)} + 1x1"
        elif cb.col_adv == 0:
            kind = f"dense {cb.r_in}->{cb.r_out}"
        elif cb.f_out < cb.f_in:
            kind = "sconv"
        elif cb.f_out > cb.f_in:
            kind = "tconv"
        else:
            kind = f"3x3 {cb.c_in}->{cb.c_out}"
        check(e32 <= 1e-4 * scale, f"K1 item {idx} ({kind}) f32 error {e32} "
              f"> 1e-4 * {scale}")
        check(e16 <= 5e-2 * scale, f"K1 item {idx} ({kind}) bf16 error {e16} "
              f"> 5e-2 * {scale}")
        k = kinds.setdefault(kind, [0, 0.0, 0.0])
        k[0] += 1
        k[1] = max(k[1], e32 / max(scale, 1e-30))
        k[2] = max(k[2], e16 / max(scale, 1e-30))
        cur = ref32
    for kind, (n, r32, r16) in kinds.items():
        print(f"  K1 {kind:28s} x{n:2d}: f32 rel {r32:.2e}  bf16 rel {r16:.2e}")

    ref = packed_level_apply(x, spec, torch.float32)
    got32 = fused_level_apply(x, spec, torch.float32)
    got16 = fused_level_apply(x, spec, torch.bfloat16)
    torch.cuda.synchronize()
    e32, scale = rel_err(got32, ref)
    e16, _ = rel_err(got16, ref)
    print(f"  K1 whole chain {tuple(x.shape)}: f32 err {e32:.3e}, bf16 err "
          f"{e16:.3e}, max|ref| {scale:.3f}")
    check(e32 <= 1e-4 * scale, f"K1 chain f32 error {e32} > 1e-4 * {scale}")
    check(e16 <= 5e-2 * scale, f"K1 chain bf16 error {e16} > 5e-2 * {scale}")
    # The reconstruction spec (decoder switch off, indicator folded into
    # the bias), as reconstruct() runs it: float32 only.
    rspec = model._spec(False)
    ref = packed_level_apply(x, rspec, torch.float32)
    got = fused_level_apply(x, rspec, torch.float32)
    torch.cuda.synchronize()
    e_rec, scale = rel_err(got, ref)
    print(f"  K1 whole reconstruction chain {tuple(x.shape)}: f32 err "
          f"{e_rec:.3e}, max|ref| {scale:.3f}")
    check(e_rec <= 1e-4 * scale, f"K1 reconstruction chain f32 error {e_rec} "
          f"> 1e-4 * {scale}")
    e32 = max(e32, e_rec)

    g = torch.Generator(device=acts_for_mask.device).manual_seed(0)
    rand = torch.rand((1, acts_for_mask.shape[-2], n_frames), generator=g,
                      device=acts_for_mask.device)
    k2_err = 0.0
    for a in (acts_for_mask, rand):
        for t in (0.5, 0.0):
            got = peak_mask(a, t)
            want = peak_mask_reference(a, t)
            check(torch.equal(got, want), f"K2 differs from its plain version "
                  f"at t={t} on {tuple(a.shape)}")
            k2_err = max(k2_err, (got.float() - want.float()).abs().max().item())
    print(f"  K2 peak mask: exact at t=0.5 and t=0 (max abs err {k2_err})")
    return e32, k2_err


def k3_recipe_parity(torch, spec, frames, gen, batch=TRAIN_CROPS):
    """K3 (``level_backward``) against its plain twin
    (``level_backward_reference``) on the same card tensors at the shape
    the recipe step gives it, x (batch, R_in, frames) and dy
    (batch, R_out, frames): dX and every conv's dW and dBias within
    1e-4 * max|ref| in float32 and 1e-2 * max|ref| in bfloat16 (sum order,
    and bf16 recompute outputs that round the other way); two bf16 runs
    give the same bits. Returns (float32 max abs error, f32 rel, bf16
    rel)."""
    from timbre_trap_tpu_torch.ops.fused_level import (
        level_backward, level_backward_reference)

    dev = spec.items[0][1].blocks.device
    x = torch.randn((batch, spec.r_in, frames), generator=gen, device=dev)
    dy = torch.randn((batch, spec.r_out, frames), generator=gen, device=dev)
    out = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        xs, dys = x.to(dtype), dy.to(dtype)
        with torch.no_grad():
            runs = [level_backward(xs, spec, dys, dtype) for _ in range(2)]
            want = level_backward_reference(xs, spec, dys, dtype)
        torch.cuda.synchronize()
        pairs = [(runs[0][0], want[0])] + [
            p for g, r in zip(runs[0][1], want[1]) for p in zip(g, r)]
        err_abs = rel = 0.0
        for i, (got, ref) in enumerate(pairs):
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            check(err <= tol * scale, f"K3 against its twin at "
                  f"{tuple(xs.shape)} {dtype}: output {i} (0 = dX, then dW, "
                  f"dBias per conv) error {err} > {tol} * {scale}")
            err_abs = max(err_abs, err)
            rel = max(rel, err / max(scale, 1e-30))
        same = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(a, b) for p, q in zip(runs[0][1], runs[1][1])
            for a, b in zip(p, q))
        check(same, f"K3 at {tuple(xs.shape)} {dtype}: two runs differ")
        out += [err_abs, rel]
        del runs, want
    return out[0], out[1], out[3]


def phase_k3_parity(torch, net, frames):
    """K3 on the 8 training levels of ``net`` (encoder levels 1-4 with
    convin, decoder levels 1-4 with convout): against torch autograd of the
    plain chain at (2, R_in, 1024) with a seeded cotangent, and against its
    plain twin at (2, R_in, 1024) and at the recipe step's (TRAIN_CROPS,
    R_in, ``frames``) (``k3_recipe_parity``). Returns the largest float32
    abs error at the recipe shape."""
    from timbre_trap_tpu_torch.interop import hwio_params
    from timbre_trap_tpu_torch.models.fused import level_specs
    from timbre_trap_tpu_torch.ops.fused_level import (
        fused_level_train, packed_level_apply)

    names = ["x"] + [n for n, _ in net.named_parameters()]
    leaves = [p for _, p in net.named_parameters()]
    rng = np.random.default_rng(3)
    dev = leaves[0].device
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0

    def spec_of(idx):
        especs, dspecs = level_specs(hwio_params(net), net, True)
        return (especs + dspecs)[idx]

    for idx in range(8):
        spec = spec_of(idx)
        x = torch.from_numpy(rng.standard_normal(
            (2, spec.r_in, 1024)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal(
            (2, spec.r_out, 1024)).astype(np.float32)).to(dev)

        def grads(run):
            xg = x.clone().requires_grad_(True)
            y = run(xg, spec_of(idx))
            g = torch.autograd.grad(torch.sum(y.float() * w), [xg] + leaves,
                                    allow_unused=True)
            return {n: v for n, v in zip(names, g) if v is not None}

        ref = grads(lambda v, s: packed_level_apply(v, s, torch.float32))
        g32 = grads(lambda v, s: fused_level_train(v, s, torch.float32))
        g16 = grads(lambda v, s: fused_level_train(v, s, torch.bfloat16))
        check(set(ref) == set(g32) == set(g16),
              f"K3 level {idx}: gradients reach other parameters")
        r32 = r16 = 0.0
        for n, want in ref.items():
            scale = want.abs().max().item()
            e32 = (g32[n] - want).abs().max().item()
            e16 = (g16[n].float() - want).abs().max().item()
            check(e32 <= 1e-4 * scale, f"K3 level {idx} {n}: f32 error "
                  f"{e32} > 1e-4 * {scale}")
            check(e16 <= 5e-2 * scale, f"K3 level {idx} {n}: bf16 error "
                  f"{e16} > 5e-2 * {scale}")
            r32 = max(r32, e32 / max(scale, 1e-30))
            r16 = max(r16, e16 / max(scale, 1e-30))
        with torch.no_grad():
            _, _, p16 = k3_recipe_parity(torch, spec_of(idx), 1024, gen, 2)
            e_abs, q32, q16 = k3_recipe_parity(torch, spec_of(idx), frames,
                                               gen)
        worst = max(worst, e_abs)
        kind = "encoder" if idx < 4 else "decoder"
        print(f"  K3 {kind} level {idx % 4 + 1} ({spec.r_in}->{spec.r_out} "
              f"rows, {len(ref) - 1} params): vs autograd f32 rel "
              f"{r32:.2e}  bf16 rel {r16:.2e}; vs twin at (2, {spec.r_in}, "
              f"1024) bf16 rel {p16:.2e}, at ({TRAIN_CROPS}, "
              f"{spec.r_in}, {frames}) f32 rel {q32:.2e}  bf16 rel "
              f"{q16:.2e}, bitwise stable")
    return worst


def worst_leaf(got, want):
    """The largest max|got - want| / max|want| over the leaves of two
    gradient dicts, and that leaf's name."""
    return max(((got[n] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-30), n)
               for n, g in want.items())


def grad_l2_rel(got, want):
    """||got - want|| / ||want|| over all leaves of two gradient dicts."""
    num = sum((got[n] - g).square().sum().item() for n, g in want.items())
    den = sum(g.square().sum().item() for g in want.values())
    return (num / den) ** 0.5


def check_kernel_step(label, got, want, ref64=None, pair="pallas vs packed"):
    """Holds one float32 ``"pallas"`` step's (metrics, gradients) against
    the float32 ``"packed"`` step's (or, as ``pair`` names them, another
    float32 step's against its yardstick's): every loss within 1e-5 relative, every
    leaf's gradient within 1e-4 * its max|g|, or, given ``ref64`` (a
    callable returning the step's float64 gradients) and where leaves'
    two float32 gradients part by more, the kernel step's largest distance
    from float64 over those leaves (each relative to the leaf's max|g|)
    within 3x the twin's largest (float32 conditioning of those leaves,
    not the kernel, when the twin lies as far from float64). Returns the
    gaps."""
    (mp, gp), (mk, gk) = got, want
    loss_rel = max(abs(mp[k] - mk[k]) / abs(mk[k]) for k in mk
                   if k.startswith("loss/"))
    grad_rel, leaf = worst_leaf(gp, gk)
    out = {"loss_rel": loss_rel, "grad_rel": grad_rel}
    check(loss_rel <= 1e-5, f"{label} {pair} losses off by {loss_rel}")
    over = [n for n, g in gk.items()
            if (gp[n] - g).abs().max().item() > 1e-4 * g.abs().max().item()]
    if over and ref64 is not None:
        g64 = ref64()

        def dist(g, n):
            return ((g[n].double() - g64[n]).abs().max().item()
                    / max(g64[n].abs().max().item(), 1e-300))

        d_kernel = max((dist(gp, n), n) for n in over)
        d_twin = max((dist(gk, n), n) for n in over)
        ratios = sorted(dist(gp, n) / max(dist(gk, n), 1e-300) for n in over)
        ratio = d_kernel[0] / max(d_twin[0], 1e-300)
        print(f"main: {label} {pair}, {len(over)} leaves over "
              f"1e-4 x max|g| (worst {leaf} {grad_rel:.2e}); from float64 "
              f"over those leaves the kernel step at most {d_kernel[0]:.2e} "
              f"({d_kernel[1]}), the twin {d_twin[0]:.2e} ({d_twin[1]}): "
              f"{ratio:.2f}x; leaf by leaf the kernel's distance is "
              f"{ratios[len(ratios) // 2]:.2f}x the twin's at the median, "
              f"{ratios[-1]:.2f}x at most")
        check(ratio <= 3.0, f"{label} {pair}: gradients {ratio}x as "
              f"far from float64 as the yardstick's")
        out.update(leaves_over=len(over), f64_kernel=d_kernel[0],
                   f64_twin=d_twin[0], f64_ratio=ratio,
                   f64_leaf_ratio_median=ratios[len(ratios) // 2],
                   f64_leaf_ratio_max=ratios[-1])
    else:
        check(not over, f"{label} {pair}: gradient of {leaf} off by "
              f"{grad_rel} * its max|g|")
    print(f"main: {label} {pair}, losses rel {loss_rel:.2e}, "
          f"gradients rel {grad_rel:.2e} (worst {leaf})")
    return out


def one_step(torch, model, weights, backend, audio, gt, lr, mpe=None):
    """One train step of ``backend`` from ``weights`` -> (metrics as
    floats, gradients); the first ``mpe`` crops annotated (all of them by
    default)."""
    from timbre_trap_tpu_torch.train import (TrainConfig, init_train_state,
                                             make_train_step)

    cfg = TrainConfig()
    model.load_state_dict(weights)
    step = make_train_step(model, cfg, mpe or audio.shape[0],
                           conv_backend=backend, compact_audio_grid=True)
    metrics = step(init_train_state(model, cfg), audio, gt, lr)
    grads = {n: p.grad.clone() for n, p in model.net.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def phase_train(torch):
    """The reference recipe's training step on the card (phase 3) and its
    step numbers (phase 4). Returns (numbers, the first step's launches,
    the model)."""
    from timbre_trap_tpu_torch.models import TimbreTrap
    from timbre_trap_tpu_torch.train import (TrainConfig, cosine_warmup,
                                             init_train_state,
                                             make_train_step,
                                             synthetic_batch)

    model = flagship(TimbreTrap, seed=1)
    audio, gt = synthetic_batch(model, TRAIN_CROPS, TRAIN_SECS)
    check(gt.shape == (TRAIN_CROPS, 540, 3072), f"ground truth {gt.shape}")
    w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    cfg = TrainConfig(learning_rate=TRAIN_LR)
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, TRAIN_CROPS, conv_backend="pallas_bf16",
                           compact_audio_grid=True)
    warmup = cosine_warmup(TRAIN_WARMUP)

    def train_step(i):
        metrics = step(state, audio, gt, cfg.learning_rate * float(warmup(i)))
        return {k: float(v) for k, v in metrics.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counting() as launches:                # step 1, counted
        history = [train_step(0)]
    walls = []
    for i in range(1, TRAIN_STEPS):             # the others, timed
        t0 = time.perf_counter()
        history.append(train_step(i))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss/total"] for m in history]
    check(all(np.isfinite(v) for m in history for v in m.values()),
          "a train metric is not finite")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for key in ("avg_norm/encoder", "max_norm/encoder", "avg_norm/decoder",
                "max_norm/decoder", "loss/consistency/spectral"):
        check(key in history[-1], f"train metrics lack {key}")
    check(bf16_only(launches) and all(
        launches[k] == n for k, n in RECIPE_STEP_LAUNCHES.items())
          and on_tma_epilogue(launches),
          f"the bf16 step launched {launches}, not {RECIPE_STEP_LAUNCHES} "
          f"and no float32 kernel, K1 on the TMA epilogue")
    print(f"main: train {TRAIN_STEPS} steps pallas_bf16, loss/total "
          + " ".join(f"{v:.4f}" for v in losses)
          + f", launches {launches}")

    # One step from w0 on each backend, on 2 of the crops (the twin's batch
    # is cut for its time and memory). bf16 kernels against the float32
    # twin: loss within 2e-2 and the whole gradient within 5e-2 in relative
    # L2. Per leaf, a bias whose gradient cancels (a sum over every row and
    # frame of its channel) is off by more than that from bf16 storage
    # alone; the float32 kernels are held leaf by leaf.
    runs = {b: one_step(torch, model, w0, b, audio[:2], gt[:2], TRAIN_LR)
            for b in ("pallas_bf16", "pallas", "packed")}
    (m16, g16), (m32, g32) = runs["pallas_bf16"], runs["packed"]
    d_bf16 = abs(m16["loss/total"] - m32["loss/total"]) / abs(m32["loss/total"])
    l2_bf16 = grad_l2_rel(g16, g32)
    leaf_bf16, leaf = worst_leaf(g16, g32)
    print(f"main: pallas_bf16 vs packed (2 crops) loss/total "
          f"{m16['loss/total']:.6f} vs {m32['loss/total']:.6f}, rel "
          f"{d_bf16:.2e}; gradient L2 rel {l2_bf16:.2e}, worst leaf "
          f"{leaf_bf16:.2e} x its max|g| ({leaf})")
    check(d_bf16 <= 2e-2, f"bf16 step loss off the f32 twin by {d_bf16}")
    check(l2_bf16 <= 5e-2, f"bf16 step gradient off the f32 twin by "
          f"{l2_bf16} in relative L2")
    gaps = {"flagship": check_kernel_step("flagship, 2 crops", runs["pallas"],
                                          runs["packed"])}

    # float32 kernels vs the plain twin at the small geometry.
    small = TimbreTrap(**SMALL, seed=2)
    a_s, g_s = synthetic_batch(small, 2, 1.0, seed=5)
    ws = {k: v.clone() for k, v in small.net.state_dict().items()}
    gaps["small"] = check_kernel_step(
        "small", one_step(torch, small, ws, "pallas", a_s, g_s, TRAIN_LR),
        one_step(torch, small, ws, "packed", a_s, g_s, TRAIN_LR))

    # Two float32 "pallas" steps at the recipe: the first counted (every
    # K1 stage of its forward and recompute, and every K3 dX and dW of its
    # backward, runs a split-TF32 band kernel), the second timed.
    model.load_state_dict(w0)
    st32 = init_train_state(model, cfg)
    step32 = make_train_step(model, cfg, TRAIN_CROPS, conv_backend="pallas",
                             compact_audio_grid=True)
    with counting() as launches32:
        float(step32(st32, audio, gt, TRAIN_LR)["loss/total"])
    check(all(launches32[k] == n
              for k, n in RECIPE_STEP_LAUNCHES_F32.items())
          and not any(launches32[k] for k in BF16_BANDS),
          f"the float32 step launched {launches32}, not "
          f"{RECIPE_STEP_LAUNCHES_F32} and no bf16 kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step32(st32, audio, gt, TRAIN_LR)["loss/total"])
    wall32 = time.perf_counter() - t0
    print(f"main: float32 pallas step launches {launches32}")
    step_s = float(np.mean(walls))
    audio_secs = TRAIN_CROPS * TRAIN_SECS
    numbers = {"train_step_ms": step_s * 1e3,
               "train_step_ms_each": [w * 1e3 for w in walls],
               "audio_s_per_s": audio_secs / step_s,
               "peak_bytes": peak, "f32_step_ms": wall32 * 1e3,
               "f32_step_launches": launches32,
               "loss_total": losses,
               "bf16_vs_twin": {"loss_rel": d_bf16, "grad_l2_rel": l2_bf16,
                                "worst_leaf_rel": leaf_bf16,
                                "worst_leaf": leaf},
               "f32_kernels_vs_twin": gaps}
    print(f"train_step_ms: {step_s * 1e3:.1f} (pallas_bf16, mean of steps "
          f"2-{TRAIN_STEPS}; step 1 counted), "
          f"{audio_secs / step_s:.1f} audio-s/s, peak "
          f"{peak / 2**30:.2f} GiB; float32 pallas step {wall32 * 1e3:.1f} ms")
    return numbers, launches, model


# The families' training phase: (label, family class name, skips).
FAMILY_STEPS = (("base+skips", "TimbreTrap", True),
                ("film", "TimbreTrapFiLM", False),
                ("mag+skips", "TimbreTrapMag", True),
                ("magdb", "TimbreTrapMagDB", False))
# float32 kernels against the plain twin on 2 flagship crops.
FAMILY_F32 = (("film+skips", "TimbreTrapFiLM", True),
              ("mag+skips", "TimbreTrapMag", True),
              ("magdb", "TimbreTrapMagDB", False))


def moved_leaves(names, skips, film):
    """The parameters only the families and skips add."""
    out = [n for n in names if n == "skip_weights" or n.startswith("film")]
    check(len(out) == int(skips) + 4 * int(film),
          f"expected skip and FiLM parameters, found {out}")
    return out


def float64_grads(model, weights, audio, gt):
    """A callable giving the float64 gradients of one step of ``model``
    from ``weights`` on the batch (``train.step_gradients_reference``)."""
    from timbre_trap_tpu_torch.train import (TrainConfig,
                                             step_gradients_reference)

    def grads():
        model.load_state_dict(weights)
        return step_gradients_reference(model, TrainConfig(), audio.shape[0],
                                        audio, gt, compact_audio_grid=True)
    return grads


def phase_family_train(torch, card):
    """Every family trains at the flagship width (phase 3e): for base +
    skips, FiLM, Mag + skips and MagDB, 2 counted ``"pallas_bf16"`` steps
    on the recipe's 8 x 9-s crops (K1, K3 dX, dW and the ELU' seed
    launched on the bf16 route, no float32 kernel, every metric finite,
    ``skip_weights`` and ``film_layer.*`` moved), then the step's time and
    peak memory by ``train.reference_recipe_step_time``; one float32
    ``"pallas"`` step against ``"packed"`` from the same weights on 2
    flagship crops for FiLM + skips, Mag + skips and MagDB, and at the
    small geometry for every family x skips; gradient accumulation (k = 2
    over 2 x 4 crops against one step on the 8); exact resume of a bf16
    run through a checkpoint. Returns (numbers, launches per family)."""
    from timbre_trap_tpu_torch import models
    from timbre_trap_tpu_torch.ops import _build
    from timbre_trap_tpu_torch.train import (TrainConfig, init_train_state,
                                             load_checkpoint,
                                             make_train_step,
                                             reference_recipe_step_time,
                                             save_checkpoint,
                                             synthetic_batch)

    cfg = TrainConfig(learning_rate=TRAIN_LR)
    numbers, launches = {}, {}
    for label, cls_name, skips in FAMILY_STEPS:
        model = flagship(getattr(models, cls_name), skip_connections=skips,
                         seed=4)
        audio, gt = synthetic_batch(model, TRAIN_CROPS, TRAIN_SECS, seed=1)
        w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
        state = init_train_state(model, cfg)
        step = make_train_step(model, cfg, TRAIN_CROPS,
                               conv_backend="pallas_bf16",
                               compact_audio_grid=True)
        with counting() as counts:
            history = [{k: float(v) for k, v in step(state, audio, gt,
                                                     TRAIN_LR).items()}
                       for _ in range(2)]
        check(bf16_only(counts) and counts[SEED] > 0, f"{label}: the bf16 "
              f"steps did not run K1, K3 and the seed on bf16 kernels "
              f"alone: {counts}")
        check(all(np.isfinite(v) for m in history for v in m.values()),
              f"{label}: a train metric is not finite")
        now = model.net.state_dict()
        moved = moved_leaves(w0, skips, cls_name == "TimbreTrapFiLM")
        check(all(not torch.equal(now[n], w0[n]) for n in moved),
              f"{label}: {moved} did not all change")
        del step, state
        secs, loss0, peak = reference_recipe_step_time(
            model, "pallas_bf16", batch=TRAIN_CROPS, blocks=3, iters=3,
            return_memory=True)
        launches[label] = {k: v // 2 for k, v in counts.items()}
        numbers[label] = {"train_step_ms": secs * 1e3, "peak_bytes": peak,
                          "loss_total": [m["loss/total"] for m in history],
                          "measure_first_loss": loss0,
                          "launches_per_step": launches[label]}
        print(f"family train: {label:10s} 2 pallas_bf16 steps, loss/total "
              + " ".join(f"{m['loss/total']:.4f}" for m in history)
              + f"; {moved or 'no extra'} moved; a step "
              f"{launches[label]}; train_step_ms {secs * 1e3:.1f} (least of "
              f"3), peak {peak / 2**30:.2f} GiB, on {card}")
        del model
        torch.cuda.empty_cache()

    # float32 kernels against the plain twin, flagship (2 crops) and small.
    gaps = {}
    for label, cls_name, skips in FAMILY_F32:
        model = flagship(getattr(models, cls_name), skip_connections=skips,
                         seed=5)
        audio, gt = synthetic_batch(model, 2, TRAIN_SECS, seed=2)
        w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
        gaps[label] = check_kernel_step(
            f"{label} flagship, 2 crops",
            one_step(torch, model, w0, "pallas", audio, gt, TRAIN_LR),
            one_step(torch, model, w0, "packed", audio, gt, TRAIN_LR),
            float64_grads(model, w0, audio, gt))
        del model
    for cls_name in ("TimbreTrap", "TimbreTrapFiLM", "TimbreTrapMag",
                     "TimbreTrapMagDB"):
        for skips in (False, True):
            small = getattr(models, cls_name)(**SMALL, seed=2,
                                              skip_connections=skips)
            a_s, g_s = synthetic_batch(small, 2, 1.0, seed=5)
            ws = {k: v.clone() for k, v in small.net.state_dict().items()}
            label = f"small {small.variant}" + ("+skips" if skips else "")
            gaps[label] = check_kernel_step(
                label, one_step(torch, small, ws, "pallas", a_s, g_s,
                                TRAIN_LR),
                one_step(torch, small, ws, "packed", a_s, g_s, TRAIN_LR),
                float64_grads(small, ws, a_s, g_s))
    numbers["f32_kernels_vs_twin"] = gaps
    torch.cuda.empty_cache()

    # Gradient accumulation: k = 2 micro-steps on 2 x 4 crops against one
    # step on the 8, float32 "pallas", from the same weights.
    model = flagship(models.TimbreTrapFiLM, skip_connections=True, seed=6)
    audio, gt = synthetic_batch(model, TRAIN_CROPS, TRAIN_SECS, seed=3)
    w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    full_cfg = TrainConfig(learning_rate=TRAIN_LR)
    full_state = init_train_state(model, full_cfg)
    make_train_step(model, full_cfg, TRAIN_CROPS, conv_backend="pallas",
                    compact_audio_grid=True)(full_state, audio, gt, TRAIN_LR)
    full = {k: v.clone() for k, v in model.net.state_dict().items()}
    g_full = {n: p.grad.clone() for n, p in model.net.named_parameters()}
    model.load_state_dict(w0)
    acc_cfg = TrainConfig(learning_rate=TRAIN_LR, grad_accum_steps=2)
    acc_state = init_train_state(model, acc_cfg)
    acc_step = make_train_step(model, acc_cfg, TRAIN_CROPS // 2,
                               conv_backend="pallas", compact_audio_grid=True)
    half = TRAIN_CROPS // 2
    acc_step(acc_state, audio[:half], gt[:half], TRAIN_LR)
    after1 = model.net.state_dict()
    check(all(torch.equal(after1[k], v) for k, v in w0.items()),
          "accumulation: micro-step 1 changed the parameters")
    acc_step(acc_state, audio[half:], gt[half:], TRAIN_LR)
    check(acc_state["count"] == 1 and acc_state["mini_step"] == 0,
          f"accumulation: count {acc_state['count']}, mini_step "
          f"{acc_state['mini_step']} after 2 micro-steps")
    # Adam's moments take the accumulated mean as the one step takes its
    # gradient: within 1e-5 x each leaf's max everywhere.
    mom_rel = max(
        ((acc_state[m][n] - full_state[m][n]).abs().max().item()
         / max(full_state[m][n].abs().max().item(), 1e-30), f"{m} {n}")
        for m in ("mu", "nu") for n in full_state[m])
    # The parameters: within 1e-5 x each leaf's max|p|. Adam's first step
    # moves an entry by lr * g / (|g| + eps), so an entry whose gradient
    # lies at float32's noise floor (|g| <= 1e-5 x its leaf's max|g|) may
    # move by anything up to 2 lr between two summation orders.
    acc_rel, acc_leaf, n_noise, noise_max = 0.0, "", 0, 0.0
    for k, v in model.net.state_dict().items():
        d = (v - full[k]).abs()
        scale = max(full[k].abs().max().item(), 1e-30)
        bar = 1e-5 * scale
        acc_rel, acc_leaf = max((acc_rel, acc_leaf), (d.max().item() / scale,
                                                      k))
        g = g_full[k].abs()
        noise = g <= 1e-5 * g.max()
        over = d > bar
        check(not (over & ~noise).any(), f"accumulation: {k} off the "
              f"one-step result by {d.max().item()} > {bar} where the "
              "gradient is above float32's noise floor")
        n_noise += int((over & noise).sum())
        noise_max = max(noise_max, d[noise].max().item() if noise.any()
                        else 0.0)
    print(f"family train: FiLM + skips, grad_accum_steps=2 over 2 x {half} "
          f"crops vs one step on {TRAIN_CROPS}: unchanged after micro-step "
          f"1; after micro-step 2 Adam's moments within {mom_rel[0]:.2e} x "
          f"max ({mom_rel[1]}), the parameters within {acc_rel:.2e} x "
          f"max|p| (worst {acc_leaf}); {n_noise} entries over 1e-5 x max|p| "
          f"where |g| <= 1e-5 x max|g| (largest move {noise_max:.2e}, bar "
          f"2 lr)")
    check(mom_rel[0] <= 1e-5, f"accumulation: Adam's {mom_rel[1]} off the "
          f"one-step result by {mom_rel[0]} x its max")
    check(noise_max <= 2 * TRAIN_LR, f"accumulation: a noise-floor entry "
          f"moved by {noise_max} > 2 lr")
    numbers["accumulation"] = {"rel": acc_rel, "worst_leaf": acc_leaf,
                               "moments_rel": mom_rel[0],
                               "noise_floor_entries_over": n_noise,
                               "noise_floor_max_move": noise_max}
    del model, acc_state, acc_step, full_state, g_full
    torch.cuda.empty_cache()

    # Exact resume: save after step 1, load into a fresh model; step 2 is
    # the continuing run's step 2 bit for bit.
    kw = dict(skip_connections=True)
    model = flagship(models.TimbreTrapMag, seed=7, **kw)
    audio, gt = synthetic_batch(model, TRAIN_CROPS, TRAIN_SECS, seed=4)
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, TRAIN_CROPS,
                           conv_backend="pallas_bf16", compact_audio_grid=True)
    step(state, audio, gt, TRAIN_LR)
    ckpt = _build.BUILD_DIR / "smoke_train_ckpt"
    path = save_checkpoint(str(ckpt / "model-1"), model, state, step=1)
    going_on = {k: float(v) for k, v in step(state, audio, gt,
                                             TRAIN_LR).items()}
    loaded = load_checkpoint(path, map_location="cuda")
    fresh = flagship(models.TimbreTrapMag, seed=8, **kw)
    fresh.load_state_dict(loaded["params"])
    resumed = {k: float(v) for k, v in make_train_step(
        fresh, cfg, TRAIN_CROPS, conv_backend="pallas_bf16",
        compact_audio_grid=True)(loaded["opt_state"], audio, gt,
                                 TRAIN_LR).items()}
    shutil.rmtree(ckpt)
    a, b = model.net.state_dict(), fresh.net.state_dict()
    same = (resumed == going_on and loaded["step"] == 1
            and all(torch.equal(a[k], b[k]) for k in a)
            and all(torch.equal(state[m][n], loaded["opt_state"][m][n])
                    for m in ("mu", "nu") for n in state[m]))
    check(same, f"resume: step 2 after a checkpoint differs from the "
          f"continuing run's ({resumed} vs {going_on})")
    print("family train: Mag + skips, bf16 step 2 after save -> load into a "
          "fresh model equals the continuing run's bit for bit (metrics, "
          "parameters, Adam moments)")
    numbers["resume_bitwise"] = True
    return numbers, launches


def k3_stage_numbers(torch, stages, batch, frames):
    """K3's dX and dW alone on each variant stage at the recipe step's
    (batch, R, frames), bf16 and float32: kernel and plain times and the
    bound. dX maps a float32 cotangent to a float32 input gradient (as for
    the consistency encode's convin); dW reads the float32 cotangent and
    the stored input. Bytes: every input read once, every output written
    once, the band weights once."""
    from timbre_trap_tpu_torch.ops.fused_level import (
        LevelSpec, banded_conv_dw, banded_conv_dw_reference, banded_conv_dx,
        banded_conv_dx_reference)
    from timbre_trap_tpu_torch.ops.packed_conv import BLOCK_ROWS

    out = {}
    for name, cb in stages:
        adj, dev = cb.adjoint, cb.blocks.device
        c = torch.randn((batch, adj.r_in, frames), device=dev)
        x32 = torch.randn((batch, cb.r_in, frames), device=dev)
        flops = needed_flops(LevelSpec([("conv", cb, False)], cb.r_in), batch,
                             frames)
        row = {}
        for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            sfx = "" if dtype == torch.bfloat16 else "_f32"
            x = x32.to(dtype)
            t_ops = (f32_ops_ms(flops) if sfx
                     else flops / PEAK_BF16_FLOPS * 1e3)
            w_dx = adj.band_operands(dtype)[0]
            dx_bytes = (c.numel() * 4 + batch * adj.r_out * frames * 4
                        + w_dx.numel() * size)
            dw_bytes = (c.numel() * 4 + x.numel() * size
                        + (cb.blocks.numel() + BLOCK_ROWS) * 4)
            with torch.no_grad():
                row["dx_ms" + sfx] = time_ms(
                    torch, lambda: banded_conv_dx(c, adj, dtype))
                row["dx_plain_ms" + sfx] = time_ms(
                    torch, lambda: banded_conv_dx_reference(c, adj, dtype), 3)
                row["dw_ms" + sfx] = time_ms(
                    torch, lambda: banded_conv_dw(c, x, cb))
                row["dw_plain_ms" + sfx] = time_ms(
                    torch, lambda: banded_conv_dw_reference(c, x, cb), 3)
            for part, n_bytes in (("dx", dx_bytes), ("dw", dw_bytes)):
                t_bytes = n_bytes / PEAK_BYTES * 1e3
                row[f"{part}_bound_ms{sfx}"] = max(t_ops, t_bytes)
                row[f"{part}_bound_by{sfx}"] = ("operations" if t_ops >= t_bytes
                                                else "bytes")
        out[name] = row
        print(f"K3 stage {name} ({batch}, {cb.r_in} -> {cb.r_out}, {frames}):"
              + "".join(
                  f" {d} dX {row['dx_ms' + x]:.4f} ms (plain "
                  f"{row['dx_plain_ms' + x]:.4f}, bound "
                  f"{row['dx_bound_ms' + x]:.4f} by {row['dx_bound_by' + x]}),"
                  f" dW {row['dw_ms' + x]:.4f} ms (plain "
                  f"{row['dw_plain_ms' + x]:.4f}, bound "
                  f"{row['dw_bound_ms' + x]:.4f} by {row['dw_bound_by' + x]});"
                  for d, x in (("bf16", ""), ("f32", "_f32"))))
    return out


def k3_band_flops(spec, batch, frames):
    """Flops the level backward computes at (batch, ., frames), in either
    dtype (a float32 flop is three TF32 products): the band-tiled
    recompute, dX over each adjoint's bands, and dW over whole 64-column
    tiles of each band for every 64-frame chunk."""
    from timbre_trap_tpu_torch.ops.fused_level import band_flops

    convs = list(spec.convs())
    total = band_flops(convs + [cb.adjoint for cb in convs], batch * frames)
    padded = batch * -(-frames // 64) * 64
    for cb in convs:
        tiles = -(-max(n for _, n in cb.bands) // 64)
        total += (2 * len(cb.dts) * 2 * 64 * 64 * tiles * cb.n_out_blocks
                  * padded)
    return total


def k3_numbers(torch, model, launches_per_step):
    """K3 at the flagship encoder level 1 (convin fused) at the recipe's
    (8, 1080, 3072), in bf16 and in float32: kernel, plain twin and cuDNN
    times and bounds."""
    import copy

    from timbre_trap_tpu_torch.interop import hwio_params
    from timbre_trap_tpu_torch.models.fused import level_specs
    from timbre_trap_tpu_torch.ops.fused_level import (
        _level_backward, level_backward, level_backward_reference)
    from timbre_trap_tpu_torch.ops.packed_conv import unpack_to_nchw

    net = model.net
    with torch.no_grad():
        spec = level_specs(hwio_params(net), net, True)[0][0]
    dev = next(net.parameters()).device
    g = torch.Generator(device=dev).manual_seed(7)
    b, t = TRAIN_CROPS, model.sliCQ.get_expected_frames(int(TRAIN_SECS * SR))
    xb = (0.3 * torch.randn((b, spec.r_in, t), generator=g, device=dev)
          ).to(torch.bfloat16)
    dyb = torch.randn((b, spec.r_out, t), generator=g, device=dev
                      ).to(torch.bfloat16)
    fwd_flops = needed_flops(spec, b, t)
    bwd_flops = 2 * fwd_flops           # dX and dW, every conv
    computed = k3_band_flops(spec, b, t)
    n_convs = sum(1 for _ in spec.convs())
    out = {"shape": f"encoder level 1 backward ({n_convs} convs, convin "
                    f"fused), x {tuple(xb.shape)} bf16, dy "
                    f"{tuple(dyb.shape)}",
           "bwd_gflop": bwd_flops / 1e9, "recompute_gflop": fwd_flops / 1e9,
           "gflop_computed": computed / 1e9,
           "launches_per_step": launches_per_step}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        sfx, size = ("_f32", 4) if f32 else ("", 2)
        xs, dys = xb.to(dtype), dyb.to(dtype)
        with torch.no_grad():
            ms = time_ms(torch, lambda: level_backward(xs, spec, dys, dtype), 5)
            plain = time_ms(torch, lambda: level_backward_reference(
                xs, spec, dys, dtype), 2)
        lib = torch.nn.Sequential(copy.deepcopy(net.encoder.convin),
                                  copy.deepcopy(net.encoder.block1)).to(dtype)
        x_nchw = unpack_to_nchw(xs, spec.items[0][1].c_in).contiguous()
        x_nchw.requires_grad_(True)
        dy_nchw = unpack_to_nchw(dys, spec.items[-1][1].c_out).contiguous()
        y = lib(x_nchw)
        params = list(lib.parameters())
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            y, [x_nchw] + params, dy_nchw, retain_graph=True), 5)
        del y, lib, x_nchw, dy_nchw
        count = ByteCount(torch)
        with torch.no_grad():
            _level_backward(xs, spec, dys, dtype, True, dtype, count.ops)
        io_bytes = (2 * xs.numel() + dys.numel()) * size
        # bf16: blocks read at bf16, dW written at float32; float32: both.
        w_bytes = sum(cb.blocks.numel() * (size + 4) + cb.bias.numel() * 8
                      + cb.adjoint.blocks.numel() * size
                      for cb in spec.convs())
        t_ops = (f32_ops_ms(bwd_flops) if f32
                 else bwd_flops / PEAK_BF16_FLOPS * 1e3)
        t_bytes = (io_bytes + w_bytes) / PEAK_BYTES * 1e3
        print(f"K3 level backward, encoder level 1 ({n_convs} convs) at "
              f"{tuple(xs.shape)} {dtype}: {ms:.3f} ms, plain {plain:.3f} ms, "
              f"cuDNN autograd {lib_ms:.3f} ms (cudnn.allow_tf32="
              f"{torch.backends.cudnn.allow_tf32}); dX+dW "
              f"{bwd_flops / 1e9:.2f} GFLOP needed, recompute "
              f"{fwd_flops / 1e9:.2f} GFLOP; bound {max(t_ops, t_bytes):.4f} "
              f"ms; stage-by-stage bytes {count.n / 1e9:.3f} GB = "
              f"{count.n / PEAK_BYTES * 1e3:.4f} ms at {PEAK_BYTES / 1e12} TB/s")
        out.update({f"ms{sfx}": ms, f"plain_ms{sfx}": plain,
                    f"library_ms{sfx}": lib_ms,
                    f"bound_ms{sfx}": max(t_ops, t_bytes),
                    f"bound_by{sfx}": ("operations" if t_ops >= t_bytes
                                       else "bytes"),
                    f"stage_bytes{sfx}": count.n,
                    f"stage_bytes_ms{sfx}": count.n / PEAK_BYTES * 1e3})
        del xs, dys, count
    return out


def snr_db(reference, estimate):
    reference = np.asarray(reference, dtype=np.float64)
    noise = reference - np.asarray(estimate, dtype=np.float64)
    return 10.0 * np.log10(np.sum(reference ** 2)
                           / max(np.sum(noise ** 2), 1e-300))


def phase_transform(torch):
    """The flagship sliCQ on the card: a native white-noise round trip over
    2 blocks (> 60 dB), a compat-frame chord round trip (> 30 dB), and the
    card's decode of each frame's coefficients against the CPU's decode of
    the same coefficients (<= 1e-5 * max|x|). Returns the numbers."""
    from timbre_trap_tpu_torch.transform import CQT

    out = {}
    for compat, bar in (("native", 60.0), ("cqt_pytorch", 30.0)):
        card = CQT(N_OCT, BPO, SR, SECS, compat=compat)
        cpu = CQT(N_OCT, BPO, SR, SECS, compat=compat, device="cpu")
        L = card.block_length
        if compat == "native":
            rng = np.random.default_rng(0)
            x = rng.standard_normal((1, 1, 2 * L)).astype(np.float32)
        else:
            x = chord(2 * L / SR, SR)
        coeffs = card.encode(torch.from_numpy(x).cuda())
        y = card.decode_raw(coeffs)
        y_cpu = cpu.decode_raw(coeffs.cpu())
        torch.cuda.synchronize()
        snr = snr_db(x, y.cpu().numpy())
        diff = (y.cpu() - y_cpu).abs().max().item()
        peak = float(np.abs(x).max())
        print(f"transform: {compat} round trip over 2 blocks ("
              f"{'white noise' if compat == 'native' else 'chord'}) "
              f"{snr:.2f} dB (> {bar:.0f}); card vs CPU decode max abs diff "
              f"{diff:.3e} = {diff / peak:.2e} of max|x|")
        check(snr > bar, f"{compat} round trip {snr:.2f} dB <= {bar} dB")
        check(diff <= 1e-5 * peak, f"{compat} decode: card and CPU differ by "
              f"{diff} > 1e-5 * {peak}")
        out[compat] = {"snr_db": snr, "decode_card_vs_cpu": diff / peak}
    return out


def check_recon(torch, y, n_samples, launches, what):
    """reconstruct()'s output and counts: shape (1, 1, n_samples), finite,
    max|y| = 1 within 1e-6; K1 ran, every stage split-TF32; no K2."""
    check(tuple(y.shape) == (1, 1, n_samples), f"{what}: output "
          f"{tuple(y.shape)}, expected (1, 1, {n_samples})")
    check(bool(torch.isfinite(y).all()), f"{what}: output is not finite")
    peak = y.abs().max().item()
    check(abs(peak - 1.0) <= 1e-6, f"{what}: max|y| = {peak}, not 1")
    check(launches[K1_F32] > 0 and launches[K1] == 0,
          f"{what}: K1 stages did not all run the split-TF32 band kernel: "
          f"{launches}")
    check(launches[K2] == 0, f"{what}: K2 was launched")


def phase_reconstruct(torch, model, audio, card):
    """reconstruct() at the flagship, counted: the 100-s clip streams
    through K1's float32 route on the reconstruction spec; its result
    against one pass over the same clip as a card tensor (<= 2e-5); a
    second call timed; a compat-frame flagship model on a 9-s clip, and the
    same model on the CPU (<= 1e-4); a small model on the card against the
    CPU (<= 1e-4). Returns the numbers and
    the main call's launches."""
    from timbre_trap_tpu_torch.models import TimbreTrap

    L = model.sliCQ.block_length
    n_samples = -(-audio.shape[-1] // L) * L
    graphs = len(model._graphs)
    with counting() as launches:
        y = model.reconstruct(audio)
    check_recon(torch, y, n_samples, launches, "reconstruct")
    # The second call replays every group: the first call's forwards less
    # the eager warm-ups of the graphs it captured.
    forwards = (launches[K1_F32] / sum(1 for _ in model._spec(False).convs())
                - (len(model._graphs) - graphs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.reconstruct(audio)
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    whole = model.reconstruct(torch.from_numpy(audio).cuda())
    d_stream = (y - whole).abs().max().item()
    print(f"main: reconstruct {CLIP_SECS:.0f} s clip, launches {launches}; "
          f"streamed vs one pass max abs diff {d_stream:.3e}")
    check(d_stream <= 2e-5, f"streamed reconstruct differs from one pass by "
          f"{d_stream}")
    del whole

    compat = flagship(TimbreTrap, seed=0, transform_compat="cqt_pytorch")
    clip = chord(9.0, SR, seed=2)
    with counting() as launches_c:
        y_c = compat.reconstruct(clip)
    check_recon(torch, y_c, clip.shape[-1], launches_c, "compat reconstruct")
    print(f"main: compat-frame reconstruct 9 s clip, launches {launches_c}")
    del compat
    # The flagship end to end against an independent path: the same seeded
    # compat model on the CPU, where every kernel's plain twin runs.
    y_cpu = flagship(TimbreTrap, seed=0, transform_compat="cqt_pytorch",
                     device="cpu").reconstruct(clip)
    d_flag = (y_c.cpu() - y_cpu).abs().max().item()
    print(f"main: flagship compat reconstruct card vs CPU max abs diff "
          f"{d_flag:.3e}")
    check(d_flag <= 1e-4, f"flagship reconstruct: card and CPU disagree by "
          f"{d_flag}")
    del y_cpu

    small = dict(SMALL, fused="f32", seed=1)
    clip = chord(2.3, 8000, seed=1)
    d_small = (TimbreTrap(**small).reconstruct(clip).cpu()
               - TimbreTrap(**small, device="cpu").reconstruct(clip)
               ).abs().max().item()
    print(f"main: small model reconstruct card vs CPU max abs diff "
          f"{d_small:.3e}")
    check(d_small <= 1e-4, f"reconstruct: card and CPU disagree by {d_small}")

    # Where the time goes: the synthesis of the whole clip's coefficients
    # alone, beside the wall time of the second call.
    coeffs = model.sliCQ.encode(model.sliCQ.pad_to_block_length(
        torch.from_numpy(audio).cuda()))
    synth_ms = time_ms(torch, lambda: model.sliCQ.decode_raw(coeffs), 5)
    numbers = {"reconstruct_rtf": CLIP_SECS / wall_warm,
               "wall_s": wall_warm,
               "streamed_vs_one_pass": d_stream, "small_card_vs_cpu": d_small,
               "flagship_card_vs_cpu": d_flag, "k1_forwards": forwards,
               "decode_ms": synth_ms, "launches_compat": launches_c}
    print(f"reconstruct_rtf: {CLIP_SECS / wall_warm:.2f} second call "
          f"({CLIP_SECS:.0f} s clip, {wall_warm:.3f} s wall, float32 chain, "
          f"synthesis included; decode of the clip's coefficients alone "
          f"{synth_ms:.3f} ms) on {card}")
    return numbers, launches


def route_convs(spec):
    """The conv stages (K1 launches) of one inference forward."""
    specs = [spec] if hasattr(spec, "items") else spec.especs + spec.dspecs
    return sum(1 for s in specs for _ in s.convs())


def forward_parity(torch, model, chunks):
    """One flagship forward of ``model``'s inference route on the 4-chunk
    group ``chunks`` through the kernels against the same route through the
    plain twins on the card (float32): the transcribe branch in bf16 (within
    5e-2 * max|ref|) and float32 (1e-4), the reconstruction branch in
    float32 where the family has two channels. Each kernel run must launch
    K1 once per conv stage, on its dtype's tensor-core route. Returns
    {branch: relative error}."""
    from timbre_trap_tpu_torch.models.fused import fused_forward

    feats = model.features_from_audio(chunks)
    branches = [(True, torch.bfloat16), (True, torch.float32)]
    if model.net.in_channels == 2:
        branches.append((False, torch.float32))
    out = {}
    for transcribe, dtype in branches:
        spec = model._spec(transcribe)
        name = (f"{'transcribe' if transcribe else 'reconstruct'} "
                f"{str(dtype)[6:]}")
        ref = fused_forward(model.net, feats, transcribe, torch.float32, spec,
                            plain=True)
        with counting() as launches:
            got = fused_forward(model.net, feats, transcribe, dtype, spec)
        n = route_convs(spec)
        route, other = ((K1, K1_F32) if dtype == torch.bfloat16
                        else (K1_F32, K1))
        check(launches[route] == n and launches[other] == 0,
              f"{model.variant} forward {name}: launches {launches}, "
              f"expected {n} of {route}")
        err, scale = rel_err(got, ref)
        tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
        check(err <= tol * scale, f"{model.variant} (skips "
              f"{model.net.skip_connections}) forward {name}: error {err} > "
              f"{tol} * {scale}")
        out[name] = err / max(scale, 1e-30)
    return out


@contextlib.contextmanager
def eager_groups():
    """Within the block, every model's chunk groups run eagerly on the card
    (``_infer`` called, no CUDA graph captured or replayed)."""
    from timbre_trap_tpu_torch.models import timbre_trap

    replays = timbre_trap._replays_graphs
    timbre_trap._replays_graphs = lambda device: False
    try:
        yield
    finally:
        timbre_trap._replays_graphs = replays


def plain_transcribe(model, audio):
    """``model.transcribe(audio)`` with every level through the plain twins
    on the card (the same storage dtype and casts as the kernels), its
    chunk groups run eagerly."""
    from timbre_trap_tpu_torch.models.fused import fused_forward

    infer = model._infer

    def plain(chunks, transcribe):
        return fused_forward(model.net, model.features_from_audio(chunks),
                             transcribe, model._dtype(transcribe),
                             model._spec(transcribe), plain=True)

    model._infer = plain
    try:
        with eager_groups():
            return model.transcribe(audio)
    finally:
        model._infer = infer


@contextlib.contextmanager
def float64_forward(model):
    """Within the block, ``model``'s forwards run in float64 through its
    NCHW network (the plain check of the same function): a reference for
    its float32 runs, rounded to float32 only by the overlap-add. The chunk
    groups run eagerly, as in ``plain_transcribe``."""
    net64 = copy.deepcopy(model.net).double()
    infer = model._infer

    def forward(chunks, transcribe):
        feats = model.features_from_audio(chunks).double().movedim(-1, 1)
        return net64(feats, transcribe)

    model._infer = forward
    try:
        with eager_groups():
            yield model
    finally:
        model._infer = infer


def count_forwards(model):
    """Counts the model's inference forwards that run on the card in
    ``.n``: every chunk group (the replay of its CUDA graph) and each
    graph's eager warm-up (its capture runs nothing). ``.restore()`` takes
    the counting off the model."""
    group, capture = model._group, model._capture

    def counted(*args):
        counted.n += 1
        return group(*args)

    def captured(*args):
        counted.n += 1                  # the capture's eager warm-up
        return capture(*args)

    def restore():
        del model._group, model._capture

    counted.n = 0
    counted.restore = restore
    model._group, model._capture = counted, captured
    return counted


def phase_variants(torch, audio, chunks, card):
    """The variants and persistence (phase 3d): the flagship base model
    with skip connections, counted: transcribe of the 100-s clip + peak
    mask (58 bf16 K1 launches a forward, K2 launched, within 5e-2 of the
    float32 run, mask equal to the plain version's), reconstruct (58
    split-TF32 launches a forward, no K2, max|y| = 1), second calls
    timed; one flagship forward of base + skips, FiLM, Mag and MagDB
    without skips and FiLM with skips against the plain twins; a small model
    of every family x skips on the card against the CPU (<= 1e-4); save ->
    load_model round trips on the card, bit for bit. Returns the numbers
    and the launch counts."""
    from timbre_trap_tpu_torch.models import (TimbreTrap, TimbreTrapFiLM,
                                              TimbreTrapMag, TimbreTrapMagDB,
                                              load_model)
    from timbre_trap_tpu_torch.ops import _build
    from timbre_trap_tpu_torch.ops.peaks import peak_mask, peak_mask_reference

    model = flagship(TimbreTrap, skip_connections=True, seed=0)
    per_fwd = route_convs(model._spec(True))
    check(per_fwd == 58, f"the skip route has {per_fwd} conv stages, not 58")
    parity = {"base+skips": forward_parity(torch, model, chunks)}
    L = model.sliCQ.block_length
    n_samples = -(-audio.shape[-1] // L) * L
    forwards = count_forwards(model)

    with counting() as launches:
        acts = model.transcribe(audio)
        mask = peak_mask(acts, 0.5)
    n_fwd = forwards.n
    check(tuple(acts.shape) == (1, model.sliCQ.n_bins,
                                -(-audio.shape[-1] // L)
                                * model.sliCQ.max_window_length),
          f"skips: activations {tuple(acts.shape)}")
    check(bool(torch.isfinite(acts).all()) and acts.min().item() >= 0.0
          and acts.max().item() <= 1.0, "skips: activations not finite or "
          "outside [0, 1]")
    check(torch.equal(mask, peak_mask_reference(acts, 0.5)),
          "skips: the peak mask differs from its plain version")
    check(launches[K1] == per_fwd * n_fwd > 0 and launches[K1_F32] == 0
          and on_tma_epilogue(launches),
          f"skips transcribe: K1 launches {launches} for {n_fwd} forwards, "
          f"expected {per_fwd} bf16 launches a forward, on the TMA "
          f"epilogue")
    check(launches[K2] > 0, "skips transcribe: K2 not launched")
    t0 = time.perf_counter()
    peak_mask(model.transcribe(audio), 0.5)
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    model.fused = "f32"
    acts32 = model.transcribe(audio)
    model.fused = "auto"
    diff = (acts - acts32).abs().max().item()
    # bf16 storage with skip adds departs from float32 by more than the
    # base chain (the JAX package's bf16 skip route does the same on these
    # weights): the kernels are held to the plain bf16 route's own
    # departure, and to 5e-2 where that is smaller.
    diff_plain = (plain_transcribe(model, audio) - acts32).abs().max().item()
    check(diff <= max(5e-2, 1.5 * diff_plain), f"skips: bf16 activations "
          f"differ from f32 by {diff} (the plain bf16 route by {diff_plain})")
    print(f"variants: base + skips transcribe {CLIP_SECS:.0f} s clip, "
          f"{n_fwd} forwards, launches {launches}; bf16 vs f32 max abs diff "
          f"{diff:.3e} (plain bf16 route {diff_plain:.3e})")

    forwards.n = 0
    with counting() as launches_rec:
        y = model.reconstruct(audio)
    n_rec = forwards.n
    check_recon(torch, y, n_samples, launches_rec, "skips reconstruct")
    check(launches_rec[K1_F32] == per_fwd * n_rec,
          f"skips reconstruct: launches {launches_rec} for {n_rec} forwards")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.reconstruct(audio)
    torch.cuda.synchronize()
    wall_rec_warm = time.perf_counter() - t0
    print(f"variants: base + skips reconstruct, {n_rec} forwards, "
          f"launches {launches_rec}")

    # The skip route's forward alone at the main path's shape.
    from timbre_trap_tpu_torch.models.fused import fused_forward

    feats = model.features_from_audio(chunks)
    spec16, spec32 = model._spec(True), model._spec(False)
    route_ms = time_ms(torch, lambda: fused_forward(
        model.net, feats, True, torch.bfloat16, spec16))
    route_ms32 = time_ms(torch, lambda: fused_forward(
        model.net, feats, False, torch.float32, spec32))
    route_plain = time_ms(torch, lambda: fused_forward(
        model.net, feats, True, torch.bfloat16, spec16, plain=True), 3)

    # Each family's flagship forward against the plain twins, and its
    # transcribe of a 9-s clip through K2 (MagDB's activations are the
    # sigmoid output itself, no tanh).
    clip9 = chord(9.0, SR, seed=2)
    peaks = {}
    for cls, skip in ((TimbreTrapFiLM, False), (TimbreTrapMag, False),
                      (TimbreTrapMagDB, False), (TimbreTrapFiLM, True)):
        m = flagship(cls, skip_connections=skip, seed=3)
        label = m.variant + ("+skips" if skip else "")
        parity[label] = forward_parity(torch, m, chunks)
        with counting() as launches_9s:
            a = m.transcribe(clip9)
            mask = peak_mask(a, 0.5)
        n_k2 = launches_9s[K2]
        check(bool(torch.isfinite(a).all()) and a.min().item() >= 0.0
              and a.max().item() <= 1.0, f"{label}: activations not finite "
              f"or outside [0, 1]")
        check(n_k2 == 1 and torch.equal(mask, peak_mask_reference(a, 0.5)),
              f"{label}: K2 launched {n_k2} times or differs from its plain "
              f"version")
        peaks[label] = int(mask.sum())
        del m
    for label, errs in parity.items():
        print(f"variants: {label:11s} flagship forward vs plain twins: "
              + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
              + (f"; 9-s transcribe, K2 exact, {peaks[label]} peaks"
                 if label in peaks else ""))

    ckpt = _build.BUILD_DIR / "smoke_ckpt"
    small_diff, small_f64, round_trips, db_diff = 0.0, 0.0, 0, 0.0
    clip = chord(2.3, 8000, seed=4)
    for cls in (TimbreTrap, TimbreTrapFiLM, TimbreTrapMag, TimbreTrapMagDB):
        for skip in (False, True):
            kw = dict(SMALL, fused="f32", seed=5, skip_connections=skip)
            on_card, on_cpu = cls(**kw), cls(**kw, device="cpu")
            if cls is TimbreTrapMagDB:
                # The dB of bins near the 80-dB floor turns the analysis'
                # rounding (cuFFT against the CPU's FFT, ~1e-7 of the
                # largest magnitude) into ~1e-4 of the rescaled features:
                # the CPU model reads the card's features, and the dB
                # features' own difference is reported.
                x = torch.from_numpy(clip[..., :on_card.sliCQ.block_length])
                db_diff = max(db_diff, (on_card.features_from_audio(x).cpu()
                                        - on_cpu.features_from_audio(x)
                                        ).abs().max().item())
                on_cpu.features_from_audio = (
                    lambda a, card=on_card: card.features_from_audio(
                        a.to(card.device)).cpu())
            got = on_card.transcribe(clip)
            entries = ["transcribe"] + (
                ["reconstruct"] if on_card.net.in_channels == 2 else [])
            for entry in entries:
                out_card = (got if entry == "transcribe"
                            else on_card.reconstruct(clip)).cpu()
                out_cpu = getattr(on_cpu, entry)(clip)
                with float64_forward(on_cpu):
                    ref = getattr(on_cpu, entry)(clip)
                d = (out_card - out_cpu).abs().max().item()
                d_card = (out_card - ref).abs().max().item()
                d_cpu = (out_cpu - ref).abs().max().item()
                # Both are float32 runs of a deep random network: where
                # their roundings part by more than 1e-4, the card must be
                # as close to float64 as the CPU, within the 3x that the
                # float32 kernels are held to.
                check(d <= 1e-4 or d_card <= 3 * d_cpu,
                      f"small {cls.__name__} skips {skip} {entry}: "
                      f"card and CPU disagree by {d}; from float64 the card "
                      f"is {d_card} off, the CPU {d_cpu}")
                small_diff = max(small_diff, d)
                small_f64 = max(small_f64, d_card / max(d_cpu, 1e-30))
            path = on_card.save(str(ckpt / f"{cls.variant}-{skip}"))
            loaded = load_model(path, overrides={"fused": "f32"})
            check(type(loaded) is cls and loaded.hparams == on_card.hparams,
                  f"load_model rebuilt {type(loaded).__name__}")
            check(torch.equal(loaded.transcribe(clip), got),
                  f"small {cls.__name__} skips {skip}: reloaded model differs")
            round_trips += 1
    path = model.save(str(ckpt / "flagship-skips"))
    check(torch.equal(load_model(path).transcribe(clip9),
                      model.transcribe(clip9)),
          "flagship base + skips: reloaded model differs")
    round_trips += 1
    shutil.rmtree(ckpt)
    print(f"variants: small models of every family x skips, card vs CPU max "
          f"abs diff {small_diff:.3e}, the card's distance from float64 at "
          f"most {small_f64:.2f}x the CPU's (MagDB's dB features card vs CPU "
          f"{db_diff:.3e}); {round_trips} save -> load_model round trips on "
          f"the card, bit for bit")
    numbers = {"transcribe_rtf": CLIP_SECS / wall_warm,
               "reconstruct_rtf": CLIP_SECS / wall_rec_warm,
               "bf16_vs_f32": diff, "launches_per_forward": per_fwd,
               "forwards": n_fwd, "forward_vs_plain": parity,
               "route_ms": route_ms, "route_ms_f32": route_ms32,
               "route_plain_ms": route_plain,
               "bf16_vs_f32_plain_route": diff_plain,
               "small_card_vs_cpu": small_diff,
               "small_card_vs_cpu_f64_ratio": small_f64,
               "magdb_features_card_vs_cpu": db_diff,
               "round_trips": round_trips}
    print(f"variants: transcribe_rtf {CLIP_SECS / wall_warm:.2f}, "
          f"reconstruct_rtf {CLIP_SECS / wall_rec_warm:.2f} (second calls; "
          f"base + skips, {CLIP_SECS:.0f} s clip); skip route forward "
          f"{route_ms:.3f} ms bf16, {route_ms32:.3f} ms float32, plain "
          f"{route_plain:.3f} ms, on {card}")
    return numbers, {"transcribe": launches, "reconstruct": launches_rec}


def stage_numbers(torch, stages, batch, frames):
    """K1 alone on each variant geometry at the main path's (batch, R,
    frames): kernel and plain times in bf16 and float32, and the bound."""
    from timbre_trap_tpu_torch.ops.fused_level import (banded_conv,
                                                       banded_conv_reference)
    from timbre_trap_tpu_torch.ops.fused_level import LevelSpec

    out = {}
    for name, cb in stages:
        dev = cb.blocks.device
        x32 = torch.randn((batch, cb.r_in, frames), device=dev)
        flops = needed_flops(LevelSpec([("conv", cb, True)], cb.r_in), batch,
                             frames)
        row = {}
        for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            x = x32.to(dtype)
            sfx = "" if dtype == torch.bfloat16 else "_f32"
            row["ms" + sfx] = time_ms(torch, lambda: banded_conv(x, cb, True))
            row["plain_ms" + sfx] = time_ms(
                torch, lambda: banded_conv_reference(x, cb, True), 3)
            t_bytes = ((cb.r_in + cb.r_out) * batch * frames * size
                       + cb.blocks.numel() * size) / PEAK_BYTES * 1e3
            t_ops = (f32_ops_ms(flops) if sfx
                     else flops / PEAK_BF16_FLOPS * 1e3)
            row["bound_ms" + sfx] = max(t_ops, t_bytes)
            row["bound_by" + sfx] = ("operations" if t_ops >= t_bytes
                                     else "bytes")
        out[name] = row
        print(f"K1 stage {name} ({batch}, {cb.r_in}, {frames}) -> "
              f"{cb.r_out} rows: bf16 {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} by "
              f"{row['bound_by']}), float32 {row['ms_f32']:.4f} ms (plain "
              f"{row['plain_ms_f32']:.4f}, bound {row['bound_ms_f32']:.4f} by "
              f"{row['bound_by_f32']})")
    return out


def stage_kind_numbers(torch, spec, batch, frames, dtype=None):
    """The K1 stage alone in ``dtype`` (default bf16), one conv of each
    kind of the forward chain ``spec`` (the first of its kind) at the main
    path's (batch, R, frames): the device time of the route's wgmma kernel
    (``tt_band_conv_wgmma``, float32 ``tt_band_conv_wgmma_f32``; a stage
    alone can be bound by the host's launch time, a chain of them is not)
    and the bytes the stage must move."""
    from timbre_trap_tpu_torch.ops.fused_level import banded_conv

    dtype = dtype or torch.bfloat16
    size = 2 if dtype == torch.bfloat16 else 4
    picks = {}
    for cb in spec.convs():
        tag = conv_kind(cb) + ("" if cb.c_in == cb.c_out or cb.col_adv == 0
                               else f" {cb.c_in}->{cb.c_out}")
        picks.setdefault(f"{tag} c{cb.c_out}", cb)
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, cb in picks.items():
        x = torch.randn((batch, cb.r_in, frames), generator=gen,
                        device="cuda").to(dtype)
        out[name] = {
            "wgmma_ms": device_ms(torch, lambda: banded_conv(x, cb, True)),
            "bytes_ms": ((cb.r_in + cb.r_out) * batch * frames * size
                         + cb.blocks.numel() * size) / PEAK_BYTES * 1e3}
    print(f"K1 stage by kind ({str(dtype)[6:]}, ({batch}, R, {frames})), "
          "device ms wgmma / bytes: " + "; ".join(
              f"{k} {v['wgmma_ms']:.4f} / {v['bytes_ms']:.4f}"
              for k, v in out.items()))
    return out


def host_us_per_launch(torch, chain, launches, reps=10):
    """The host's microseconds a K1 launch: ``reps`` runs of the
    ``launches``-stage ``chain`` enqueued without a synchronisation (the
    card runs behind; 600 launches stay inside its launch queue), over
    the launches."""
    chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        chain()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / (reps * launches) * 1e6


def phase_f32_accuracy():
    """``tools/f32_accuracy.py`` in its own process, on the float32 route
    (``tt_band_conv_wgmma_f32``): every item and every stage of the chain
    within 3x the IEEE float32 plain version's error against float64.
    Returns its JSON line without the per-entry lists."""
    out = subprocess.run([sys.executable, "-m",
                          "timbre_trap_tpu_torch.tools.f32_accuracy"],
                         capture_output=True, text=True, timeout=900,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(out.returncode == 0, f"f32_accuracy failed: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  f32_accuracy: {line}")
    res = json.loads(lines[-1])
    check(res["worst_item_ratio"] <= 3.0 and res["worst_stage_ratio"] <= 3.0,
          f"the float32 route's error against float64 is over 3x the IEEE "
          f"plain version's: items {res['worst_item_ratio']}, stages "
          f"{res['worst_stage_ratio']}")
    return {k: v for k, v in res.items()
            if k not in ("items", "stages", "backward_convs",
                         "variant_stages")}


def variant_stages(torch):
    """The conv stages the variants add to K1's and K3's geometries: the
    standalone convin and convout of a network with skip connections
    (2 -> 4, 4 -> 2) and those of the one-channel families (1 -> 4,
    4 -> 1), from seeded flagship nets on the card, built with their
    adjoints (the skip route's first encoder and last decoder training
    specs)."""
    from timbre_trap_tpu_torch.interop import hwio_params
    from timbre_trap_tpu_torch.models.fused import level_specs
    from timbre_trap_tpu_torch.models.modules import (TimbreTrapNet,
                                                      init_weights)

    out = []
    for variant, tag in (("base", ""), ("mag", "-mag")):
        net = init_weights(TimbreTrapNet(N_OCT * BPO, LATENT, COMPLEXITY,
                                         variant, True),
                           torch.Generator().manual_seed(6)).cuda()
        with torch.no_grad():
            especs, dspecs = level_specs(hwio_params(net), net, True)
        out += [(f"convin{tag}", especs[0].items[0][1]),
                (f"convout{tag}", dspecs[-1].items[0][1])]
    return out


# The Trainer phase (3f): a synthetic corpus in the layout of
# tests/test_loop.py's ToyMPE (a .wav and a .f0.npy per track).
TRAINER_TRACKS, TRAINER_TRACK_SECS = 8, 12.0
VAL_TRACKS, VAL_SECS = 2, 20.0
TRAINER_STEPS, TRAINER_SWEEPS = 4, 2


def write_corpus(root, n_tracks, secs, sr, seed):
    """``n_tracks`` chord-and-noise tracks (``train.synthetic.chord_tracks``)
    as 16-bit WAVs under ``root``, each with its three partials annotated on
    a 10-ms grid."""
    from timbre_trap_tpu_torch.data.io import save_wav
    from timbre_trap_tpu_torch.train.synthetic import chord_tracks

    os.makedirs(root)
    audio, freqs = chord_tracks(n_tracks, secs, sr, seed)
    times = np.arange(0, secs, 0.01)
    for i in range(n_tracks):
        save_wav(f"{root}/tr{i}.wav", audio[i], sr)
        np.save(f"{root}/tr{i}.f0.npy",
                {"times": times, "pitches": [freqs[i]] * len(times)})
    return root


def corpus_classes():
    """(SmokeAudio, SmokeMPE): the corpus as an audio-only and an MPE
    dataset of the port's data package."""
    from timbre_trap_tpu_torch.data import AudioDataset, MPEDataset

    class SmokeAudio(AudioDataset):
        @staticmethod
        def available_splits():
            return ["all"]

        def get_tracks(self, split):
            return sorted(f[:-4] for f in os.listdir(self.base_dir)
                          if f.endswith(".wav"))

        def get_audio_path(self, track):
            return os.path.join(self.base_dir, f"{track}.wav")

    class SmokeMPE(MPEDataset, SmokeAudio):
        def get_tracks(self, split):
            return SmokeAudio.get_tracks(self, split)

        def get_audio_path(self, track):
            return SmokeAudio.get_audio_path(self, track)

        def get_ground_truth(self, track):
            d = np.load(os.path.join(self.base_dir, f"{track}.f0.npy"),
                        allow_pickle=True).item()
            return d["times"], [np.asarray(p) for p in d["pitches"]]

        def get_ground_truth_path(self, track):
            return os.path.join(self.base_dir, f"{track}.f0.npy")

    return SmokeAudio, SmokeMPE


class Recorder:
    """A writer that keeps what the Trainer and evaluate log."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, key, value, i):
        self.scalars.append((key, float(value), i))

    def add_image(self, key, image, i):
        pass


def make_trainer(root, train_dir, val_dir, seed, rng_states=None,
                 max_epochs=2, n_devices=None):
    """The CLI's Trainer at the flagship geometry: an MPE loader of 4
    shuffled 9-s crops and an audio-only loader of 4 over the same WAVs
    (batch 8), ``"pallas_bf16"``, a checkpoint and a validation sweep
    every 2 steps, ``max_epochs`` epochs of 2 steps, over ``n_devices``
    ranks. ``rng_states`` (the datasets' crop RandomStates) sets where the
    crops' draws start."""
    from timbre_trap_tpu_torch.data import DataLoader
    from timbre_trap_tpu_torch.models import TimbreTrap
    from timbre_trap_tpu_torch.train import Trainer, TrainerConfig

    SmokeAudio, SmokeMPE = corpus_classes()
    model = flagship(TimbreTrap, seed=seed)
    kw = dict(splits=["all"], sample_rate=SR, n_secs=TRAIN_SECS)
    mpe = SmokeMPE(base_dir=train_dir, cqt=model.sliCQ, seed=0, **kw)
    audio = SmokeAudio(base_dir=train_dir, seed=1, **kw)
    if rng_states is not None:
        for ds, st in zip((mpe, audio), rng_states):
            ds.rng.set_state(st)
    val = SmokeMPE(base_dir=val_dir, splits=["all"], sample_rate=SR,
                   cqt=model.sliCQ, n_secs=None)
    config = TrainerConfig(max_epochs=max_epochs, checkpoint_interval=2,
                           batch_size=8, n_secs=TRAIN_SECS,
                           learning_rate=TRAIN_LR, n_epochs_warmup=1,
                           n_devices=n_devices,
                           validation_criteria_set="SmokeMPE",
                           conv_backend="pallas_bf16", root_dir=root)
    trainer = Trainer(model, DataLoader(mpe, 4, shuffle=True, drop_last=True,
                                        seed=2),
                      DataLoader(audio, 4, shuffle=True, drop_last=True,
                                 seed=3),
                      [val], config, writer=Recorder())
    return trainer, (mpe, audio)


def timed_sweeps(torch, trainer, datasets):
    """Wrap the trainer's checkpoint-and-validate and validate calls and
    its steps to record their walls (synchronized), the prefetch thread's
    time to load and compose each batch, and the datasets' crop
    RandomStates at each checkpoint."""
    walls = {"checkpoint": [], "evaluate": [], "step": [], "compose": []}
    rng_states = {}

    def timed(key, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
            return out
        return run

    inner = trainer._checkpoint_and_validate

    def checkpoint(*args):
        rng_states[trainer.batch_count] = [ds.rng.get_state()
                                           for ds in datasets]
        return inner(*args)

    trainer._checkpoint_and_validate = timed("checkpoint", checkpoint)
    trainer._validate_and_track = timed("evaluate",
                                        trainer._validate_and_track)
    get_step = trainer._get_step
    trainer._get_step = lambda key: timed("step", get_step(key))
    epoch_batches = trainer._epoch_batches

    def composed(*args):
        batches = epoch_batches(*args)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            walls["compose"].append(time.perf_counter() - t0)
            yield batch

    trainer._epoch_batches = composed
    return walls, rng_states


def profile_evaluate(torch, model, eval_set):
    """Host seconds of one ``evaluate`` call under ``cProfile``, total and
    in its parts (cumulative; the forward's device time lands in the first
    call that waits for it, the mask's ``float``)."""
    import cProfile
    import pstats

    from timbre_trap_tpu_torch.eval import evaluate

    parts = {"__getitem__": "dataset items", "forward": "forward",
             "features_from_audio": "features",
             "masked_peak_estimates": "peak mask",
             "activations_to_multi_pitch": "mask to pitches",
             "evaluate": "evaluate", "signal_distortion_ratio": "SDR",
             "decode": "synthesis"}
    prof = cProfile.Profile()
    prof.enable()
    evaluate(model, eval_set, {"reconstruction": 1, "transcription": 1,
                               "consistency": 1})
    torch.cuda.synchronize()
    prof.disable()
    out = {}
    for (path, _, name), row in pstats.Stats(prof).stats.items():
        if "timbre_trap_tpu_torch" not in path or name not in parts:
            continue
        key = parts[name]
        if name == "evaluate":
            key = ("evaluate" if path.endswith("evaluation.py")
                   else "metrics")
        out[key] = max(out.get(key, 0.0), row[3])
    return out


def evaluate_card_vs_cpu(torch, root):
    """``evaluate`` of a small model on the card against the same weights
    on the CPU over a short toy set, with cuDNN's TF32 default on (the
    evaluation scopes it off), held by ``hold_card_to_cpu``. Returns the
    gaps."""
    from timbre_trap_tpu_torch.eval import evaluate
    from timbre_trap_tpu_torch.models import TimbreTrap

    _, SmokeMPE = corpus_classes()
    toy = write_corpus(f"{root}/toy", 2, 3.0, SMALL["sample_rate"], seed=7)
    card = TimbreTrap(**SMALL, seed=3)
    cpu = TimbreTrap(**SMALL, seed=3, device="cpu")
    mult = {"reconstruction": 1, "transcription": 1, "consistency": 1}

    def results(model):
        ds = SmokeMPE(base_dir=toy, splits=["all"],
                      sample_rate=SMALL["sample_rate"], cqt=model.sliCQ,
                      n_secs=None)
        return evaluate(model, ds, mult), ds

    (got, ds), (want, _) = results(card), results(cpu)
    check(torch.backends.cudnn.allow_tf32, "evaluate left cuDNN's TF32 "
          "flag changed")
    return hold_card_to_cpu(torch, card, cpu, ds, got, want,
                            "trainer: evaluate card vs CPU (small model, "
                            "2 x 3-s tracks, TF32 default on)")


def hold_card_to_cpu(torch, card, cpu, ds, got, want, label):
    """``evaluate`` results ``got`` of the model ``card`` on the dataset
    ``ds`` against ``want`` of the same weights on the CPU (``cpu``):
    losses within 1e-4 relative, the SDR within 1e-3 dB, the ``mpe/*``
    results equal, or, where the peak masks part, the card's activations
    within 3x the CPU's distance from a float64 run. Returns the gaps."""
    from timbre_trap_tpu_torch.device import ieee_convs
    from timbre_trap_tpu_torch.eval.evaluation import masked_peak_estimates
    from timbre_trap_tpu_torch.eval.multipitch import MAX_FREQ
    from timbre_trap_tpu_torch.transform.design import midi_to_hz

    check(set(got) == set(want), f"{label}: keys {set(got) ^ set(want)}")
    loss_rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                   for k in want if k.startswith("loss/"))
    sdr_gap = abs(got["reconstruction/SDR"] - want["reconstruction/SDR"])
    mpe_diff = [k for k in want if k.startswith("mpe/") and got[k] != want[k]]
    out = {"loss_rel": loss_rel, "sdr_gap_db": sdr_gap,
           "mpe_keys_differ": mpe_diff}
    check(loss_rel <= 1e-4, f"{label}: losses off by {loss_rel}")
    check(sdr_gap <= 1e-3, f"{label}: SDR off by {sdr_gap} dB")
    if mpe_diff:
        # Where a mask bit parts, hold the card's activations to the CPU's
        # distance from a float64 forward of the same weights.
        net64 = copy.deepcopy(cpu.net).double()
        bits, d_card, d_cpu = 0, 0.0, 0.0
        invalid = midi_to_hz(cpu.sliCQ.midi_freqs) > MAX_FREQ
        for data in ds:
            audio = np.asarray(data["audio"], np.float32)[None]
            audio = np.pad(audio, [(0, 0), (0, 0), (0, -audio.shape[-1]
                                                  % cpu.sliCQ.block_length)])
            x = torch.from_numpy(audio)
            with torch.no_grad(), ieee_convs(card.device):
                a_card = card.to_activations(card.forward(x.cuda())[2]).cpu()
                a_cpu = cpu.to_activations(cpu.forward(x)[2])
                feats = cpu.features_from_audio(x).movedim(-1, 1).double()
                lat, emb = net64.encode(feats)
                a64 = cpu.to_activations(net64.decode(
                    lat, net64.apply_skip_connections(emb), True))
            bits += int((masked_peak_estimates(a_card, invalid)
                         != masked_peak_estimates(a_cpu, invalid)).sum())
            d_card = max(d_card, (a_card.double() - a64).abs().max().item())
            d_cpu = max(d_cpu, (a_cpu.double() - a64).abs().max().item())
        print(f"{label}: {mpe_diff} differ; {bits} mask bits part; from "
              f"float64 the card's activations {d_card:.2e}, the CPU's "
              f"{d_cpu:.2e}")
        check(d_card <= 3 * d_cpu, f"{label}: the card's activations "
              f"{d_card} from float64, the CPU's {d_cpu}")
        out.update(mask_bits_differ=bits, f64_card=d_card, f64_cpu=d_cpu)
    print(f"{label}: losses rel {loss_rel:.2e}, SDR "
          f"{got['reconstruction/SDR']:.4f} vs {want['reconstruction/SDR']:.4f}"
          f" dB, mpe/* {'equal' if not mpe_diff else 'differ: ' + str(mpe_diff)}")
    return out


def phase_trainer(torch, card, train_step_ms):
    """The Trainer on the card (phase 3f), fed by the data package and
    validated by ``evaluate``: a timed ``run()`` of 4 steps and 2 sweeps
    at the flagship geometry, ``load_model`` of a Trainer checkpoint,
    exact resume from the first checkpoint (its 2 steps and sweep
    counted); ``evaluate`` and the ``"flax"`` step card against CPU.
    Returns (numbers, the resumed run's launches)."""
    import tempfile

    from timbre_trap_tpu_torch.data.io import load_audio
    from timbre_trap_tpu_torch.models import TimbreTrap, load_model
    from timbre_trap_tpu_torch.train import synthetic_batch

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train_dir = write_corpus(f"{tmp}/train", TRAINER_TRACKS,
                                 TRAINER_TRACK_SECS, SR, seed=11)
        val_dir = write_corpus(f"{tmp}/val", VAL_TRACKS, VAL_SECS, SR,
                               seed=12)
        # The first load builds the native audio loader where the checkout
        # has none (native/build/ is not committed): a one-time cost kept
        # out of the Trainer's numbers.
        t0 = time.perf_counter()
        load_audio(f"{train_dir}/tr0.wav", sample_rate=SR)
        first_load_s = time.perf_counter() - t0
        trainer, datasets = make_trainer(f"{tmp}/run_a", train_dir,
                                         val_dir, seed=9)
        walls, rng_states = timed_sweeps(torch, trainer, datasets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best, best_results = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0

        check(trainer.batch_count == TRAINER_STEPS,
              f"trainer ran {trainer.batch_count} steps")
        logged = trainer.writer.scalars
        check(all(np.isfinite(v) for _, v, _ in logged),
              f"trainer: a logged metric is not finite: "
              f"{[(k, v) for k, v, _ in logged if not np.isfinite(v)]}")
        with open(f"{tmp}/run_a/metrics.json") as fh:
            metrics = json.load(fh)
        for key in ("mpe/f1-score", "reconstruction/SDR", "loss/total"):
            series = metrics.get(f"SmokeMPE/{key}", {})
            check(series.get("steps") == [2, 4]
                  and all(np.isfinite(series["values"])),
                  f"trainer: metrics.json SmokeMPE/{key} {series}")
        models_dir = f"{tmp}/run_a/models"
        for path in ("model-2/checkpoint.pt", "model-4/checkpoint.pt",
                     "model-2.trainer.json", "model-4.trainer.json",
                     "hparams.json"):
            check(os.path.isfile(f"{models_dir}/{path}"),
                  f"trainer: {path} was not written")
        final = {k: v.clone() for k, v in trainer.model.net.state_dict().items()}
        loaded = load_model(f"{models_dir}/model-4")
        check(all(torch.equal(loaded.net.state_dict()[k], v)
                  for k, v in final.items()),
              "trainer: load_model of model-4 differs from the trained model")
        check(type(loaded) is TimbreTrap and loaded.hparams
              == trainer.model.hparams, "trainer: load_model hparams")
        del loaded
        losses = [v for k, v, _ in logged if k == "train/loss/total"]
        eval_parts = profile_evaluate(torch, trainer.model,
                                      trainer.validation_sets[0])
        print("trainer: one evaluate sweep under cProfile, host s "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                  eval_parts.items(), key=lambda kv: -kv[1])))
        print(f"trainer: first audio load {first_load_s:.3f} s (the native "
              "loader's build where missing); step walls (s) " + " ".join(
            f"{w:.3f}" for w in walls["step"]) + "; batch loads + "
            "compositions on the prefetch thread (s) " + " ".join(
                f"{w:.3f}" for w in walls["compose"]))
        steps_s = run_s - sum(walls["checkpoint"])
        trainer_step_ms = steps_s / TRAINER_STEPS * 1e3
        evaluate_s = walls["evaluate"]
        val_rtf = VAL_TRACKS * VAL_SECS / float(np.mean(evaluate_s))
        print(f"trainer: run() {TRAINER_STEPS} pallas_bf16 steps (batch "
              f"4 MPE + 4 audio-only {TRAIN_SECS:g}-s crops) and "
              f"{TRAINER_SWEEPS} "
              f"checkpoints + sweeps in {run_s:.3f} s; loss/total "
              + " ".join(f"{v:.4f}" for v in losses)
              + f"; best checkpoint {best}, f1 "
              f"{best_results['SmokeMPE']['mpe/f1-score']}")
        print(f"trainer_step_ms: {trainer_step_ms:.1f} (run() wall less its "
              f"checkpoints and sweeps, over {TRAINER_STEPS} steps; bare "
              f"train_step_ms {train_step_ms:.1f}); evaluate_s per sweep "
              + " ".join(f"{s:.3f}" for s in evaluate_s)
              + f" ({VAL_TRACKS} x {VAL_SECS:.0f}-s tracks, validation RTF "
              f"{val_rtf:.1f}); checkpoint + sweep walls "
              + " ".join(f"{s:.3f}" for s in walls["checkpoint"])
              + f"; on {card}")

        # Exact resume: a fresh Trainer (another seed's weights) restored
        # from model-2, its datasets' crop draws where run A's stood at
        # that checkpoint, runs to the end as run A did; counted: its 2
        # steps on the bf16 kernels alone, K2 once a track of its sweep.
        resumed, _ = make_trainer(f"{tmp}/run_b", train_dir, val_dir,
                                  seed=10, rng_states=rng_states[2])
        check(resumed.restore(f"{models_dir}/model-2") == 2,
              "trainer: restore did not return batch 2")
        with counting() as launches:
            resumed.run()
        check(bf16_only(launches) and launches[SEED] > 0,
              f"trainer: the steps did not run K1, K3 and the seed on bf16 "
              f"kernels alone: {launches}")
        check(launches[K2] == VAL_TRACKS, f"trainer: K2 launched "
              f"{launches[K2]} times in a sweep of {VAL_TRACKS} tracks")
        pa, pb = trainer.plateau, resumed.plateau
        state_a = (trainer.batch_count, trainer.best_checkpoint,
                   trainer.n_ckpt_elapsed, pa.scale, pa.best, pa.num_bad,
                   pa.cooldown_counter)
        state_b = (resumed.batch_count, resumed.best_checkpoint,
                   resumed.n_ckpt_elapsed, pb.scale, pb.best, pb.num_bad,
                   pb.cooldown_counter)
        same = all(torch.equal(resumed.model.net.state_dict()[k], v)
                   for k, v in final.items())
        same_mu = all(torch.equal(resumed.opt_state[m][n],
                                  trainer.opt_state[m][n])
                      for m in ("mu", "nu") for n in trainer.opt_state[m])
        check(same and same_mu and state_a == state_b,
              f"trainer: the resumed run differs from the uninterrupted "
              f"one (parameters equal {same}, Adam moments equal {same_mu},"
              f" state {state_b} vs {state_a})")
        print(f"trainer: restored from model-2 into a fresh model, run to "
              f"the end: parameters and Adam moments equal bit for bit, "
              f"state {state_b}; launches {launches}")
        del trainer, resumed
        torch.cuda.empty_cache()

        # The card against the CPU with cuDNN's TF32 default on: evaluate
        # and one "flax" step scope it off themselves.
        torch.backends.cudnn.allow_tf32 = True
        try:
            eval_gap = evaluate_card_vs_cpu(torch, tmp)
            small = TimbreTrap(**SMALL, seed=4)
            small_cpu = TimbreTrap(**SMALL, seed=4, device="cpu")
            a_s, g_s = synthetic_batch(small, 2, 1.0, seed=6)
            ws = {k: v.clone() for k, v in small.net.state_dict().items()}
            got = one_step(torch, small, ws, "flax", a_s, g_s, TRAIN_LR)
            want = one_step(torch, small_cpu, ws, "flax", a_s, g_s, TRAIN_LR)
            check(torch.backends.cudnn.allow_tf32, "the flax step left "
                  "cuDNN's TF32 flag changed")
            flax_gap = check_kernel_step(
                "small", got, ({k: v for k, v in want[0].items()},
                               {n: g.cuda() for n, g in want[1].items()}),
                float64_grads(small, ws, a_s, g_s),
                pair="flax card vs CPU")
        finally:
            torch.backends.cudnn.allow_tf32 = False
    phase_s = time.perf_counter() - t_phase
    print(f"trainer: phase {phase_s:.1f} s")
    numbers = {"trainer_step_ms": trainer_step_ms,
               "train_step_ms": train_step_ms, "run_s": run_s,
               "evaluate_s": evaluate_s, "checkpoint_s": walls["checkpoint"],
               "step_s": walls["step"], "compose_s": walls["compose"],
               "first_load_s": first_load_s,
               "evaluate_profile_s": eval_parts,
               "validation_rtf": val_rtf, "loss_total": losses,
               "best_checkpoint": best, "launches": launches,
               "resume_bitwise": True, "evaluate_card_vs_cpu": eval_gap,
               "flax_card_vs_cpu": flax_gap, "phase_s": phase_s}
    return numbers, launches



# The CLI phase (3g): corpora in the layouts of their wrappers (as
# tests/test_datasets.py writes them), of 12-s chord-and-noise tracks
# (``train.synthetic.chord_tracks``): URMP's nine validation pieces, two
# tracks of Bach10, Su and GuitarSet, and TRIOS's five multitracks (its
# wrapper lists every multitrack as a track, so all five are there), cut
# to 5 s each: about the audio of two tracks.
URMP_VAL_SPLITS = ["01", "02", "12", "13", "24", "25", "31", "38", "39"]
TRIOS_MULTITRACKS = ["brahms", "lussier", "mozart", "schubert", "take_five"]
TRIOS_INSTRUMENTS = ["piano", "violin", "horn"]
CLI_TRACK_SECS, TRIOS_SECS = 12.0, 5.0
# The train CLI at its defaults (batch 8 of 9-s crops): the nine URMP
# tracks make one batch an epoch, so 4 epochs with a checkpoint every 2
# steps give 4 steps and 2 sweeps.
CLI_EPOCHS, CLI_INTERVAL = 4, 2
# The sets of the evaluate CLI's card-against-CPU check.
CPU_DATASETS = ["Bach10", "Su"]
def write_midi(path, notes):
    """A one-track MIDI file of ``notes`` (pitch, onset s, offset s) at 480
    ticks a beat and 120 beats a minute."""
    def varlen(n):
        out = [n & 0x7F]
        n >>= 7
        while n:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        return bytes(reversed(out))

    events = sorted([(int(on * 960), bytes([0x90, p, 80]))
                     for p, on, _ in notes]
                    + [(int(off * 960), bytes([0x80, p, 0]))
                       for p, _, off in notes], key=lambda e: e[0])
    track, last = b"", 0
    for tick, msg in events:
        track += varlen(tick - last) + msg
        last = tick
    track += varlen(0) + bytes([0xFF, 0x2F, 0x00])
    header = b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big") \
        + (1).to_bytes(2, "big") + (480).to_bytes(2, "big")
    with open(path, "wb") as fh:
        fh.write(header + b"MTrk" + len(track).to_bytes(4, "big") + track)


def write_cli_corpora(root, seed):
    """The five evaluation corpora under ``root``, at 22.05 kHz; returns
    {dataset name: base dir}."""
    import scipy.io

    from timbre_trap_tpu_torch.data.io import save_wav
    from timbre_trap_tpu_torch.train.synthetic import chord_tracks
    from timbre_trap_tpu_torch.transform.design import hz_to_midi

    secs = CLI_TRACK_SECS
    n_tracks = len(URMP_VAL_SPLITS) + 6 + len(TRIOS_MULTITRACKS)
    audio, freqs = chord_tracks(n_tracks, secs, SR, seed)
    t = np.arange(audio.shape[-1]) / SR
    tracks = iter(zip(audio, freqs))
    dirs = {name: f"{root}/{name}" for name in
            ("URMP", "Bach10", "Su", "TRIOS", "GuitarSet")}

    def partial(f):
        return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)

    times = np.arange(0, secs, 0.01)
    for split in URMP_VAL_SPLITS:
        mix, fs = next(tracks)
        track = f"{split}_Piece{split}_vn_va_vc"
        d = f"{dirs['URMP']}/{track}"
        os.makedirs(d)
        save_wav(f"{d}/AuMix_{track}.wav", mix, SR)
        for i, (ins, f) in enumerate(zip(("vn", "va", "vc"), fs), 1):
            stem = f"{i}_{ins}_{split}_Piece{split}"
            save_wav(f"{d}/AuSep_{stem}.wav", partial(f), SR)
            np.savetxt(f"{d}/F0s_{stem}.txt", np.stack(
                [times, np.full_like(times, f)], axis=-1))
    for k in range(2):
        mix, fs = next(tracks)
        track = f"{k + 1:02d}-Piece{k + 1}"
        d = f"{dirs['Bach10']}/{track}"
        os.makedirs(d)
        save_wav(f"{d}/{track}.wav", mix, SR)
        n_frames = int((secs - 0.023) / 0.010)
        gtf0 = np.zeros((4, n_frames))
        gtf0[:3] = hz_to_midi(fs)[:, None]
        scipy.io.savemat(f"{d}/{track}-GTF0s.mat", {"GTF0s": gtf0})
    for name in ("audio", "gt_Note"):
        os.makedirs(f"{dirs['Su']}/{name}")
    for track in ("PQ02", "SQ01"):
        mix, fs = next(tracks)
        save_wav(f"{dirs['Su']}/audio/{track}_audio.wav", mix, SR)
        np.savetxt(f"{dirs['Su']}/gt_Note/{track}_note.txt",
                   np.array([[0.0, secs, f] for f in fs]))
    for name in ("annotation", "audio_mono-mic"):
        os.makedirs(f"{dirs['GuitarSet']}/{name}")
    for track in ("05_BN1-129-Eb_comp", "05_Funk2-119-G_solo"):
        mix, fs = next(tracks)
        save_wav(f"{dirs['GuitarSet']}/audio_mono-mic/{track}_mic.wav", mix,
                 SR)
        jam = {"file_metadata": {"duration": secs}, "annotations": [
            {"namespace": "pitch_contour", "data": [
                {"time": float(tc), "duration": 0.0,
                 "value": {"frequency": float(f), "voiced": True,
                           "index": i}} for tc in times]}
            for i, f in enumerate(fs)]}
        with open(f"{dirs['GuitarSet']}/annotation/{track}.jams", "w") as fh:
            json.dump(jam, fh)
    n = int(TRIOS_SECS * SR)
    for multitrack in TRIOS_MULTITRACKS:
        mix, fs = next(tracks)
        d = f"{dirs['TRIOS']}/{multitrack}"
        os.makedirs(d)
        save_wav(f"{d}/mix.wav", mix[..., :n], SR)
        for ins, f in zip(TRIOS_INSTRUMENTS, fs):
            save_wav(f"{d}/{ins}.wav", partial(f)[:n], SR)
            write_midi(f"{d}/{ins}.mid",
                       [(int(round(float(hz_to_midi(f)))), 0.0, TRIOS_SECS)])
    return dirs


def cli_train(torch, argv):
    """The train CLI's ``main(argv)``, its Trainer timed as phase 3f times
    its own. Returns (trainer, numbers)."""
    from timbre_trap_tpu_torch.experiments import train as cli
    from timbre_trap_tpu_torch.train import Trainer

    held = {}

    class TimedTrainer(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            held["walls"], _ = timed_sweeps(torch, self, ())
            held["trainer"] = self

        def run(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().run()
            torch.cuda.synchronize()
            held["run_s"] = time.perf_counter() - t0
            return out

    cli.Trainer = TimedTrainer
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        best, best_results = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cli.Trainer = Trainer
    walls = held["walls"]
    steps = held["trainer"].batch_count
    numbers = {"wall_s": wall, "run_s": held["run_s"],
               "trainer_step_ms": (held["run_s"] - sum(walls["checkpoint"]))
               / max(steps, 1) * 1e3,
               "evaluate_s": walls["evaluate"],
               "checkpoint_s": walls["checkpoint"], "step_s": walls["step"],
               "compose_s": walls["compose"], "steps": steps,
               "best_checkpoint": best, "best_results": best_results,
               "peak_bytes": torch.cuda.max_memory_allocated()}
    return held["trainer"], numbers


def printed_results(text):
    """{name: results} from the evaluate CLI's "[name] {...}" lines."""
    import ast

    out = {}
    for line in text.splitlines():
        if line.startswith("["):
            name, _, rest = line.partition("] ")
            out[name[1:]] = ast.literal_eval(rest)
    return out


def cli_evaluate(argv):
    """The evaluate CLI's ``main(argv)``, its stdout kept and echoed: returns
    (printed results, returned results, the model it loaded, wall s)."""
    import io

    from timbre_trap_tpu_torch.experiments import evaluate as cli

    held = {}
    load_model = cli.load_model

    def loading(*args, **kwargs):
        held["model"] = load_model(*args, **kwargs)
        return held["model"]

    cli.load_model = loading
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            returned = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        cli.load_model = load_model
    sys.stdout.write(buf.getvalue())
    return printed_results(buf.getvalue()), returned, held["model"], wall


def phase_cli(torch, card, trainer_numbers):
    """The port's CLIs on the card (phase 3g), through their ``main(argv)``
    at the flagship defaults on the corpora of ``write_cli_corpora``: the
    train CLI's counted run (2 steps, a sweep), then its timed run (4
    steps, 2 sweeps), the evaluate CLI on its checkpoint over the five
    sets (its printed results equal to ``evaluate`` on the same loaded
    model; a small model's results on the card against the CPU), and the
    sonify CLI on the Bach10 mixtures. Returns (numbers, launches)."""
    import tempfile

    from timbre_trap_tpu_torch.data.datasets.MixedMultiPitch import Bach10
    from timbre_trap_tpu_torch.data.io import load_audio
    from timbre_trap_tpu_torch.eval import evaluate
    from timbre_trap_tpu_torch.experiments import sonify
    from timbre_trap_tpu_torch.experiments import train as train_cli
    from timbre_trap_tpu_torch.experiments.evaluate import (DATASETS,
                                                            evaluation_set)
    from timbre_trap_tpu_torch.models import TimbreTrap, load_model
    from timbre_trap_tpu_torch.train import reference_recipe_step_time

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_cli_corpora(f"{tmp}/corpora", seed=21)
        n_tracks = {"URMP": len(URMP_VAL_SPLITS), "Bach10": 2, "Su": 2,
                    "TRIOS": len(TRIOS_MULTITRACKS), "GuitarSet": 2}

        # The train CLI: --debug, every other flag at its default but the
        # steps and sweeps (cut as phase 3f cuts them). First a counted
        # run of one checkpoint interval: its steps and its sweep.
        def train_argv(root, epochs):
            return ["--debug", "--urmp-dir", dirs["URMP"], "--root-dir",
                    root, "--max-epochs", str(epochs),
                    "--checkpoint-interval", str(CLI_INTERVAL)]

        with counting() as launches:
            train_cli.main(train_argv(f"{tmp}/run_counted", CLI_INTERVAL))
        check(bf16_only(launches) and all(
            launches[k] == CLI_INTERVAL * n
            for k, n in RECIPE_STEP_LAUNCHES.items()),
              f"cli train: {CLI_INTERVAL} steps launched {launches}, not "
              f"{CLI_INTERVAL} x {RECIPE_STEP_LAUNCHES} on bf16 kernels")
        check(launches[K2] == n_tracks["URMP"], f"cli train: K2 launched "
              f"{launches[K2]} times in a sweep of {n_tracks['URMP']} tracks")
        print(f"cli: train --max-epochs {CLI_INTERVAL} counted, launches "
              f"{launches}")
        root = f"{tmp}/run"
        print(f"cli: train --max-epochs {CLI_EPOCHS} --checkpoint-interval "
              f"{CLI_INTERVAL} (cut: {CLI_EPOCHS} steps of the defaults' "
              f"5000 epochs x 1 step, a checkpoint and sweep every "
              f"{CLI_INTERVAL} steps of the defaults' 250), timed")
        trainer, train = cli_train(torch, train_argv(root, CLI_EPOCHS))
        steps = CLI_EPOCHS
        check(train["steps"] == steps, f"cli train: {train['steps']} steps")
        with open(f"{root}/metrics.json") as fh:
            metrics = json.load(fh)
        for key in ("mpe/f1-score", "reconstruction/SDR", "loss/total"):
            series = metrics.get(f"URMP/{key}", {})
            check(series.get("steps") == list(range(CLI_INTERVAL, steps + 1,
                                                    CLI_INTERVAL))
                  and all(np.isfinite(series["values"])),
                  f"cli train: metrics.json URMP/{key} {series}")
        ckpt = f"{root}/models/model-{steps}"
        loaded = load_model(ckpt)
        check(all(torch.equal(loaded.net.state_dict()[k], v) for k, v in
                  trainer.model.net.state_dict().items())
              and loaded.hparams == trainer.model.hparams,
              f"cli train: load_model of model-{steps} differs from the "
              "trained model")
        del loaded, trainer
        torch.cuda.empty_cache()
        print(f"cli: train wall {train['wall_s']:.3f} s (run() "
              f"{train['run_s']:.3f} s); step walls (s) " + " ".join(
                  f"{w:.3f}" for w in train["step_s"]) + "; batch loads + "
              "compositions on the prefetch thread (s) " + " ".join(
                  f"{w:.3f}" for w in train["compose_s"]) + "; sweeps (s) "
              + " ".join(f"{w:.3f}" for w in train["evaluate_s"])
              + f" ({n_tracks['URMP']} x {CLI_TRACK_SECS:.0f}-s tracks); "
              f"peak {train['peak_bytes'] / 2**30:.2f} GiB")
        print(f"cli: trainer_step_ms {train['trainer_step_ms']:.1f} (the "
              f"CLI's --n-workers 8, batch 8 MPE crops) beside phase 3f's "
              f"{trainer_numbers['trainer_step_ms']:.1f} (serial loader, 4 "
              f"MPE + 4 audio-only crops); bare train_step_ms "
              f"{trainer_numbers['train_step_ms']:.1f}; on {card}")

        # The "flax" backend's recipe step without remat (the CLI turns
        # remat on for it): its time and peak memory, the baseline that
        # phase 3h's rematted step is compared with.
        flax_s, _, flax_peak = reference_recipe_step_time(
            flagship(TimbreTrap, seed=2), conv_backend="flax", iters=1,
            return_memory=True)
        torch.cuda.empty_cache()
        print(f"cli: the \"flax\" backend's recipe step (batch 8 x 3 "
              f"blocks, no remat) {flax_s * 1e3:.1f} ms, peak "
              f"{flax_peak / 2**30:.2f} GiB; on {card}")

        # The evaluate CLI on the train CLI's checkpoint, on the card.
        base_dirs = [dirs[name] for name in DATASETS]
        argv = (["--checkpoint", ckpt, "--datasets"] + DATASETS
                + ["--base-dirs"] + base_dirs)
        with counting() as eval_launches:
            printed, returned, model, _ = cli_evaluate(argv)
        check(printed == returned and set(printed) == set(DATASETS),
              f"cli evaluate: printed {printed} returned {returned}")
        check(eval_launches[K2] == sum(n_tracks.values()),
              f"cli evaluate: K2 launched {eval_launches[K2]} times "
              f"over {sum(n_tracks.values())} tracks")
        check(all(np.isfinite(v) for r in printed.values()
                  for v in r.values()), "cli evaluate: a result is not finite")
        direct = {name: evaluate(model, evaluation_set(name, dirs[name], SR,
                                                       model.sliCQ),
                                 {"reconstruction": 1, "transcription": 1,
                                  "consistency": 1}) for name in DATASETS}
        check(direct == printed, f"cli evaluate: printed results differ "
              f"from evaluate() on the same model: {printed} vs {direct}")
        del model
        print(f"cli: evaluate over {sum(n_tracks.values())} tracks "
              f"({', '.join(f'{k} {v}' for k, v in n_tracks.items())}), "
              f"launches {eval_launches}; the printed "
              f"results equal evaluate() on the loaded model")

        # Card against CPU through the CLI: a small model (8 kHz) on the
        # Bach10 (frame-level F0s) and Su (notes) sets, cut to these two for
        # the CPU's time.
        small = f"{tmp}/small"
        TimbreTrap(**SMALL, seed=3).save(small)
        argv = (["--checkpoint", small, "--sample-rate",
                 str(SMALL["sample_rate"]), "--datasets"] + CPU_DATASETS
                + ["--base-dirs"] + [dirs[name] for name in CPU_DATASETS])
        got, _, card_model, _ = cli_evaluate(argv)
        want, _, cpu_model, cpu_wall = cli_evaluate(argv + ["--device",
                                                            "cpu"])
        gaps = {}
        for name in CPU_DATASETS:
            ds = evaluation_set(name, dirs[name], SMALL["sample_rate"],
                                cpu_model.sliCQ)
            gaps[name] = hold_card_to_cpu(
                torch, card_model, cpu_model, ds, got[name], want[name],
                f"cli: evaluate {name} card vs CPU (small model)")
        del card_model, cpu_model

        # The sonify CLI on the Bach10 mixtures, counted.
        out_dir = f"{tmp}/sonify"
        with counting() as son_launches:
            sonify.main(["--checkpoint", ckpt, "--bach10-dir", dirs["Bach10"],
                         "--output-dir", out_dir])
        check(son_launches[K1] > 0 and son_launches[K1_F32] > 0
              and son_launches[K2] == 0,
              f"cli sonify: K1 did not run both routes (bf16 for _scr, "
              f"split-TF32 for _rec), or K2 ran: {son_launches}")
        bach10 = Bach10(base_dir=dirs["Bach10"], splits=None, sample_rate=SR,
                        cqt=None)
        snrs = {}
        for track in bach10.tracks:
            x = bach10.get_audio(track)
            x = np.pad(x, [(0, 0), (0, -x.shape[-1] % (SECS * SR))])
            for kind in ("ref", "rec", "scr"):
                y, fs = load_audio(f"{out_dir}/{track}_{kind}.wav",
                                   normalize=False)
                check(fs == SR and y.shape == x.shape
                      and np.isfinite(y).all(), f"cli sonify: "
                      f"{track}_{kind}.wav {y.shape} at {fs} Hz")
                if kind == "ref":
                    snrs[track] = float(snr_db(x, y))
        check(len(os.listdir(out_dir)) == 3 * len(bach10),
              f"cli sonify: wrote {sorted(os.listdir(out_dir))}")
        check(min(snrs.values()) > 60.0, f"cli sonify: _ref round trip "
              f"against the padded input {snrs} dB (bar 60)")
        print(f"cli: sonify {len(bach10)} x {CLI_TRACK_SECS:.0f}-s Bach10 "
              f"mixtures; _ref against the padded input "
              + ", ".join(f"{k} {v:.2f} dB" for k, v in snrs.items())
              + f" (> 60); launches {son_launches} (K1 bf16 for _scr, "
              "split-TF32 for _rec)")
    phase_s = time.perf_counter() - t_phase
    print(f"cli: phase {phase_s:.1f} s")
    numbers = {"train": {k: v for k, v in train.items()
                         if k != "best_results"},
               "train_launches": launches,
               "trainer_step_ms_phase_3f": trainer_numbers["trainer_step_ms"],
               "flax_step_ms": flax_s * 1e3, "flax_peak_bytes": flax_peak,
               "evaluate_tracks": n_tracks,
               "evaluate_launches": eval_launches,
               "evaluate_results": printed, "evaluate_card_vs_cpu": gaps,
               "evaluate_cpu_s": cpu_wall,
               "sonify_launches": son_launches, "sonify_ref_snr_db": snrs,
               "phase_s": phase_s}
    return numbers, {"train": launches, "evaluate": eval_launches,
                     "sonify": son_launches}


# The parallel phase (3h): the recipe's 8 crops as 4 MPE + 4 audio-only,
# 2 + 2 on each of two gloo ranks that share the one card.
PAR_MPE, PAR_AUDIO, PAR_RANKS = 4, 4, 2
# Seconds a rank waits for the others, and the phase for its ranks.
PAR_JOIN_S, PAR_WAIT_S = 300, 600


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_rows(plan, audio, gt):
    """A rank's part of the [MPE | audio-only] batch under ``plan``."""
    return (np.concatenate([audio[:PAR_MPE][plan.mpe_rows],
                            audio[PAR_MPE:][plan.audio_rows]]),
            gt[plan.mpe_rows])


def sharded_step_run(torch, model, weights, backend, mesh, audio, gt, mpe):
    """One counted step of ``shard_train_step`` from ``weights`` on
    ``mesh``, then a second one timed part by part. Returns (metrics as
    floats, gradients, launches of the first step, step ms, all-reduce
    ms)."""
    import torch.distributed as dist

    from timbre_trap_tpu_torch.device import ieee_convs
    from timbre_trap_tpu_torch.train import (TrainConfig, init_train_state,
                                             make_train_step,
                                             shard_train_step)

    cfg = TrainConfig()
    model.load_state_dict(weights)
    step = shard_train_step(make_train_step(
        model, cfg, mpe, conv_backend=backend, compact_audio_grid=True), mesh)
    state = init_train_state(model, cfg)
    with counting() as launches:
        metrics = {k: float(v) for k, v in step(state, audio, gt,
                                                 TRAIN_LR).items()}
    grads = {n: p.grad.clone() for n, p in model.net.named_parameters()}
    upload, loss_fn, reduce, update = step.parts
    dist.barrier(group=mesh.get_group())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ieee_convs(model.device):
        total, m = loss_fn(*upload(audio, gt))
        total.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = reduce(m)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    update(state, m, TRAIN_LR)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return metrics, grads, launches, (t3 - t0) * 1e3, (t2 - t1) * 1e3


def counted_trainer_run(root, corpus, n_devices=None):
    """One epoch of :func:`make_trainer` (2 steps, a checkpoint and a sweep
    of the validation set), counted. Returns (trainer, best results,
    launches)."""
    trainer, _ = make_trainer(root, *corpus, seed=9, max_epochs=1,
                              n_devices=n_devices)
    with counting() as launches:
        _, results = trainer.run()
    return trainer, results, launches


def check_trainers_equal(torch, dp, dp_results, one, one_results, what):
    """The data-parallel Trainer ``dp`` against the single-device ``one``
    after the same run: parameters and Adam's moments bit for bit, the
    same logs, sweep results and decisions."""
    same = all(torch.equal(dp.params[n], p) for n, p in one.params.items())
    same_mu = all(torch.equal(dp.opt_state[m][n], one.opt_state[m][n])
                  for m in ("mu", "nu") for n in one.opt_state[m])
    state = [(t.batch_count, t.best_checkpoint, t.n_ckpt_elapsed,
              t.plateau.scale, t.plateau.best, t.plateau.num_bad)
             for t in (dp, one)]
    # (as JSON, where a NaN equals a NaN)
    logs = [json.dumps([r, t.writer.scalars], sort_keys=True, default=float)
            for r, t in ((dp_results, dp), (one_results, one))]
    first_diff = next(((a, b) for a, b in zip(dp.writer.scalars,
                                              one.writer.scalars)
                       if a != b), None)
    check(same and same_mu and state[0] == state[1] and logs[0] == logs[1],
          f"{what}: the data-parallel Trainer differs from the "
          f"single-device one (parameters equal {same}, Adam moments equal "
          f"{same_mu}, state {state}, results {dp_results} vs "
          f"{one_results}, first logs that differ {first_diff} of "
          f"{len(dp.writer.scalars)} and {len(one.writer.scalars)})")


def counted_sharded_inference(torch, model, mesh, audio):
    """``make_sharded_chunked_inference`` of ``audio`` (transcribe), a
    first run that captures the chunk groups' graphs, a second counted and
    a third timed. Returns (coefficients, launches, wall s)."""
    from timbre_trap_tpu_torch.parallel import make_sharded_chunked_inference

    run = make_sharded_chunked_inference(model, mesh, transcribe=True)
    run(audio)
    with counting() as launches:
        out = run(audio)
    t0 = time.perf_counter()
    run(audio)
    torch.cuda.synchronize()
    return out, launches, time.perf_counter() - t0


def rank_main(rank, world, port, workdir):
    """One of phase 3h's gloo ranks on the card (``chip_smoke.py
    --parallel-rank RANK WORLD PORT WORKDIR``): the sharded recipe step in
    float32 and bf16 on its 2 + 2 rows, counted, and its share of the
    sharded transcription of the 100-s clip, counted and held against
    ``chunked_inference`` on rank 0. Writes ``rank{r}.json`` and
    ``rank{r}.pt`` (gradients) under ``workdir``."""
    import datetime

    import torch
    import torch.distributed as dist

    from timbre_trap_tpu_torch import parallel
    from timbre_trap_tpu_torch.models import TimbreTrap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(parallel.initialize(f"127.0.0.1:{port}", world, rank,
                              timeout=datetime.timedelta(seconds=PAR_JOIN_S),
                              backend="gloo"),
          f"rank {rank}: initialize did not form the group")
    mesh = parallel.make_mesh(world)
    check(dist.get_backend() == "gloo" and mesh.size() == world,
          f"rank {rank}: {dist.get_backend()} group of {mesh.size()}")
    plan = parallel.plan_local_rows(PAR_MPE, PAR_AUDIO)
    batch = np.load(f"{workdir}/batch.npz")
    audio, gt = local_rows(plan, batch["audio"], batch["gt"])
    weights = torch.load(f"{workdir}/weights.pt", map_location="cuda")
    model = flagship(TimbreTrap, seed=1)
    out, grads = {"rank": rank, "rows": plan.mpe_rows}, {}
    for backend in ("pallas", "pallas_bf16"):
        metrics, g, launches, step_ms, reduce_ms = sharded_step_run(
            torch, model, weights, backend, mesh, audio, gt,
            len(plan.gt_pos))
        grads[backend] = {n: v.cpu() for n, v in g.items()}
        out[backend] = {"metrics": metrics, "launches": launches,
                        "step_ms": step_ms, "allreduce_ms": reduce_ms}
    model.load_state_dict(weights)
    clip = chord(CLIP_SECS, SR)
    coeffs, launches, wall = counted_sharded_inference(
        torch, model, mesh, clip)
    first = coeffs.clone()
    dist.broadcast(first, src=0, group=mesh.get_group())
    check(torch.equal(coeffs, first),
          f"rank {rank}: its coefficients differ from rank 0's")
    out["inference"] = {"launches": launches, "wall_s": wall,
                        "shape": list(coeffs.shape)}
    if rank == 0:
        err, scale = rel_err(coeffs, model.chunked_inference(clip, True))
        out["inference"].update(max_abs_err=err, max_abs_ref=scale)
    torch.save(grads, f"{workdir}/rank{rank}.pt")
    with open(f"{workdir}/rank{rank}.json", "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


def phase_parallel(torch, card, cli):
    """Phase 3h: ``remat`` on the ``"flax"`` recipe step beside 3g's
    unrematted one; an NCCL group of one rank on the card (the sharded
    ``"pallas_bf16"`` step and the sharded transcription of the 100-s clip
    equal to the plain ones, bit for bit); two gloo ranks sharing the card
    (the sharded step in float32 and bf16 against one rank's, the sharded
    transcription against ``chunked_inference``, the ranks' launches
    against one rank's). Returns (numbers, launches)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from timbre_trap_tpu_torch import parallel
    from timbre_trap_tpu_torch.models import TimbreTrap
    from timbre_trap_tpu_torch.train import (TrainConfig,
                                             reference_recipe_step_time,
                                             step_gradients_reference,
                                             synthetic_batch)

    t_phase = time.perf_counter()
    numbers, launches = {}, {}

    # (1) remat: the "flax" recipe step with its cells recomputed, against
    # the step without (3g timed that one), from the same weights.
    model = flagship(TimbreTrap, seed=2)
    audio, gt = synthetic_batch(model, TRAIN_CROPS, TRAIN_SECS, seed=7)
    w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    plain = one_step(torch, model, w0, "flax", audio, gt, TRAIN_LR)
    del model
    torch.cuda.empty_cache()
    rmodel = flagship(TimbreTrap, seed=2, remat=True)
    remat = one_step(torch, rmodel, w0, "flax", audio, gt, TRAIN_LR)
    gap = check_kernel_step("remat flax step", remat, plain,
                            pair="remat vs no remat")
    del plain, remat
    torch.cuda.empty_cache()
    remat_s, _, remat_peak = reference_recipe_step_time(
        rmodel, conv_backend="flax", iters=1, return_memory=True)
    del rmodel
    torch.cuda.empty_cache()
    numbers["remat"] = {"flax_step_ms": remat_s * 1e3,
                        "flax_peak_bytes": remat_peak, **gap,
                        "no_remat_step_ms": cli["flax_step_ms"],
                        "no_remat_peak_bytes": cli["flax_peak_bytes"]}
    print(f"parallel: the \"flax\" recipe step with remat "
          f"{remat_s * 1e3:.1f} ms, peak {remat_peak / 2**30:.2f} GiB, "
          f"beside 3g's without {cli['flax_step_ms']:.1f} ms, "
          f"{cli['flax_peak_bytes'] / 2**30:.2f} GiB; on {card}")

    # The batch of the sharded steps: the recipe's 8 crops, 4 annotated.
    model = flagship(TimbreTrap, seed=1)
    audio, gt = synthetic_batch(model, TRAIN_CROPS, TRAIN_SECS, seed=8)
    gt = gt[:PAR_MPE]
    w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    clip = chord(CLIP_SECS, SR)

    # The single-device Trainer of (2)'s data-parallel one: one epoch (2
    # steps, a checkpoint and a sweep) on a corpus like phase 3f's.
    corpus_dir = tempfile.TemporaryDirectory()
    corpus = (write_corpus(f"{corpus_dir.name}/train", TRAINER_TRACKS,
                           TRAINER_TRACK_SECS, SR, seed=11),
              write_corpus(f"{corpus_dir.name}/val", 1, VAL_SECS, SR,
                           seed=12))
    one, one_results, one_launches = counted_trainer_run(
        f"{corpus_dir.name}/one", corpus)

    # (2) An NCCL group of one rank on cuda:0: the all-reduce and the
    # division by 1 are exact, so the sharded step, the sharded
    # transcription and the data-parallel Trainer equal the plain ones bit
    # for bit.
    check(parallel.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                              timeout=datetime.timedelta(
                                  seconds=PAR_JOIN_S)),
          "initialize did not form the one-rank group")
    check(dist.get_backend() == "nccl", f"the group on the card is "
          f"{dist.get_backend()}, not NCCL")
    mesh = parallel.make_mesh(1)
    m1, g1, l1, step1_ms, reduce1_ms = sharded_step_run(
        torch, model, w0, "pallas_bf16", mesh, audio, gt, PAR_MPE)
    m0, g0 = one_step(torch, model, w0, "pallas_bf16", audio, gt, TRAIN_LR,
                      mpe=PAR_MPE)
    check(m1 == m0 and all(torch.equal(g1[n], g) for n, g in g0.items()),
          "NCCL, one rank: the sharded bf16 step differs from the plain "
          "step")
    check(all(l1[fn] == n for fn, n in RECIPE_STEP_LAUNCHES.items()),
          f"NCCL, one rank: the sharded step launched {l1}")
    del g0, g1
    model.load_state_dict(w0)
    coeffs, l_inf1, inf1_s = counted_sharded_inference(torch, model, mesh,
                                                       clip)
    with counting() as l_chunked:
        ref = model.chunked_inference(clip, True)
    check(torch.equal(coeffs, ref), f"NCCL, one rank: the sharded "
          f"transcription differs from chunked_inference by "
          f"{rel_err(coeffs, ref)[0]}")
    check(l_inf1[K1] == l_chunked[K1] > 0,
          f"NCCL, one rank: K1 {l_inf1} against chunked_inference's "
          f"{l_chunked}")
    del coeffs
    # The Trainer with n_devices=1 in the group: the sharded step, rank
    # 0's sweep broadcast over NCCL to the group, the chief's writes.
    dp, dp_results, dp_launches = counted_trainer_run(
        f"{corpus_dir.name}/dp", corpus, n_devices=1)
    check(dp.mesh is not None and dp._steps
          and all(len(st.parts) == 4 for st in dp._steps.values()),
          "NCCL, one rank: the Trainer did not run the sharded step")
    check(dp_launches == one_launches and dp_launches[K2] == 1
          and all(dp_launches[k] > 0 for k in RECIPE_STEP_LAUNCHES),
          f"NCCL, one rank: the Trainer launched {dp_launches}, the "
          f"single-device one {one_launches}")
    check_trainers_equal(torch, dp, dp_results, one, one_results,
                         "NCCL, one rank")
    for path in ("config.json", "run.json", "metrics.json",
                 "models/model-2/checkpoint.pt", "models/hparams.json"):
        check(os.path.isfile(f"{corpus_dir.name}/dp/{path}"),
              f"NCCL, one rank: the chief did not write {path}")
    dist.destroy_process_group()
    del dp, one
    corpus_dir.cleanup()
    torch.cuda.empty_cache()
    launches["nccl_1rank"] = {"step": l1, "inference": l_inf1,
                              "trainer": dp_launches}
    numbers["nccl_1rank"] = {"step_ms": step1_ms, "allreduce_ms": reduce1_ms,
                             "inference_s": inf1_s}
    print(f"parallel: NCCL, one rank: the sharded pallas_bf16 step equals "
          f"the plain step bit for bit ({step1_ms:.1f} ms, all-reduce "
          f"{reduce1_ms:.3f} ms), launches {l1}; the sharded transcription "
          f"of the {CLIP_SECS:.0f}-s clip equals chunked_inference bit for "
          f"bit, K1 {l_inf1[K1]}; the Trainer (n_devices=1, 2 steps and a "
          f"sweep) equals the single-device Trainer bit for bit, launches "
          f"{dp_launches}; on {card}")

    # (3) Two gloo ranks on the one card (NCCL takes one rank a card). The
    # single-rank references first, then the ranks.
    refs = {b: one_step(torch, model, w0, b, audio, gt, TRAIN_LR,
                        mpe=PAR_MPE) for b in ("pallas", "pallas_bf16")}
    per_forward = sum(1 for _ in model._spec(True).convs())

    def ref64():
        m64 = flagship(TimbreTrap, seed=1, remat=True)
        m64.load_state_dict(w0)
        return step_gradients_reference(m64, TrainConfig(), PAR_MPE, audio,
                                        gt, compact_audio_grid=True)

    ref = ref.cpu()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        torch.save({k: v.cpu() for k, v in w0.items()}, f"{work}/weights.pt")
        np.savez(f"{work}/batch.npz", audio=audio, gt=gt)
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), str(PAR_RANKS), str(port), work],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(PAR_RANKS)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=PAR_WAIT_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
        ranks_s = time.perf_counter() - t0
        for r, (proc, out) in enumerate(zip(procs, outs)):
            check(proc.returncode == 0, f"gloo rank {r} failed "
                  f"(rc {proc.returncode}):\n{out[-4000:]}")
        ranks = []
        for r in range(PAR_RANKS):
            with open(f"{work}/rank{r}.json") as fh:
                ranks.append(json.load(fh))
            ranks[-1]["grads"] = torch.load(f"{work}/rank{r}.pt")
    for backend in ("pallas", "pallas_bf16"):
        g_r = [{n: v.cuda() for n, v in r["grads"][backend].items()}
               for r in ranks]
        check(all(torch.equal(g_r[0][n], g) for n, g in g_r[1].items())
              and ranks[0][backend]["metrics"]
              == ranks[1][backend]["metrics"],
              f"gloo: the two ranks' {backend} steps differ")
        got = (ranks[0][backend]["metrics"], g_r[0])
        want = (RECIPE_STEP_LAUNCHES if backend == "pallas_bf16"
                else RECIPE_STEP_LAUNCHES_F32)
        for r in ranks:
            check(all(r[backend]["launches"][k] == n
                      for k, n in want.items()),
                  f"gloo rank {r['rank']}: the {backend} step launched "
                  f"{r[backend]['launches']}")
        if backend == "pallas":
            numbers["gloo_f32"] = check_kernel_step(
                "2 gloo ranks, float32", got, refs[backend],
                ref64=ref64, pair="vs one rank")
        else:
            (mb, gb), (ms, gs) = got, refs[backend]
            d = abs(mb["loss/total"] - ms["loss/total"]) / abs(
                ms["loss/total"])
            l2 = grad_l2_rel(gb, gs)
            check(d <= 2e-2 and l2 <= 5e-2, f"gloo: the bf16 step off one "
                  f"rank's by {d} (loss), {l2} (gradient L2)")
            numbers["gloo_bf16"] = {"loss_rel": d, "grad_l2_rel": l2}
            print(f"parallel: 2 gloo ranks, bf16, vs one rank: loss rel "
                  f"{d:.2e}, gradient L2 rel {l2:.2e}")
    del g_r, got
    inf = [r["inference"] for r in ranks]
    total = sum(i["launches"][K1] for i in inf)
    check(l_chunked[K1] <= total <= l_chunked[K1]
          + (PAR_RANKS - 1) * per_forward,
          f"gloo: the ranks' K1 launches {[i['launches'] for i in inf]} "
          f"against one rank's {l_chunked}")
    err, scale = inf[0]["max_abs_err"], inf[0]["max_abs_ref"]
    check(err <= 2e-5 * scale, f"gloo: the sharded transcription off "
          f"chunked_inference by {err} (max|ref| {scale})")
    launches["gloo_ranks"] = [{"step_f32": r["pallas"]["launches"],
                               "step_bf16": r["pallas_bf16"]["launches"],
                               "inference": r["inference"]["launches"]}
                              for r in ranks]
    numbers["gloo_ranks"] = {
        "ranks": PAR_RANKS, "wall_s": ranks_s,
        "step_ms_f32": [r["pallas"]["step_ms"] for r in ranks],
        "allreduce_ms_f32": [r["pallas"]["allreduce_ms"] for r in ranks],
        "step_ms_bf16": [r["pallas_bf16"]["step_ms"] for r in ranks],
        "allreduce_ms_bf16": [r["pallas_bf16"]["allreduce_ms"]
                              for r in ranks],
        "inference_s": [i["wall_s"] for i in inf],
        "inference_max_abs_err": err, "inference_max_abs_ref": scale,
        "k1_single_rank": l_chunked[K1]}
    print(f"parallel: 2 gloo ranks sharing the card (no scaling numbers): "
          f"step ms f32 {numbers['gloo_ranks']['step_ms_f32']}, bf16 "
          f"{numbers['gloo_ranks']['step_ms_bf16']}; gradient all-reduce "
          f"ms f32 {numbers['gloo_ranks']['allreduce_ms_f32']}, bf16 "
          f"{numbers['gloo_ranks']['allreduce_ms_bf16']}; transcription K1 "
          f"{[i['launches'][K1] for i in inf]} against one "
          f"rank's {l_chunked[K1]}, max abs err {err:.3e} "
          f"(max|ref| {scale:.3e}); ranks' wall {ranks_s:.1f} s; on {card}")
    phase_s = time.perf_counter() - t_phase
    numbers["phase_s"] = phase_s
    print(f"parallel: phase {phase_s:.1f} s")
    return numbers, launches


# The last modules' phase (3i): interop both ways, the parity, comparison
# and latents entry points, the quality probe and the profiler, on the
# corpora of phase 3g. The probe runs bench.py's frozen configurations
# (``eval.quality.BENCH_PROBES``) on bench.py's model, the JAX package's
# seed-0 flagship weights (``models.flax_init``), so its F1 compares with
# the JAX package's at the same start; F1 >= QUALITY_F1_BAR each.
QUALITY_F1_BAR = 0.9
# Kernels of one probe step: the consistency-on step runs the recipe
# step's objectives (2 encodes, 4 decodes); the consistency-off step runs
# one encode and two decodes, half the level applications: K1 and dW
# 348 / 2 and 174 / 2, the ELU' seeds 24 / 2, dX one less than dW (the
# features take no gradient).
PROBE_STEP_LAUNCHES = {
    "consistency_on": RECIPE_STEP_LAUNCHES,
    "consistency_off": {K1: 174, DX: 86, DW: 87, DW_REDUCE: 87, SEED: 12}}


def write_bach10_stems(bach10_dir, seed):
    """Four instrument stems beside each Bach10 mixture of
    ``write_cli_corpora`` (a 12-s tone of its own pitch each), for the
    stems wrapper (``SoloMultiPitch.Bach10``)."""
    from timbre_trap_tpu_torch.data.datasets.SoloMultiPitch import Bach10
    from timbre_trap_tpu_torch.data.io import save_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(CLI_TRACK_SECS * SR)) / SR
    for track in sorted(os.listdir(bach10_dir)):
        for ins in Bach10.INSTRUMENTS:
            f = 110.0 * 2 ** (rng.integers(0, 36) / 12)
            save_wav(f"{bach10_dir}/{track}/{track}-{ins}.wav",
                     (0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32),
                     SR)


def capturing(module, name, keep=None):
    """Within the block, ``module.<name>`` (a model constructor or loader)
    records every model it returns (or ``keep(model)``) in the yielded
    list."""
    @contextlib.contextmanager
    def block():
        held, real = [], getattr(module, name)

        def build(*args, **kwargs):
            built = real(*args, **kwargs)
            held.append(built if keep is None else keep(built))
            return built

        setattr(module, name, build)
        try:
            yield held
        finally:
            setattr(module, name, real)
    return block()


def quiet_call(fn, *args):
    """``fn(*args)`` with its stdout kept and echoed; returns (result,
    stdout, wall s)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    wall = time.perf_counter() - t0
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue(), wall


def phase_last_modules(torch, model, card):
    """The last modules on the card (phase 3i), on the flagship ``model``
    (seeded weights): interop round trips, the parity CLI, the comparison
    CLI, the two quality probes of ``bench.py``, the latents of the Bach10
    stems and a profiled ``transcribe``. Returns (numbers, launches)."""
    import tempfile

    from timbre_trap_tpu_torch.data import download
    from timbre_trap_tpu_torch.data.datasets.SoloMultiPitch import \
        Bach10 as Bach10Stems
    from timbre_trap_tpu_torch.eval import quality_f1
    from timbre_trap_tpu_torch.eval.quality import BENCH_PROBES
    from timbre_trap_tpu_torch.experiments import comparison, parity
    from timbre_trap_tpu_torch.experiments.evaluate import evaluation_set
    from timbre_trap_tpu_torch.experiments import latents as latents_cli
    from timbre_trap_tpu_torch.experiments.latents import collect_latents
    from timbre_trap_tpu_torch.interop import (_flatten,
                                               export_torch_state_dict,
                                               hwio_params,
                                               import_torch_state_dict,
                                               load_torch_checkpoint)
    from timbre_trap_tpu_torch.models import TimbreTrap
    from timbre_trap_tpu_torch.models.flax_init import jax_package_params
    from timbre_trap_tpu_torch.utils.profiling import Timer, annotate, trace

    t_phase = time.perf_counter()
    numbers, launches = {}, {}
    per_forward = sum(1 for _ in model._spec(True).convs())
    clip = chord(9.0, SR, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_cli_corpora(f"{tmp}/corpora", seed=21)
        write_bach10_stems(dirs["Bach10"], seed=22)
        n_bach10 = len(os.listdir(dirs["Bach10"]))

        # (1) Interop: the flagship weights out to a reference state_dict
        # and back, bit for bit; both kinds of torch save through
        # load_torch_checkpoint into a fresh card model, whose transcribe
        # equals the original's bit for bit.
        params = {k: v.detach().cpu().numpy()
                  for k, v in _flatten(hwio_params(model.net)).items()}
        exported = export_torch_state_dict(hwio_params(model.net))
        back = _flatten(import_torch_state_dict(exported,
                                                hwio_params(model.net)))
        check(set(back) == set(params) and all(
            np.array_equal(back[k], v) and back[k].dtype == v.dtype
            for k, v in params.items()),
            "interop: export -> import does not give the weights back")
        want_acts = model.transcribe(clip)
        bare, whole = f"{tmp}/bare.pt", f"{tmp}/whole.pt"
        torch.save({k: torch.from_numpy(np.array(v))
                    for k, v in exported.items()}, bare)
        torch.save(model.net, whole)
        for path in (bare, whole):
            fresh = flagship(TimbreTrap, seed=9)
            n = parity.load_checkpoint_into(fresh, path)
            check(n == len(model.net.state_dict()), f"interop: {path} "
                  f"gave {n} tensors")
            check(all(torch.equal(fresh.net.state_dict()[k], v) for k, v in
                      model.net.state_dict().items()), f"interop: "
                  f"{os.path.basename(path)} loads other weights")
            check(torch.equal(fresh.transcribe(clip), want_acts),
                  f"interop: transcribe after loading "
                  f"{os.path.basename(path)} differs from the original's")
            del fresh
        print(f"interop: {len(params)} tensors export -> import bit for "
              f"bit; a bare state_dict save and a whole-module save load "
              f"into a fresh card model whose 9-s transcribe equals the "
              f"original's bit for bit")
        numbers["interop_tensors"] = len(params)

        # (2) The parity CLI on the card: the flagship weights exported
        # without ``like`` (no ``.0`` segments, as the JAX package's test
        # writes them), the synthetic Bach10, the compat frame; counted.
        ckpt = f"{tmp}/tt-flagship.pt"
        torch.save({k: torch.from_numpy(np.array(v))
                    for k, v in exported.items()}, ckpt)
        out_json = f"{tmp}/parity.json"
        argv = ["--checkpoint", ckpt, "--datasets", "Bach10", "--base-dirs",
                dirs["Bach10"], "--out", out_json]
        with counting() as launches["parity"]:
            table, _, _ = quiet_call(parity.main, argv)
        n = launches["parity"]
        check(n[K2] == n_bach10 and n[K1] == n[K1_F32] == 0,
              f"parity: K2 launched {n[K2]} times over {n_bach10} tracks, K1 "
              f"{n[K1] + n[K1_F32]} (evaluate runs the NCHW net: 0)")
        with open(out_json) as fh:
            written = json.load(fh)
        check(written["compat"] == "cqt_pytorch"
              and written["results"] == table
              and all(np.isfinite(v) for v in table["Bach10"].values()),
              f"parity: results {table}, written {written}")
        # A small model's weights through the CLI on the card and on the
        # CPU, held to evaluate's card-vs-CPU bars.
        small_ckpt = f"{tmp}/tt-small.pt"
        torch.save({k: v.cpu() for k, v in
                    TimbreTrap(**SMALL, seed=3).net.state_dict().items()},
                   small_ckpt)
        small_argv = ["--checkpoint", small_ckpt, "--datasets", "Bach10",
                      "--base-dirs", dirs["Bach10"], "--sample-rate",
                      str(SMALL["sample_rate"]), "--n-octaves",
                      str(SMALL["n_octaves"]), "--bins-per-octave",
                      str(SMALL["bins_per_octave"]), "--secs-per-block",
                      str(SMALL["secs_per_block"]), "--latent-size",
                      str(SMALL["latent_size"]), "--model-complexity",
                      str(SMALL["model_complexity"])]
        with capturing(parity, "TimbreTrap") as built:
            got, _, _ = quiet_call(parity.main, small_argv)
            want, _, _ = quiet_call(parity.main, small_argv
                                    + ["--device", "cpu"])
        card_model, cpu_model = built
        ds = evaluation_set("Bach10", dirs["Bach10"], SMALL["sample_rate"],
                            cpu_model.sliCQ)
        numbers["parity_small_card_vs_cpu"] = hold_card_to_cpu(
            torch, card_model, cpu_model, ds, got["Bach10"], want["Bach10"],
            "parity: small model card vs CPU (compat frame)")
        del card_model, cpu_model, built
        numbers.update(parity_results=table["Bach10"])
        print(f"parity: flagship weights (exported without .0 names) on the "
              f"compat frame over {n_bach10} x {CLI_TRACK_SECS:.0f}-s Bach10 "
              f"mixtures; launches {launches['parity']}")

        # (3) The comparison CLI on the saved flagship model, counted: the
        # lin-CQT, log-CQT and Timbre-Trap rows; then the external flags,
        # which skip (the download patched to refuse, so no network).
        saved = model.save(f"{tmp}/flagship")
        argv = ["--checkpoint", saved, "--bach10-dir", dirs["Bach10"]]
        with counting() as launches["comparison"], capturing(
                comparison, "load_model", count_forwards) as counted:
            table, text, _ = quiet_call(comparison.main, argv)
        forwards = counted[0].n
        n = launches["comparison"]
        check(forwards > 0 and n[K1] == per_forward * forwards
              and n[K1_F32] == 0 and n[K2] == 0,
              f"comparison: {forwards} forwards of the Timbre-Trap estimator"
              f" launched {n} (bf16 K1 {per_forward} a forward, no K2)")
        rows = ("lin-CQT", "log-CQT", "timbre-trap")
        check(list(table.get("Bach10", {})) == list(rows)
              and all(f"[Bach10/{r}]" in text for r in rows),
              f"comparison: rows {table}")
        check(all(np.isfinite(v) for r in table["Bach10"].values()
                  for v in r.values()), f"comparison: results {table}")
        numbers.update(comparison_results=table["Bach10"])
        real_download = download.stream_url_resource

        def refuse(url, *args, **kwargs):
            raise OSError(f"no network here ({url})")

        download.stream_url_resource = refuse
        try:
            skipped, text, _ = quiet_call(comparison.main, [
                "--bach10-dir", dirs["Bach10"], "--basic-pitch",
                "--deep-salience"])
        finally:
            download.stream_url_resource = real_download
        check("[basic-pitch] SKIPPED:" in text
              and "[deep-salience] SKIPPED:" in text
              and list(skipped["Bach10"]) == ["lin-CQT", "log-CQT"],
              f"comparison: the external flags did not skip cleanly: {text}")
        print(f"comparison: {', '.join(rows)} on {n_bach10} Bach10 "
              f"mixtures, {forwards} forwards, "
              f"launches {launches['comparison']}; the external flags "
              f"print SKIP")

        # (4) The quality probe at bench.py's frozen configurations on
        # bench.py's model (the JAX package's seed-0 flagship weights),
        # counted: the steps' K1 and K3, one transcribe (K1) and one peak
        # mask (K2) a probe.
        numbers["quality"] = {}
        launches["quality"] = {}
        bench_model = flagship(TimbreTrap, seed=0)
        bench_model.load_jax_params(jax_package_params(
            hwio_params(bench_model.net), seed=0))
        for name, kw in BENCH_PROBES.items():
            forwards = count_forwards(bench_model)
            with counting() as n:
                f1 = quality_f1(bench_model, **kw)
            forwards.restore()
            launches["quality"][name] = n
            steps = kw["steps"]
            per_step = PROBE_STEP_LAUNCHES[name]
            want = {k: steps * v for k, v in per_step.items()}
            want[K1] += per_forward * forwards.n
            check(bf16_only(n) and all(n[k] == v for k, v in want.items()),
                  f"quality {name}: launched {n}, not {want} ({steps} steps "
                  f"of {per_step} and {forwards.n} forwards of "
                  f"{per_forward} K1 stages) on bf16 kernels")
            check(n[K2] == 1, f"quality {name}: K2 launched {n[K2]} times")
            print(f"quality: {name} {kw}: mpe/f1-score {f1:.5f}; launches "
                  f"{n}")
            check(np.isfinite(f1) and f1 >= QUALITY_F1_BAR,
                  f"quality {name}: F1 {f1} below {QUALITY_F1_BAR}")
            numbers["quality"][name] = {"f1": f1,
                                        "launches_per_step": per_step}
        del bench_model
        torch.cuda.empty_cache()

        # (5) The latents of the Bach10 stems on the card, and a small
        # model's on the card against the CPU.
        stems = Bach10Stems(base_dir=dirs["Bach10"], splits=None,
                            sample_rate=SR, cqt=model.sliCQ)
        t0 = time.perf_counter()
        (z, labels), _, _ = quiet_call(collect_latents, model, stems)
        latents_s = time.perf_counter() - t0
        check(z.shape == (len(stems), LATENT) and np.isfinite(z).all()
              and labels == Bach10Stems.INSTRUMENTS * n_bach10,
              f"latents: {z.shape}, labels {labels}")
        small_card = TimbreTrap(**SMALL, seed=4)
        small_cpu = TimbreTrap(**SMALL, seed=4, device="cpu")

        def small_latents(m):
            ds = Bach10Stems(base_dir=dirs["Bach10"], splits=None,
                             sample_rate=SMALL["sample_rate"], cqt=m.sliCQ)
            return quiet_call(collect_latents, m, ds)[0][0]

        got, want = small_latents(small_card), small_latents(small_cpu)
        gap = float(np.abs(got - want).max() / np.abs(want).max())
        check(gap <= 1e-4, f"latents: small model card vs CPU {gap} "
              "x max|ref| (bar 1e-4)")
        try:
            import matplotlib  # noqa: F401
            import sklearn  # noqa: F401
        except ImportError:
            plotting = ("matplotlib or scikit-learn is absent here, so "
                        "plot_latents (the CLI's last step) is not run")
        else:
            pdf, _, _ = quiet_call(latents_cli.main, [
                "--checkpoint", saved, "--bach10-dir", dirs["Bach10"],
                "--output", f"{tmp}/latents.pdf", "--sample-rate", str(SR)])
            check(os.path.getsize(pdf) > 1000, "latents: the PDF is empty")
            plotting = "the latents CLI wrote its t-SNE PDF"
        print(f"latents: {len(stems)} stems of {n_bach10} Bach10 pieces "
              f"encoded on the card in {latents_s:.3f} s, ({len(stems)}, "
              f"{LATENT}) finite; small model card vs CPU {gap:.2e} x "
              f"max|ref| (bar 1e-4); {plotting}")
        numbers.update(latents_s=latents_s, latents_card_vs_cpu=gap)

        # (6) The profiler around one card transcribe: the trace names the
        # band kernel and the annotation.
        timer = Timer()
        with trace(f"{tmp}/trace") as prof:
            with timer("transcribe"), annotate("transcribe"):
                model.transcribe(clip)
                torch.cuda.synchronize()
        (trace_file,) = os.listdir(f"{tmp}/trace")
        with open(f"{tmp}/trace/{trace_file}") as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
        band = sorted(n for n in names if "band_wgmma_kernel" in n)
        check(band and "transcribe" in names, f"profiling: the trace names "
              f"no band kernel or no 'transcribe' range ({len(names)} names)")
        device_ms = sum(getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0.0)
                        for e in prof.key_averages()
                        if "band_wgmma_kernel" in e.key) / 1e3
        print(f"profiling: the trace of one 9-s transcribe holds "
              f"{len(names)} event names, the annotation 'transcribe' and "
              f"{band[0][:60]}...; band kernels' device time "
              f"{device_ms:.3f} ms; Timer {timer.summary()}")
        numbers.update(trace_band_kernel_ms=device_ms,
                       timer=timer.summary())
    phase_s = time.perf_counter() - t_phase
    numbers["phase_s"] = phase_s
    print(f"last modules: phase {phase_s:.1f} s")
    return numbers, launches


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from timbre_trap_tpu_torch.models import TimbreTrap
        from timbre_trap_tpu_torch.models.modules import TimbreTrapNet
        from timbre_trap_tpu_torch.ops import _build
        from timbre_trap_tpu_torch.interop import hwio_params
        from timbre_trap_tpu_torch.models.fused import level_specs
        from timbre_trap_tpu_torch.ops.fused_level import (
            _apply_chain, band_flops, band_tma_plan_f32, chain_flops,
            fused_level_apply, packed_level_apply)
        from timbre_trap_tpu_torch.ops.packed_conv import pack_nhwc
        from timbre_trap_tpu_torch.ops.peaks import (peak_mask,
                                                     peak_mask_reference)
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # Wall seconds of each phase (a phase runs until the next lap).
    phase_s, clock = {}, [time.perf_counter(), None]

    def lap(name):
        now = time.perf_counter()
        if clock[1] is not None:
            phase_s[clock[1]] = now - clock[0]
        clock[:] = [now, name]

    lap('build')
    # 1. build
    sass = phase_build(_build)

    lap('parity')
    # 2. parity at the flagship shapes, on real features of the clip
    model = flagship(TimbreTrap, seed=0)
    L = model.sliCQ.block_length
    audio = chord(CLIP_SECS, SR)
    hop = L // 2
    chunks = np.stack([audio[0, :, i * hop:i * hop + L] for i in range(4)])
    F, M = model.sliCQ.n_bins, model.sliCQ.max_window_length
    feats = model.features_from_audio(torch.from_numpy(chunks).cuda())
    x = pack_nhwc(feats).contiguous()                     # (4, 1080, 1024)
    check(tuple(x.shape) == (4, 2 * F, M), f"chain input {tuple(x.shape)}")
    n_frames = -(-audio.shape[-1] // L) * M
    warm = model.transcribe(audio[..., :L])               # warm-up, one block
    t_par = time.perf_counter()
    k1_err, k2_err = phase_parity(torch, model, x, warm, n_frames)
    train_frames = model.sliCQ.get_expected_frames(int(TRAIN_SECS * SR))
    k3_err = phase_k3_parity(torch, model.net, train_frames)
    with torch.no_grad():
        train_specs = sum(level_specs(hwio_params(model.net), model.net,
                                      True), [])
    stages = variant_stages(torch)
    band_err, band_err32, k3_stage_err = phase_band_parity(
        torch, model._spec(True), train_specs, stages)
    print(f"parity: {time.perf_counter() - t_par:.1f} s")

    lap('f32_accuracy')
    # 2b. the float32 route against float64, next to the IEEE plain version
    f32_acc = phase_f32_accuracy()

    lap('c4')
    # 2c. model complexity 4: its period-2 stages and a counted transcribe
    c4, launches_c4 = phase_c4(torch, audio, card)

    lap('transcribe')
    # 3. the main path: transcribe + peak_mask, counted; a second call timed
    spec = model._spec(True)
    per_forward = sum(1 for _ in spec.convs())
    forwards = count_forwards(model)
    with counting() as launches:
        acts = model.transcribe(audio)
        mask = peak_mask(acts, 0.5)
    forwards.restore()
    check(tuple(acts.shape) == (1, F, n_frames),
          f"activations {tuple(acts.shape)}, expected (1, {F}, {n_frames})")
    check(bool(torch.isfinite(acts).all()), "activations are not finite")
    check(acts.min().item() >= 0.0 and acts.max().item() <= 1.0,
          "activations leave [0, 1]")
    check(mask.dtype == torch.uint8 and mask.shape == acts.shape, "mask shape")
    check(torch.equal(mask, peak_mask_reference(acts, 0.5)),
          "the main path's peak mask differs from its plain version")
    check(launches[K1] == per_forward * forwards.n > 0
          and launches[K1_F32] == 0,
          f"K1's bf16 kernel did not run every stage of the main path's "
          f"{forwards.n} forwards: {launches}")
    check(on_tma_epilogue(launches),
          f"a bf16 K1 stage of the main path took the staged epilogue: "
          f"{launches}")
    check(launches[K2] == 1, f"K2 ran {launches[K2]} times on the main path")
    print(f"main: {CLIP_SECS:.0f} s clip, {forwards.n} forwards, launches "
          f"{launches}, peaks {int(mask.sum())}")
    # The first call at this clip length also pays one-time costs (pinned
    # host buffers, cuFFT plans, allocator growth, graph captures); a
    # second call does not.
    t0 = time.perf_counter()
    peak_mask(model.transcribe(audio), 0.5)
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    rtf_warm = CLIP_SECS / wall_warm

    # 3a. the float32 transcribe, counted: every K1 stage runs the
    # split-TF32 band kernel; a second call timed. Every main path's
    # float32 K1 stage takes the TMA epilogue: the plan picks it where
    # T % 4 == 0, as at the chunks' and the crops' T.
    model.fused = "f32"
    with counting() as launches32:
        acts32 = model.transcribe(audio)
    check(launches32[K1_F32] > 0 and launches32[K1] == 0,
          f"the float32 transcribe's K1 stages did not all run the "
          f"split-TF32 band kernel: {launches32}")
    check(all(band_tma_plan_f32(cb, t).tma_epilogue
              for cb in model._spec(False).convs() for t in (M, train_frames)),
          f"a float32 K1 stage at T = {M} or {train_frames} takes the "
          f"register epilogue")
    print(f"main: float32 transcribe launches {launches32}")
    t0 = time.perf_counter()
    peak_mask(model.transcribe(audio), 0.5)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    rtf32 = CLIP_SECS / wall32
    model.fused = "auto"
    diff = (acts - acts32).abs().max().item()
    print(f"main: bf16 vs f32 activations max abs diff {diff:.3e}")
    check(diff <= 5e-2, f"bf16 activations differ from f32 by {diff}")

    small = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
                 secs_per_block=0.5, latent_size=16, model_complexity=1,
                 fused="f32", seed=1)
    on_card = TimbreTrap(**small)
    on_cpu = TimbreTrap(**small, device="cpu")
    clip = chord(2.3, 8000, seed=1)
    d_small = (on_card.transcribe(clip).cpu() - on_cpu.transcribe(clip)
               ).abs().max().item()
    print(f"main: small model card vs CPU max abs diff {d_small:.3e}")
    check(d_small <= 1e-4, f"card and CPU disagree by {d_small}")

    lap('reconstruct')
    # 3b. reconstruct, counted, and the transform on the card
    transform = phase_transform(torch)
    recon, launches_rec = phase_reconstruct(torch, model, audio, card)

    lap('variants')
    # 3d. the model families, skip connections and persistence, counted
    variants, launches_var = phase_variants(
        torch, audio, torch.from_numpy(chunks).cuda(), card)

    lap('train')
    # 3c. the training main path, counted
    train, train_launches, train_model = phase_train(torch)

    lap('family_train')
    # 3e. every family trains, counted; accumulation and exact resume
    families, family_launches = phase_family_train(torch, card)

    lap('trainer')
    # 3f. the Trainer, fed by the data package, validated by evaluate
    trainer, trainer_launches = phase_trainer(torch, card,
                                              train["train_step_ms"])

    lap('cli')
    # 3g. the train, evaluate and sonify CLIs over the corpus wrappers
    cli, cli_launches = phase_cli(torch, card, trainer)

    lap('parallel')
    # 3h. remat, an NCCL group of one rank, two gloo ranks on the card
    par, par_launches = phase_parallel(torch, card, cli)

    lap('last_modules')
    # 3i. interop, the parity, comparison and latents entry points, the
    # quality probe and the profiler
    last, last_launches = phase_last_modules(torch, model, card)

    lap('numbers')
    # 4. numbers at the main path's shapes
    xb = x.to(torch.bfloat16)
    k1_plain = time_ms(torch, lambda: packed_level_apply(xb, spec,
                                                         torch.bfloat16), 3)
    k1_plain32 = time_ms(torch, lambda: packed_level_apply(x, spec,
                                                           torch.float32), 3)
    rspec = model._spec(False)
    k1_rec_ms = time_ms(torch, lambda: fused_level_apply(x, rspec,
                                                         torch.float32))
    rec_forwards = recon["k1_forwards"]
    recon.update({"k1_forward_ms": k1_rec_ms,
                  "k1_share": rec_forwards * k1_rec_ms / (recon["wall_s"]
                                                          * 1e3),
                  "decode_share": recon["decode_ms"] / (recon["wall_s"]
                                                        * 1e3)})
    print(f"reconstruct: {rec_forwards:.0f} float32 forwards of the "
          f"reconstruction chain at {k1_rec_ms:.3f} ms = "
          f"{100 * recon['k1_share']:.1f} % of the second call's wall; "
          f"synthesis {100 * recon['decode_share']:.1f} %")
    net16 = TimbreTrapNet(F, LATENT, COMPLEXITY).cuda()
    net16.load_state_dict(model.net.state_dict())
    net16 = net16.to(torch.bfloat16).eval()
    nchw = feats.movedim(-1, 1).to(torch.bfloat16).contiguous()
    net32 = TimbreTrapNet(F, LATENT, COMPLEXITY).cuda()
    net32.load_state_dict(model.net.state_dict())
    net32 = net32.eval()
    nchw32 = feats.movedim(-1, 1).float().contiguous()
    # The bf16 forward in turns, in one call: tt_band_conv_wgmma (the
    # route: the TMA epilogue at T = 1024), the same kernel on the staged
    # epilogue (the one it had before the TMA epilogue) and cuDNN; the
    # median of five turns each, and the device time of each chain.
    def staged_chain():
        with staged_epilogue():
            return fused_level_apply(xb, spec, torch.bfloat16)

    chains = {"wgmma": lambda: fused_level_apply(xb, spec, torch.bfloat16),
              "wgmma_staged": staged_chain,
              "cudnn": lambda: net16(nchw, True)}
    turns = {k: [] for k in chains}
    with torch.no_grad():
        for _ in range(5):
            for k, fn in chains.items():
                turns[k].append(time_ms(torch, fn))
        chain_device_ms = {k: device_ms(torch, fn, 5)
                           for k, fn in chains.items()}
        # The float32 forward the same way: tt_band_conv_wgmma_f32 (the
        # route) and cuDNN with TF32 off.
        chains32 = {"wgmma_f32": lambda: fused_level_apply(x, spec,
                                                           torch.float32),
                    "cudnn_f32": lambda: net32(nchw32, True)}
        turns32 = {k: [] for k in chains32}
        for _ in range(5):
            for k, fn in chains32.items():
                turns32[k].append(time_ms(torch, fn))
        chain_device_ms32 = {k: device_ms(torch, fn, 5)
                             for k, fn in chains32.items()}
        # The wrappers' host time a launch, both K1 routes, on the chain at
        # the main path's shapes.
        host_us = {
            "wgmma_bf16": host_us_per_launch(torch, chains["wgmma"],
                                             per_forward),
            "wgmma_f32": host_us_per_launch(torch, chains32["wgmma_f32"],
                                            per_forward)}
    del net16, net32
    k1_ms, k1_staged, k1_lib = (sorted(v)[len(v) // 2]
                                for v in turns.values())
    k1_ms32, k1_lib32 = (sorted(v)[len(v) // 2] for v in turns32.values())
    kind_ms = stage_kind_numbers(torch, spec, x.shape[0], x.shape[-1])
    kind_ms32 = stage_kind_numbers(torch, spec, x.shape[0], x.shape[-1],
                                   torch.float32)
    n_cols = x.shape[0] * x.shape[-1]
    flops = chain_flops(spec, n_cols)
    computed = band_flops(spec.convs(), n_cols)
    conv_flops = needed_flops(spec, x.shape[0], x.shape[-1])
    count = ByteCount(torch)
    with torch.no_grad():
        _apply_chain(xb, spec, torch.bfloat16, count.stage)
    print(f"K1 forward {tuple(x.shape)} bf16, in turns (ms): "
          + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in vs)
                      for k, vs in turns.items())
          + "; device ms a forward: " + ", ".join(
              f"{k} {v:.3f}" for k, v in chain_device_ms.items()))
    print(f"K1 forward {tuple(x.shape)} bf16: {k1_ms:.3f} ms (float32 "
          f"{k1_ms32:.3f} ms), plain {k1_plain:.3f} ms (float32 "
          f"{k1_plain32:.3f} ms), cuDNN net {k1_lib:.3f} ms (float32 "
          f"{k1_lib32:.3f} ms, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}); computes {computed / 1e9:.2f} GFLOP on the bands "
          f"(full blocks {flops / 1e9:.2f}, needed {conv_flops / 1e9:.2f}); "
          f"stage-by-stage bytes {count.n / 1e9:.3f} GB = "
          f"{count.n / PEAK_BYTES * 1e3:.4f} ms at {PEAK_BYTES / 1e12} TB/s")
    w_bytes = sum(cb.blocks.numel() * 2 + cb.bias.numel() * 4
                  for cb in spec.convs())
    io_bytes = x.numel() * 2 + x.shape[0] * spec.r_out * x.shape[-1] * 2
    t_ops = conv_flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (w_bytes + io_bytes) / PEAK_BYTES * 1e3
    print(f"K1 forward bf16 (median of the turns): tt_band_conv_wgmma "
          f"{k1_ms:.3f} ms (the staged epilogue {k1_staged:.3f} ms), cuDNN "
          f"{k1_lib:.3f} ms; bound "
          f"{max(t_ops, t_bytes):.4f} ms, stage-by-stage byte floor "
          f"{count.n / PEAK_BYTES * 1e3:.4f} ms; "
          f"{per_forward} launches; {card}")

    count32 = ByteCount(torch)
    with torch.no_grad():
        _apply_chain(x, spec, torch.float32, count32.stage)
    bound32 = max(f32_ops_ms(conv_flops), 2 * t_bytes)
    print(f"K1 forward {tuple(x.shape)} float32, in turns (ms): "
          + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in vs)
                      for k, vs in turns32.items())
          + "; device ms a forward: " + ", ".join(
              f"{k} {v:.3f}" for k, v in chain_device_ms32.items()))
    print(f"K1 forward float32 (median of the turns): tt_band_conv_wgmma_f32 "
          f"{k1_ms32:.3f} ms, cuDNN {k1_lib32:.3f} ms (cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}); bound {bound32:.4f} ms, "
          f"stage-by-stage byte floor {count32.n / PEAK_BYTES * 1e3:.4f} ms "
          f"({count32.n / 1e9:.3f} GB); the reconstruction spec "
          f"{k1_rec_ms:.3f} ms; {card}")
    print("K1 wrappers' host us a launch (60-stage chain at "
          f"{tuple(x.shape)}, enqueued): " + ", ".join(
              f"{k} {v:.2f}" for k, v in host_us.items()))

    stage_ms = stage_numbers(torch, stages, x.shape[0], x.shape[-1])

    k2_ms = time_ms(torch, lambda: peak_mask(acts, 0.5), 50)
    k2_plain = time_ms(torch, lambda: peak_mask_reference(acts, 0.5), 50)
    k2_bound = acts.numel() * (4 + 1) / PEAK_BYTES * 1e3

    k3 = k3_numbers(torch, train_model, {k: train_launches[k] for k in
                                         (DX, DW, DW_REDUCE, SEED)})
    k3_stages = k3_stage_numbers(torch, stages, TRAIN_CROPS, train_frames)

    kernels = [
        {"name": "banded_conv", "route": "cuda",
         "source": "timbre_trap_tpu_torch/csrc/band_wgmma.cu",
         "entry": "tt_band_conv_wgmma",
         "entry_f32": "tt_band_conv_wgmma_f32",
         "replaces": "timbre_trap_tpu/ops/fused_level.py:463",
         "forward_turns_ms": turns, "forward_device_ms": chain_device_ms,
         "forward_turns_ms_f32": turns32,
         "forward_device_ms_f32": chain_device_ms32,
         "stage_kinds": kind_ms, "stage_kinds_f32": kind_ms32,
         "reconstruct_spec_ms_f32": k1_rec_ms,
         "stage_bytes_f32": count32.n,
         "stage_bytes_ms_f32": count32.n / PEAK_BYTES * 1e3,
         "host_us_per_launch": host_us, "f32_accuracy": f32_acc,
         "launches_per_forward": per_forward,
         "c4": c4,
         "variant_stages": stage_ms,
         "skip_route_ms": variants["route_ms"],
         "skip_route_ms_f32": variants["route_ms_f32"],
         "skip_route_plain_ms": variants["route_plain_ms"],
         "max_abs_err": k1_err, "band_max_rel_err": band_err,
         "band_max_rel_err_f32": band_err32, "sass": sass,
         "ms": k1_ms, "staged_epilogue_ms": k1_staged,
         "epilogue_launches": {
             path: {"tma": n[K1_TMA], "staged": n[K1_STAGED]}
             for path, n in (("transcribe", launches),
                             ("skip_route", launches_var["transcribe"]),
                             ("recipe_step", train_launches))},
         "plain_ms": k1_plain, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "library_ms": k1_lib,
         "shape": f"one {per_forward}-launch forward chain, "
                  f"{tuple(x.shape)} bf16",
         "ms_f32": k1_ms32, "plain_ms_f32": k1_plain32,
         "library_ms_f32": k1_lib32,
         "bound_ms_f32": bound32,
         "bound_by_f32": ("operations" if f32_ops_ms(conv_flops)
                          >= 2 * t_bytes else "bytes"),
         "bound_ms_f32_ffma": conv_flops / PEAK_F32_FLOPS * 1e3,
         "bound_ms_f32_3xtf32": 3 * conv_flops / PEAK_TF32_FLOPS * 1e3,
         "gflop": flops / 1e9, "gflop_computed": computed / 1e9,
         "conv_gflop": conv_flops / 1e9, "stage_bytes": count.n,
         "stage_bytes_ms": count.n / PEAK_BYTES * 1e3},
        {"name": "peak_mask", "route": "cuda",
         "source": "timbre_trap_tpu_torch/csrc/peak_mask.cu",
         "replaces": "timbre_trap_tpu/ops/pallas_kernels.py:26",
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": None,
         "shape": f"{tuple(acts.shape)} float32 -> uint8"},
        {"name": "banded_conv_bwd", "route": "cuda",
         "source": "timbre_trap_tpu_torch/csrc/band_mma.cu",
         "source_seed": "timbre_trap_tpu_torch/csrc/banded_conv_bwd.cu",
         "replaces": "timbre_trap_tpu/ops/fused_level.py:647",
         "variant_stages": {name: dict(row, max_rel_err=k3_stage_err[name])
                            for name, row in k3_stages.items()},
         "max_abs_err": k3_err, **k3},
    ]
    # Every counted call's kernels by name (a family's and a probe's a
    # step; phase 3h's per rank and path).
    counted = {"c4_transcribe": launches_c4,
               "transcribe": launches, "transcribe_f32": launches32,
               "reconstruct": launches_rec, "variants": launches_var,
               "train_step": train_launches,
               "train_f32_step": train["f32_step_launches"],
               "family_train_per_step": family_launches,
               "trainer_resumed": trainer_launches, "cli": cli_launches,
               "parallel": par_launches, "last_modules": last_launches}
    print(f"transcribe_rtf: {rtf_warm:.2f} second call ({CLIP_SECS:.0f} s "
          f"clip, {wall_warm:.3f} s wall, bf16 chain, peak mask included); "
          f"float32 chain {rtf32:.2f} second call ({wall32:.3f} s wall)")
    lap(None)
    print(f"phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                       phase_s.items())
          + f"; {sum(phase_s.values()):.1f} in all")
    print(json.dumps({"train": train}))
    print(json.dumps({"family_train": families, "phase_s": phase_s}))
    print(json.dumps({"transform": transform, "reconstruct": recon}))
    print(json.dumps({"variants": variants}))
    print(json.dumps({"trainer": trainer}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"parallel": par, "card": card}))
    print(json.dumps({"last_modules": last, "card": card}))
    print(card)
    print(json.dumps({"launches": counted}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    else:
        main()

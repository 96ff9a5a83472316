#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (timbre_trap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build   — compile every CUDA kernel of the port from ``csrc/`` (nvcc,
             sm_90a, in parallel) and print the build time and the card;
2. parity  — hold each kernel against its plain PyTorch version on the
             card at the flagship shapes: the conv chain kernel (K1) item
             by item and as the whole 36-item chain at (4, 1080, 1024), in
             float32 (max abs error <= 1e-4 * max|ref|, TF32 off) and in
             bfloat16 (<= 5e-2 * max|ref| against the float32 plain
             version); the peak-mask kernel (K2) exactly, at t = 0.5 and 0;
             the level backward (K3) on each of the 8 training levels at
             (2, R_in, 1024): dX and every parameter's gradient against
             torch autograd of the plain chain, float32 within
             1e-4 * max|ref|, bfloat16 within 5e-2 * max|ref|; and at the
             recipe step's (8, R_in, 3072) against its plain twin on the
             same tensors: dX, dW and dBias float32 within 1e-4 * max|ref|,
             bfloat16 within 1e-2 * max|ref|, and the same bits in two
             runs;
3. main    — the flagship model (22.05 kHz, 9 x 60 bins, 3-s blocks,
             latent 128, complexity 2, seeded random weights) transcribes a
             ~100-s chord clip (3 pieces of 16 blocks), then peak_mask; the
             kernels' launch counts are zeroed just before and read just
             after and must be > 0; activations must be finite, in [0, 1],
             of shape (1, 540, frames), and within 5e-2 of a float32 run;
             the mask must equal the plain version's on those activations;
             a small model on the card matches the same weights on the CPU.
             Then training at the reference recipe: 5 ``"pallas_bf16"``
             steps on one seeded batch of 8 chord-and-noise 9-s crops
             (int16 compact uploads, uint8 ground truth), K1 and K3 counts
             zeroed just before and read just after (> 0), every metric
             finite, the loss falling; one bf16 step against one float32
             ``"packed"`` (plain twin) step from the same weights on 2 of
             the crops (the twin's batch is cut for its time and memory),
             loss within 2e-2 and the whole gradient within 5e-2 in
             relative L2; on those crops and at the small geometry one
             float32 ``"pallas"`` step against ``"packed"``, losses within
             1e-5 and gradients within 1e-4 * each leaf's max|g|;
4. numbers — kernel, plain-version and library times, the least time the
             card could take (bound), the real-time factor of the counted
             (first) call and of a second call at the same length, and the
             train step's time, audio rate and peak memory.

Prints the kernels' JSON line and the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.
"""

import json
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
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def rel_err(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, scale


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
        if cb.per_block:
            total += int(nz[0, :cb.r_out, :cb.r_in].sum()) * frames
            continue
        ks = np.arange(cb.k)
        for j in range(cb.n_out_blocks):
            rows = min(BLOCK_ROWS, cb.r_out - j * BLOCK_ROWS)
            src = j * cb.col_adv - cb.margin + ks
            ok = np.flatnonzero((src >= 0) & (src < cb.r_in))
            for di, dt in enumerate(cb.dts):
                cols = max(frames - abs(dt), 0)
                total += int(nz[di, :rows][:, ok].sum()) * cols
    return 2 * batch * total


def phase_build(_build):
    secs, logs = _build.build_all()
    print(f"build: {secs:.1f} s for {len(logs)} libraries")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


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
        elif cb.per_block:
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


def k3_recipe_parity(torch, spec, frames, gen):
    """K3 (``level_backward``) against its plain twin
    (``level_backward_reference``) on the same card tensors at the shape
    the recipe step gives it, x (TRAIN_CROPS, R_in, frames) and dy
    (TRAIN_CROPS, R_out, frames): dX and every conv's dW and dBias within
    1e-4 * max|ref| in float32 and 1e-2 * max|ref| in bfloat16 (sum order,
    and bf16 recompute outputs that round the other way); two bf16 runs
    give the same bits. Returns (float32 max abs error, f32 rel, bf16
    rel)."""
    from timbre_trap_tpu_torch.ops.fused_level import (
        level_backward, level_backward_reference)

    dev = spec.items[0][1].blocks.device
    x = torch.randn((TRAIN_CROPS, spec.r_in, frames), generator=gen,
                    device=dev)
    dy = torch.randn((TRAIN_CROPS, spec.r_out, frames), generator=gen,
                     device=dev)
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
            check(err <= tol * scale, f"K3 at the recipe shape "
                  f"{tuple(xs.shape)} {dtype}: output {i} (0 = dX, then dW, "
                  f"dBias per conv) error {err} > {tol} * {scale}")
            err_abs = max(err_abs, err)
            rel = max(rel, err / max(scale, 1e-30))
        same = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(a, b) for p, q in zip(runs[0][1], runs[1][1])
            for a, b in zip(p, q))
        check(same, f"K3 at the recipe shape {dtype}: two runs differ")
        out += [err_abs, rel]
        del runs, want
    return out[0], out[1], out[3]


def phase_k3_parity(torch, net, frames):
    """K3 on the 8 training levels of ``net`` (encoder levels 1-4 with
    convin, decoder levels 1-4 with convout): against torch autograd of the
    plain chain at (2, R_in, 1024) with a seeded cotangent, and against its
    plain twin at the recipe step's (TRAIN_CROPS, R_in, ``frames``)
    (``k3_recipe_parity``). Returns the largest float32 abs error at the
    recipe shape."""
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
            e_abs, q32, q16 = k3_recipe_parity(torch, spec_of(idx), frames,
                                               gen)
        worst = max(worst, e_abs)
        kind = "encoder" if idx < 4 else "decoder"
        print(f"  K3 {kind} level {idx % 4 + 1} ({spec.r_in}->{spec.r_out} "
              f"rows, {len(ref) - 1} params): vs autograd f32 rel "
              f"{r32:.2e}  bf16 rel {r16:.2e}; vs twin at ({TRAIN_CROPS}, "
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


def check_kernel_step(label, got, want):
    """Holds one float32 ``"pallas"`` step's (metrics, gradients) against
    the float32 ``"packed"`` step's: every loss within 1e-5 relative, every
    leaf's gradient within 1e-4 * its max|g|. Returns both gaps."""
    (mp, gp), (mk, gk) = got, want
    loss_rel = max(abs(mp[k] - mk[k]) / abs(mk[k]) for k in mk
                   if k.startswith("loss/"))
    grad_rel, leaf = worst_leaf(gp, gk)
    print(f"main: {label} pallas vs packed, losses rel {loss_rel:.2e}, "
          f"gradients rel {grad_rel:.2e} (worst {leaf})")
    check(loss_rel <= 1e-5, f"{label} pallas step losses off by {loss_rel}")
    check(grad_rel <= 1e-4, f"{label} pallas step gradient of {leaf} off "
          f"by {grad_rel} * its max|g|")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel}


def one_step(torch, model, weights, backend, audio, gt, lr):
    """One train step of ``backend`` from ``weights`` -> (metrics as
    floats, gradients)."""
    from timbre_trap_tpu_torch.train import (TrainConfig, init_train_state,
                                             make_train_step)

    cfg = TrainConfig()
    model.load_state_dict(weights)
    step = make_train_step(model, cfg, audio.shape[0], conv_backend=backend,
                           compact_audio_grid=True)
    metrics = step(init_train_state(model, cfg), audio, gt, lr)
    grads = {n: p.grad.clone() for n, p in model.net.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def phase_train(torch, counters):
    """The reference recipe's training step on the card (phase 3) and its
    step numbers (phase 4). Returns (numbers, launches, the model)."""
    from timbre_trap_tpu_torch.models import TimbreTrap
    from timbre_trap_tpu_torch.train import (TrainConfig, cosine_warmup,
                                             init_train_state,
                                             make_train_step,
                                             synthetic_batch)

    model = TimbreTrap(SR, N_OCT, BPO, SECS, latent_size=LATENT,
                       model_complexity=COMPLEXITY, seed=1)
    audio, gt = synthetic_batch(model, TRAIN_CROPS, TRAIN_SECS)
    check(gt.shape == (TRAIN_CROPS, 540, 3072), f"ground truth {gt.shape}")
    w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    cfg = TrainConfig(learning_rate=TRAIN_LR)
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, TRAIN_CROPS, conv_backend="pallas_bf16",
                           compact_audio_grid=True)
    warmup = cosine_warmup(TRAIN_WARMUP)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, history = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(state, audio, gt, cfg.learning_rate * float(warmup(i)))
        metrics = {k: float(v) for k, v in metrics.items()}
        walls.append(time.perf_counter() - t0)
        history.append(metrics)
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss/total"] for m in history]
    check(all(np.isfinite(v) for m in history for v in m.values()),
          "a train metric is not finite")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for key in ("avg_norm/encoder", "max_norm/encoder", "avg_norm/decoder",
                "max_norm/decoder", "loss/consistency/spectral"):
        check(key in history[-1], f"train metrics lack {key}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the train step")
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

    # one float32 "pallas" step at the recipe (the second of two).
    model.load_state_dict(w0)
    st32 = init_train_state(model, cfg)
    step32 = make_train_step(model, cfg, TRAIN_CROPS, conv_backend="pallas",
                             compact_audio_grid=True)
    for _ in range(2):
        t0 = time.perf_counter()
        float(step32(st32, audio, gt, TRAIN_LR)["loss/total"])
        wall32 = time.perf_counter() - t0
    step_s = float(np.mean(walls[1:]))
    audio_secs = TRAIN_CROPS * TRAIN_SECS
    numbers = {"train_step_ms": step_s * 1e3,
               "train_step_ms_each": [w * 1e3 for w in walls],
               "audio_s_per_s": audio_secs / step_s,
               "peak_bytes": peak, "f32_step_ms": wall32 * 1e3,
               "loss_total": losses,
               "bf16_vs_twin": {"loss_rel": d_bf16, "grad_l2_rel": l2_bf16,
                                "worst_leaf_rel": leaf_bf16,
                                "worst_leaf": leaf},
               "f32_kernels_vs_twin": gaps}
    print(f"train_step_ms: {step_s * 1e3:.1f} (pallas_bf16, mean of steps "
          f"2-{TRAIN_STEPS}; step 1 {walls[0] * 1e3:.1f}), "
          f"{audio_secs / step_s:.1f} audio-s/s, peak "
          f"{peak / 2**30:.2f} GiB; float32 pallas step {wall32 * 1e3:.1f} ms")
    return numbers, launches, model


def k3_numbers(torch, model, launches_per_step):
    """K3 at the flagship encoder level 1 (convin fused) at the recipe's
    (8, 1080, 3072), bf16: kernel, plain twin and cuDNN times and bounds."""
    import copy

    from timbre_trap_tpu_torch.interop import hwio_params
    from timbre_trap_tpu_torch.models.fused import level_specs
    from timbre_trap_tpu_torch.ops.fused_level import (
        level_backward, level_backward_reference)
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
    bf16 = torch.bfloat16
    with torch.no_grad():
        ms = time_ms(torch, lambda: level_backward(xb, spec, dyb, bf16), 5)
        plain = time_ms(torch, lambda: level_backward_reference(
            xb, spec, dyb, bf16), 2)

    lib = torch.nn.Sequential(copy.deepcopy(net.encoder.convin),
                              copy.deepcopy(net.encoder.block1)).to(bf16)
    x_nchw = unpack_to_nchw(xb, spec.items[0][1].c_in).contiguous()
    x_nchw.requires_grad_(True)
    dy_nchw = unpack_to_nchw(dyb, spec.items[-1][1].c_out).contiguous()
    y = lib(x_nchw)
    params = list(lib.parameters())
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        y, [x_nchw] + params, dy_nchw, retain_graph=True), 5)

    fwd_flops = needed_flops(spec, b, t)
    bwd_flops = 2 * fwd_flops           # dX and dW, every conv
    io_bytes = 2 * xb.numel() * 2 + dyb.numel() * 2
    w_bytes = sum(cb.blocks.numel() * (2 + 4) + cb.bias.numel() * (4 + 4)
                  + cb.adjoint.blocks.numel() * 2 for cb in spec.convs())
    t_ops = bwd_flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (io_bytes + w_bytes) / PEAK_BYTES * 1e3
    n_convs = sum(1 for _ in spec.convs())
    print(f"K3 level backward, encoder level 1 ({n_convs} convs) at "
          f"{tuple(xb.shape)} bf16: {ms:.3f} ms, plain {plain:.3f} ms, cuDNN "
          f"autograd {lib_ms:.3f} ms; dX+dW {bwd_flops / 1e9:.2f} GFLOP "
          f"needed, recompute {fwd_flops / 1e9:.2f} GFLOP")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "shape": f"encoder level 1 backward ({n_convs} convs, convin "
                     f"fused), x {tuple(xb.shape)} bf16, dy "
                     f"{tuple(dyb.shape)}",
            "bwd_gflop": bwd_flops / 1e9, "recompute_gflop": fwd_flops / 1e9,
            "launches_per_step": launches_per_step}


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
        from timbre_trap_tpu_torch.ops.fused_level import (
            banded_conv, banded_conv_dw, banded_conv_dx, chain_flops,
            elu_backward, fused_level_apply, packed_level_apply)
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

    # 1. build
    phase_build(_build)

    # 2. parity at the flagship shapes, on real features of the clip
    model = TimbreTrap(SR, N_OCT, BPO, SECS, latent_size=LATENT,
                       model_complexity=COMPLEXITY, seed=0)
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
    print(f"parity: {time.perf_counter() - t_par:.1f} s")

    # 3. the main path: transcribe + peak_mask, counted
    banded_conv.launches = 0
    peak_mask.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = model.transcribe(audio)
    mask = peak_mask(acts, 0.5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"banded_conv": banded_conv.launches,
                "peak_mask": peak_mask.launches}
    check(tuple(acts.shape) == (1, F, n_frames),
          f"activations {tuple(acts.shape)}, expected (1, {F}, {n_frames})")
    check(bool(torch.isfinite(acts).all()), "activations are not finite")
    check(acts.min().item() >= 0.0 and acts.max().item() <= 1.0,
          "activations leave [0, 1]")
    check(mask.dtype == torch.uint8 and mask.shape == acts.shape, "mask shape")
    check(torch.equal(mask, peak_mask_reference(acts, 0.5)),
          "the main path's peak mask differs from its plain version")
    check(launches["banded_conv"] > 0, "K1 was not launched on the main path")
    check(launches["peak_mask"] > 0, "K2 was not launched on the main path")
    rtf = CLIP_SECS / wall
    print(f"main: {CLIP_SECS:.0f} s clip in {wall:.3f} s (RTF {rtf:.1f}), "
          f"launches {launches}, peaks {int(mask.sum())}")
    # The first call at this clip length also pays one-time costs (pinned
    # host buffers, cuFFT plans, allocator growth); a second call does not.
    t0 = time.perf_counter()
    peak_mask(model.transcribe(audio), 0.5)
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    rtf_warm = CLIP_SECS / wall_warm

    model.fused = "f32"
    acts32 = model.transcribe(audio)
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

    # 3b. the training main path, counted
    k3_wrappers = (banded_conv_dx, banded_conv_dw, elu_backward)
    train, train_launches, train_model = phase_train(
        torch, (banded_conv,) + k3_wrappers)
    k3_launches = sum(train_launches[fn.__name__] for fn in k3_wrappers)

    # 4. numbers at the main path's shapes
    spec = model._spec(True)
    xb = x.to(torch.bfloat16)
    k1_ms = time_ms(torch, lambda: fused_level_apply(xb, spec, torch.bfloat16))
    k1_plain = time_ms(torch, lambda: packed_level_apply(xb, spec,
                                                         torch.bfloat16), 3)
    k1_ms32 = time_ms(torch, lambda: fused_level_apply(x, spec, torch.float32))
    k1_plain32 = time_ms(torch, lambda: packed_level_apply(x, spec,
                                                           torch.float32), 3)
    net16 = TimbreTrapNet(F, LATENT, COMPLEXITY).cuda()
    net16.load_state_dict(model.net.state_dict())
    net16 = net16.to(torch.bfloat16).eval()
    nchw = feats.movedim(-1, 1).to(torch.bfloat16).contiguous()
    with torch.no_grad():
        k1_lib = time_ms(torch, lambda: net16(nchw, True))
    launches_per_forward = sum(1 for _ in spec.convs())
    n_cols = x.shape[0] * x.shape[-1]
    flops = chain_flops(spec, n_cols)
    conv_flops = needed_flops(spec, x.shape[0], x.shape[-1])
    w_bytes = sum(cb.blocks.numel() * 2 + cb.bias.numel() * 4
                  for cb in spec.convs())
    io_bytes = x.numel() * 2 + x.shape[0] * spec.r_out * x.shape[-1] * 2
    t_ops = conv_flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (w_bytes + io_bytes) / PEAK_BYTES * 1e3

    k2_ms = time_ms(torch, lambda: peak_mask(acts, 0.5), 50)
    k2_plain = time_ms(torch, lambda: peak_mask_reference(acts, 0.5), 50)
    k2_bound = acts.numel() * (4 + 1) / PEAK_BYTES * 1e3

    k3 = k3_numbers(torch, train_model, k3_launches / TRAIN_STEPS)

    kernels = [
        {"name": "banded_conv", "route": "cuda",
         "source": "timbre_trap_tpu_torch/csrc/banded_conv.cu",
         "replaces": "timbre_trap_tpu/ops/fused_level.py:463",
         "launches": launches["banded_conv"],
         "launches_train": train_launches["banded_conv"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": max(t_ops, t_bytes),
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "library_ms": k1_lib,
         "shape": f"one {launches_per_forward}-launch forward chain, "
                  f"{tuple(x.shape)} bf16",
         "ms_f32": k1_ms32, "plain_ms_f32": k1_plain32,
         "bound_ms_f32": max(conv_flops / PEAK_F32_FLOPS * 1e3, 2 * t_bytes),
         "gflop": flops / 1e9, "conv_gflop": conv_flops / 1e9},
        {"name": "peak_mask", "route": "cuda",
         "source": "timbre_trap_tpu_torch/csrc/peak_mask.cu",
         "replaces": "timbre_trap_tpu/ops/pallas_kernels.py:26",
         "launches": launches["peak_mask"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": None,
         "shape": f"{tuple(acts.shape)} float32 -> uint8"},
        {"name": "banded_conv_bwd", "route": "cuda",
         "source": "timbre_trap_tpu_torch/csrc/banded_conv_bwd.cu",
         "replaces": "timbre_trap_tpu/ops/fused_level.py:647",
         "launches": k3_launches,
         "launches_by_wrapper": {fn.__name__: train_launches[fn.__name__]
                                 for fn in k3_wrappers},
         "max_abs_err": k3_err, **k3},
    ]
    print(f"transcribe_rtf: {rtf:.2f} first call, {rtf_warm:.2f} second call "
          f"({CLIP_SECS:.0f} s clip, {wall:.3f} s / {wall_warm:.3f} s wall, "
          f"bf16 chain, peak mask included)")
    print(json.dumps({"train": train}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

A cell's traffic file names its kind:

* ``transcribe``: a closed loop of one caller. A request is the port's
  ``TimbreTrap.transcribe`` on a host clip, then ``peak_mask``, then the
  mask copied to the host; its latency runs from the call until the mask
  is there.
* ``reconstruct``: the same with ``TimbreTrap.reconstruct``, the
  normalised audio copied to the host.
* ``train``: a closed loop of recipe steps (``make_train_step``), each
  batch copied to the card as the Trainer copies it and the loss read on
  the host after each step.

Set-up makes the weights on the device from the seed, builds the port's
model from them, makes the traffic, and warms every shape the traffic
uses. The window then runs for ``seconds`` and ends with the first
request (or step) that completes after that, and not before every
request of the check's sample (drawn from the first ``check_span``) has
completed; every rate is all the work completed over the window's whole
length.

The check runs after the window, once the peak memory has been read and
the port's model freed: the plain reference (``reference/``) recomputes a
seeded sample of the requests completed in the window (or the training
recipe's first steps) from the same inputs and weights, and every number
compared is printed beside its limit (``limits/<cell>.json``).
"""

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import spec, trace
from .conditions import Conditions
from . import traffic as gen
from .reference.model import OBJECTIVES, Reference, cosine_warmup
from .reference.model import peak_mask as plain_peak_mask
from .reference.net import TimbreTrapNet
from .reference.slicq import window_length
from .work import convs as work

__all__ = ["FORBIDDEN", "forbidden_modules", "make_weights", "run",
           "Inference", "Train", "train_numbers", "judge"]

# Top-level module names no run may hold: JAX and its libraries, and the
# JAX package of which the port is a port (compared as whole names).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "timbre_trap_tpu")
B1 = 0.9   # Adam's first-moment decay: the first step's mu is (1 - B1) g.


def forbidden_modules(modules=None):
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def seconds_since_start():
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_weights(config, seed, device, bias_std):
    """A reference-named state_dict drawn on ``device`` from ``seed`` in
    two calls: weights ~ N(0, 1 / fan_in), biases ~ N(0, bias_std²) and
    skip weights ~ 1 + N(0, bias_std²)."""
    m = config["model"]
    with torch.device("meta"):
        net = TimbreTrapNet(m["n_octaves"] * m["bins_per_octave"],
                            m["latent_size"], m["model_complexity"],
                            m["skip_connections"])
    transposed = {name + ".weight" for name, mod in net.named_modules()
                  if isinstance(mod, torch.nn.ConvTranspose2d)}
    shapes = {k: v.shape for k, v in net.state_dict().items()}
    weights = [k for k in shapes if k.endswith(".weight")]
    others = [k for k in shapes if k not in weights]
    g = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    out = {}
    for names, scale in ((weights, None), (others, bias_std)):
        sizes = [math.prod(shapes[k]) for k in names]
        flat = torch.randn(sum(sizes), generator=g, device=device)
        for k, part in zip(names, flat.split(sizes)):
            shape = shapes[k]
            if scale is None:
                c_in = shape[0] if k in transposed else shape[1]
                part = part / math.sqrt(c_in * math.prod(shape[2:]))
            else:
                part = part * scale + (1.0 if k == "skip_weights" else 0.0)
            out[k] = part.reshape(shape).contiguous()
    return out


class _Spans:
    """``record_function`` spans in a traced run; nothing otherwise."""

    def __init__(self, on):
        self.on = on

    def __call__(self, name):
        if self.on:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


class Inference:
    """The ``transcribe`` and ``reconstruct`` kinds."""

    def __init__(self, cell, seed, device, program, spans):
        self.cell = cell
        self.model_cfg = cell.config["model"]
        self.traffic = t = cell.traffic
        self.kind = t["kind"]
        self.device = device
        self.program = program
        self.span = spans
        self.sr = self.model_cfg["sample_rate"]
        self.marks = [("imports", seconds_since_start())]
        self.weights = make_weights(cell.config, seed, device,
                                    cell.config["bias_std"][self.kind])
        _mark(self.marks, "weights", device)
        self.polyphony = gen.Polyphony(t, self.sr, seed, device)
        self.plan = gen.clip_plan(t, self.sr, seed)
        _mark(self.marks, "traffic", device)
        rng = np.random.default_rng([seed, 4])
        self.check_ids = sorted(int(i) for i in rng.choice(
            t["check_span"], t["check_requests"], replace=False))
        self.kept = {}
        self.model = program.build_model(cell.config, self.weights, device)
        _mark(self.marks, "model", device)
        order = sorted(range(len(self.plan)), key=lambda i: self.plan[i][1])
        n = min(t["warm_requests"], len(order))
        picks = {order[round(j * (len(order) - 1) / max(n - 1, 1))]
                 for j in range(n)}
        for i in sorted(picks):
            self.request(i, keep=False)
        _mark(self.marks, "warm-up", device)

    def clip(self, i):
        offset, length = self.plan[i % len(self.plan)]
        return self.polyphony.clip(offset, length)

    def request(self, i, keep=True):
        """Request ``i``; returns its audio seconds."""
        clip = self.clip(i)[None, None]
        span = self.span
        with span("request"):
            if self.kind == "transcribe":
                with span("transcribe"):
                    act = self.model.transcribe(clip)
                with span("peak_mask"):
                    mask = self.program.peak_mask(act)
                with span("to_host"):
                    out = (act, mask.cpu())
            else:
                with span("reconstruct"):
                    y = self.model.reconstruct(clip)
                with span("to_host"):
                    out = (y.cpu(),)
        if keep and i in self.check_ids:
            self.kept[i] = out
        return clip.shape[-1] / self.sr

    def window(self, seconds):
        """The closed loop; returns the window's record."""
        latencies, audio_s, i = [], 0.0, 0
        t0 = time.perf_counter()
        while True:
            start = time.perf_counter()
            audio_s += self.request(i)
            end = time.perf_counter()
            latencies.append(end - start)
            i += 1
            # Every request of the check's sample is due in the window.
            if end - t0 >= seconds and i > self.check_ids[-1]:
                break
        return {"window_s": end - t0, "latencies": latencies,
                "audio_s": audio_s, "requests": i}

    def free(self):
        self.model = None

    def numbers(self):
        """The compared numbers over the kept requests (those of the
        check's sample that completed in the window)."""
        ref = Reference(self.cell.config, self.weights, self.device)
        out = {}
        for i, kept in sorted(self.kept.items()):
            clip = self.clip(i)
            if self.kind == "transcribe":
                act, mask = kept
                gap = (act - ref.activations(clip)).abs().max()
                bad = (plain_peak_mask(act).cpu() != mask).sum()
                _worst(out, "act_max_gap", float(gap))
                out["mask_mismatch"] = out.get("mask_mismatch", 0) + int(bad)
            else:
                y = ref.reconstruct(clip).cpu()
                _worst(out, "audio_max_gap", float((kept[0] - y).abs().max()))
        out["checked_requests"] = len(self.kept)
        return out

    def end_to_end(self, rec):
        lat = np.asarray(rec["latencies"]) * 1e3
        rtf = rec["audio_s"] / rec["window_s"]
        print(f"portbench: {rec['requests']} requests, {rec['audio_s']:.3f} "
              f"audio s in {rec['window_s']:.6f} s; latency median "
              f"{float(np.median(lat)):.4f} ms, p95 "
              f"{float(np.percentile(lat, 95)):.4f} ms", file=sys.stderr)
        return {f"{self.kind}_rtf": rtf,
                f"{self.kind}_p95_ms": float(np.percentile(lat, 95))}

    def work(self, rec):
        """The architecture's operations and bytes over the window."""
        m = self.model_cfg
        size = 2 if self.kind == "transcribe" else 4
        block = int(m["secs_per_block"] * self.sr)
        M = window_length(self.sr, m["n_octaves"], m["bins_per_octave"], block)
        chunks = 0
        for i in range(rec["requests"]):
            chunks += 2 * -(-self.plan[i % len(self.plan)][1] // block) + 1
        convs = work.network_convs(m)
        # The skip route computes the bridge as float64 einsums, not on K1.
        k1 = [c for c in convs
              if not (m["skip_connections"] and c.name in work.BRIDGE)]
        model_ops, _ = work.forward_work(convs, M * chunks, size)
        k1_ops, k1_bytes = work.forward_work(k1, M * chunks, size)
        return {"model_ops": model_ops, "k1_ops": k1_ops, "k1_bytes": k1_bytes,
                "audio_s": rec["audio_s"]}


def _mark(marks, name, device):
    _sync(device)
    marks.append((name, seconds_since_start()))


def _worst(out, key, value):
    out[key] = max(out.get(key, value), value)


class Train:
    """The ``train`` kind: the recipe step in a closed loop."""

    def __init__(self, cell, seed, device, program, spans):
        self.cell = cell
        self.model_cfg = m = cell.config["model"]
        self.traffic = t = cell.traffic
        self.kind = "train"
        self.device = device
        self.span = spans
        sr = m["sample_rate"]
        block = int(m["secs_per_block"] * sr)
        self.frames = -(-int(t["crop_s"] * sr) // block) * window_length(
            sr, m["n_octaves"], m["bins_per_octave"], block)
        self.marks = [("imports", seconds_since_start())]
        self.weights = make_weights(cell.config, seed, device,
                                    cell.config["bias_std"]["train"])
        _mark(self.marks, "weights", device)
        polyphony = gen.Polyphony(t, sr, seed, device)
        self.pool = gen.train_pool(t, polyphony, m, self.frames, seed,
                                   pin=device.type == "cuda")
        _mark(self.marks, "traffic", device)
        self.model = program.build_model(cell.config, self.weights, device)
        self.step_fn, self.state = program.make_step(self.model, t)
        _mark(self.marks, "model", device)
        self.copy = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)
        self.count = 0
        self.next = self.upload(self.pool[0])
        # The first steps go through the window's own call on batches
        # whose rows all differ; the check follows them with the reference.
        self.first_losses = []
        for k in range(t["checked_steps"]):
            metrics = self.step(all_losses=True)
            self.first_losses.append(metrics)
            if k == 0:
                self.first_grads = {n: v / (1 - B1) for n, v in
                                    _clone(self.state["mu"]).items()}
        self.after = _clone(dict(self.model.net.named_parameters()))
        _mark(self.marks, "first steps", device)

    def lr(self, count):
        t = self.traffic
        return t["learning_rate"] * cosine_warmup(t["warmup_steps"], count - 1)

    def upload(self, batch):
        """The Trainer's copy of a pinned batch: on a side stream after the
        work queued so far, into blocks allocated on the main stream."""
        if self.copy is None:
            return batch[0], batch[1], None
        main = torch.cuda.current_stream(self.device)
        dev = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
               for x in batch]
        self.copy.wait_stream(main)
        with torch.cuda.stream(self.copy):
            for d, x in zip(dev, batch):
                d.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy)
        return dev[0], dev[1], done

    def step(self, all_losses=False):
        span = self.span
        self.count += 1
        audio, truth, done = self.next
        with span("step"):
            if done is not None:
                torch.cuda.current_stream(self.device).wait_event(done)
            metrics = self.step_fn(self.state, audio, truth,
                                   self.lr(self.count))
        with span("upload"):
            self.next = self.upload(self.pool[self.count % len(self.pool)])
        with span("loss_read"):
            if all_losses:
                return {k: float(metrics[k]) for k in OBJECTIVES}
            return float(metrics["loss/total"])

    def window(self, seconds):
        steps = 0
        t0 = time.perf_counter()
        while True:
            self.step()
            steps += 1
            end = time.perf_counter()
            if end - t0 >= seconds:
                break
        return {"window_s": end - t0, "steps": steps}

    def free(self):
        self.model = self.step_fn = self.state = self.next = None

    def reference_run(self, quant=None, rows=None):
        """The reference's record of the first steps (``rows``: the batch
        rows it keeps, for a planted fault)."""
        t = self.traffic
        n = t["checked_steps"]
        batches = [(a.numpy(), g.numpy()) for a, g in self.pool[:n]]
        if rows is not None:
            m = t["mpe_crops"]
            batches = [(a[rows], g[[r for r in rows if r < m]])
                       for a, g in batches]
        ref = Reference(self.cell.config, self.weights, self.device, quant)
        return ref.train(batches, [self.lr(k) for k in range(1, n + 1)], t)

    def numbers(self):
        return train_numbers((self.first_losses, self.first_grads,
                              self.after), self.reference_run(),
                             self.weights)

    def end_to_end(self, rec):
        print(f"portbench: {rec['steps']} steps in {rec['window_s']:.6f} s",
              file=sys.stderr)
        return {"train_step_ms": rec["window_s"] * 1e3 / rec["steps"]}

    def work(self, rec):
        """Forward and backward operations of a recipe step (two encodes,
        four decodes, no recompute), and the backward's work on every conv
        but the dense bridge."""
        t = self.traffic
        frames = (t["mpe_crops"] + t["audio_crops"]) * self.frames
        convs = work.network_convs(self.model_cfg)
        enc = [c for c in convs if c.name.startswith("encoder.")]
        dec = [c for c in convs if c.name.startswith("decoder.")]
        no_bridge = [c for c in convs if c.name not in work.BRIDGE]
        k3_enc = [c for c in no_bridge if c.name.startswith("encoder.")]
        k3_dec = [c for c in no_bridge if c.name.startswith("decoder.")]
        fwd = 2 * work.forward_work(enc, frames, 2)[0] \
            + 4 * work.forward_work(dec, frames, 2)[0]
        bwd = work.backward_work(enc, frames, 2, False)[0] \
            + work.backward_work(enc, frames, 2)[0] \
            + 4 * work.backward_work(dec, frames, 2)[0]
        k3 = [work.backward_work(k3_enc, frames, 2, False),
              work.backward_work(k3_enc, frames, 2)] \
            + [work.backward_work(k3_dec, frames, 2)] * 4
        steps = rec["steps"]
        return {"model_ops": (fwd + bwd) * steps,
                "k3_ops": sum(o for o, _ in k3) * steps,
                "k3_bytes": sum(b for _, b in k3) * steps, "steps": steps}


def _clone(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def leaf_gaps(prog, ref, leaves):
    """{leaf: (gap, diff)}: the gap between the two sides' norms, and the
    norm of their difference, each over the larger of that leaf's
    reference norm and the median leaf's."""
    rn = {k: float(torch.linalg.vector_norm(ref[k])) for k in leaves}
    median = float(np.median(list(rn.values())))
    out = {}
    for k in leaves:
        scale = max(rn[k], median)
        out[k] = (abs(float(torch.linalg.vector_norm(prog[k])) - rn[k])
                  / scale,
                  float(torch.linalg.vector_norm(prog[k] - ref[k])) / scale)
    return out


def moved_leaves(grads_r):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in grads_r.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    return [k for k in sorted(norms) if norms[k] >= floor]


def train_numbers(prog, ref, weights):
    """The numbers ``limits/<cell>.json`` compares for a training cell,
    program against reference, by leaf (``leaf_gaps``): of the first
    gradient as the optimizer takes it, the median leaf's norm of the
    difference and gap of norms; of the parameters' change over the
    checked steps (moved leaves only), the median leaf's norm of the
    difference and gap of norms, and the worst leaf's gap of norms."""
    _, grads_p, after_p = prog
    _, grads_r, after_r = ref
    grad = leaf_gaps(grads_p, grads_r, sorted(grads_r)).values()
    moved = moved_leaves(grads_r)
    change = leaf_gaps({k: after_p[k] - weights[k] for k in moved},
                       {k: after_r[k] - weights[k] for k in moved},
                       moved).values()
    return {
        "grad_diff": float(np.median([d for _, d in grad])),
        "grad_gap_median": float(np.median([g for g, _ in grad])),
        "change_diff": float(np.median([d for _, d in change])),
        "change_gap_median": float(np.median([g for g, _ in change])),
        "change_gap": max(g for g, _ in change),
    }


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}) for every limited number."""
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


KINDS = {"transcribe": Inference, "reconstruct": Inference, "train": Train}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def run(cell, seed, seconds, traced, device, program):
    """One run; returns the result dict (the result line's keys, ``checks``
    last)."""
    spans = _Spans(traced)
    runner = KINDS[cell.traffic["kind"]](cell, seed, device, program, spans)
    conditions = Conditions(device.type == "cuda")
    conditions.before()
    setup_s = seconds_since_start()
    print("portbench: set-up " + ", ".join(
        f"{name} {t - t0:.3f} s" for (_, t0), (name, t) in
        zip([("start", 0.0)] + runner.marks, runner.marks)), file=sys.stderr)
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with spans("window"):
        rec = runner.window(seconds)
    conditions.after()
    if prof is not None:
        prof.stop()
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    runner.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = runner.numbers()
    correct, checks = judge(numbers, cell.limits)
    result = {"correct": correct, "attempted": rec.get("requests",
                                                       rec.get("steps")),
              "failed": 0}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if traced:
        reduced = trace.reduce_trace(prof)
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        metrics = per_layer(cell, runner, rec, reduced)
        result["breakdown"] = {"device_ops": trace.top(reduced["device_ops"]),
                               "idle_gaps": trace.top(reduced["idle_gaps"])}
    else:
        values = runner.end_to_end(rec)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev
    result["conditions"] = conditions.summary()
    result["checks"] = checks
    return result


def per_layer(cell, runner, rec, reduced):
    """Every per-layer metric of the cell that its reader finds."""
    groups = {g: sum(s for name, s in reduced["device_ops"].items()
                     if any(p.search(name) for p in pats))
              for g, pats in spec.kernel_groups(cell.root).items()}
    ctx = {"trace": reduced, "groups": groups,
           "work": runner.work(rec), "peaks": spec.peaks(cell.root)}
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def report(result, out=sys.stdout, err=sys.stderr):
    """The checks as the last lines on standard error, then the result as
    the last line on standard output."""
    power = _power_limit()
    peaks = spec.peaks()
    print(f"portbench: peaks bf16 {peaks['bf16_flops']:.4g} FLOP/s, tf32 "
          f"{peaks['tf32_flops']:.4g} FLOP/s, HBM {peaks['hbm_bytes']:.4g} "
          f"B/s; card power limit {power}", file=err)
    print("portbench: conditions " + json.dumps(result["conditions"]),
          file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)

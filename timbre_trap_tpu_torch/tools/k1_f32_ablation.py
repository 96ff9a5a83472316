"""Where the float32 K1 stage's time goes on the card, by ablation.

    python -m timbre_trap_tpu_torch.tools.k1_f32_ablation [--turns 2]

``ncu`` does not run on the card's machine, so this builds copies of
``csrc/band_wgmma.cu`` in which one part of ``tt_band_conv_wgmma_f32`` is
changed or left out (text substitutions, ``VARIANTS``) into
``timbre_trap_tpu_torch/build/ablation/``, and times each, in turns: the
flagship base model's 60-stage float32 inference chain at (4, 1080, 1024)
(seeded random weights and input; device time under ``torch.profiler``,
5 forwards) and three stages alone with ELU and residual (3x3 at dilation
3 with 32 channels, 1x1 with 4 and with 32; CUDA events, 20 launches).
A variant that leaves work out gives wrong outputs and only says what that
work costs; each one's largest error against the plain chain, relative to
max|ref|, is printed beside its times (one that stores nothing leaves the
output as the allocator hands it over, often an earlier call's result, so
its error says nothing). Leaving the epilogue out also lets the compiler
drop the running sums' adds. Prints a line per variant and
turn, and one JSON line with the medians and the card's name and power
limit. Needs a CUDA device and ``nvcc``.
"""

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..models import TimbreTrapNet, forward_spec
from ..models.modules import init_weights
from ..ops import _build
from ..ops import fused_level as fl

_STORE = "    store_tile_f32(a, tl, warp >> 2, warp & 3, lane, run);"
_ELU = "        if (a.act) x = x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;\n"
_Y = "        a.out[out_base + (size_t)orow * a.t_len + f] = x + r[e][i];"
_FIRST = "          wgmma_tf32_first(p, al[ks], smem_desc(wh + 32 * ks, 512, 2));"
_LO_HI = "          wgmma_tf32(p, al[ks], smem_desc(wh + 32 * ks, 512, 2));"
_SMALL = ("        wgmma_tf32(p, ah[ks], smem_desc(wl + 32 * ks, 512, 2));\n"
          "        wgmma_tf32(p, ah[ks], smem_desc(wh + 32 * ks, 512, 2));\n")
_SPLIT = ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
          "  lo = __float_as_uint(x - __uint_as_float(hi));")
_RING = "constexpr int kStagesF = 3;"
_BOUNDS = "__global__ void __launch_bounds__(kThreadsF, 2)"
_PRODUCE = ("  const uint32_t bytes = kXBoxF + a.n_dt * 2 * kWBoxF;\n"
            "  for (int c = 0; c < tl.kl / kKcF; ++c) {")
_PREFETCH = """  if (a.res != nullptr && (a.t_len & 3) == 0) {
    for (int r = 0; r < min(kSub, a.r_out - tl.g * kSub); ++r) {
      const float* p = a.res + ((size_t)tl.b * a.r_out + tl.g * kSub + r) * a.t_len + tl.t0;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(p),
                   "r"(4 * min(kTileF, a.t_len - tl.t0)) : "memory");
    }
  }
"""

# name: [(text of csrc/band_wgmma.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    "no_epilogue": [(_STORE, "    if (run[0] == 1.2345e-30f)\n" + _STORE)],
    "no_elu": [(_ELU, "")],
    "no_store": [(_Y, "        if (x == 1.2345e-30f)\n" + _Y)],
    "fast_exp": [(_ELU, _ELU.replace("expf(", "__expf("))],
    "one_product": [(_FIRST, _FIRST.replace("al[ks]", "ah[ks]")),
                    (_LO_HI, _LO_HI.replace("al[ks]", "ah[ks]")),
                    (_SMALL, "")],
    "no_split": [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = 0u;")],
    "ring_2": [(_RING, _RING.replace("3", "2"))],
    "one_cta_ring_6": [(_RING, _RING.replace("3", "6")),
                       (_BOUNDS, _BOUNDS.replace("2)", "1)"))],
    "residual_l2_prefetch": [(_PRODUCE, _PRODUCE.replace(
        "  for (int c", _PREFETCH + "  for (int c"))],
}

_ENTRY = "tt_band_conv_wgmma_f32"


def _build_variants(names):
    """Compile each variant in parallel; returns {name: ctypes entry}."""
    src = (_build._CSRC / "band_wgmma.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: csrc/band_wgmma.cu no "
                                   f"longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build._FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")), _ENTRY)
        fn.argtypes = _build._SIGNATURES["band_wgmma"][_ENTRY]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _device_ms(fn, reps=5):
    """Device milliseconds a call: the CUDA kernels' time under
    ``torch.profiler`` over ``reps`` calls after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0.0)
                for e in prof.key_averages())
    return total / reps / 1e3


def _event_ms(fn, reps=20):
    """Mean milliseconds a call by CUDA events, after two warm-up calls."""
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_f32_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = _build_variants(list(VARIANTS))
    net = init_weights(TimbreTrapNet(540, 128, 2),
                       torch.Generator().manual_seed(0)).cuda().eval()
    spec = forward_spec(net, True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.3 * torch.randn((4, 1080, 1024), generator=gen, device="cuda")
    picks = {}
    for cb in spec.convs():
        if not cb.per_block and cb.f_out == cb.f_in:
            kind = "1x1" if len(cb.dts) == 1 else f"3x3 d={max(cb.dts)}"
            picks.setdefault(f"{kind} c{cb.c_out}", cb)
    stages = {}
    for name in ("3x3 d=3 c32", "1x1 c4", "1x1 c32"):
        cb = picks[name]
        stages[name] = (cb, torch.randn((4, cb.r_in, 1024), generator=gen,
                                        device="cuda"),
                        torch.randn((4, cb.r_out, 1024), generator=gen,
                                    device="cuda"))
    real = _build.load
    times = {name: {"chain_ms": [], **{s: [] for s in stages}}
             for name in fns}
    errs = {}
    try:
        with torch.no_grad():
            ref = fl.packed_level_apply(x, spec, torch.float32)
            scale = ref.abs().max().item()
            for turn in range(args.turns):
                for name, fn in fns.items():
                    _build.load = (lambda lib, entry, fn=fn: fn
                                   if entry == _ENTRY else real(lib, entry))
                    chain = lambda: fl.fused_level_apply(x, spec,  # noqa: E731
                                                         torch.float32)
                    errs[name] = (chain() - ref).abs().max().item() / scale
                    row = times[name]
                    row["chain_ms"].append(_device_ms(chain))
                    for s, (cb, xs, rs) in stages.items():
                        row[s].append(_event_ms(
                            lambda: fl.banded_conv(xs, cb, True, rs)))
                    print(f"turn {turn} {name:22s} chain "
                          f"{row['chain_ms'][-1]:.3f} ms (error "
                          f"{errs[name]:.1e}); " + ", ".join(
                              f"{s} {row[s][-1]:.4f}" for s in stages),
                          flush=True)
    finally:
        _build.load = real
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    median = {name: {k: sorted(v)[len(v) // 2] for k, v in row.items()}
              for name, row in times.items()}
    print(json.dumps({"card": card, "shape": list(x.shape),
                      "median_ms": median, "turns": times,
                      "max_rel_err": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

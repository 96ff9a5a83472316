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

_REGISTERS = "      store_tile_f32(a, tl, warp >> 2, warp & 3, lane, run);"
_EPILOGUE = ("    if (a.tma_epi)\n"
             "      finish_tile_f32_tma(a, tl, epi, k, warp >> 2, warp & 3, "
             "lane, run);\n"
             "    else\n" + _REGISTERS)
_COPIES = ("    if (lane == 0 && a.tma_epi) "
           "epilogue_copies_f32(a, &rmap, &ymap, epi);")
_ELU = ("        float x = run[4 * j + 2 * i + e] + bias[j][e];\n"
        "        if (a.act) x = x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;\n")
_TMA_STORE = "        if (pt.t0 + kEpiBoxT * bx < a.t_len)\n"
_RES_LOAD = "    if (a.res == nullptr) {\n      bulk_wait_read<0>();"
_PICK = "  a.tma_epi = tma_epi;"
_FIRST = "          wgmma_tf32_first(p, al[ks], smem_desc(wh + 32 * ks, 512, 2));"
_LO_HI = "          wgmma_tf32(p, al[ks], smem_desc(wh + 32 * ks, 512, 2));"
_SMALL = ("        wgmma_tf32(p, ah[ks], smem_desc(wl + 32 * ks, 512, 2));\n"
          "        wgmma_tf32(p, ah[ks], smem_desc(wh + 32 * ks, 512, 2));\n")
_SPLIT = ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
          "  lo = __float_as_uint(x - __uint_as_float(hi));")

# name: [(text of csrc/band_wgmma.cu, its replacement), ...]
VARIANTS = {
    "base": [],
    # The mainloop alone: no residual load, no epilogue.
    "no_epilogue": [
        (_EPILOGUE, "    if (run[0] == 1.2345e-30f)\n" + _REGISTERS),
        (_COPIES, "")],
    "no_elu": [(_ELU, _ELU.split("\n")[0] + "\n")],
    "no_store": [(_TMA_STORE, _TMA_STORE.replace("< a.t_len", "< 0"))],
    "no_residual_load": [(_RES_LOAD, _RES_LOAD.replace("a.res == nullptr",
                                                       "true"))],
    # The epilogue from the registers in this kernel (ring, tiles and
    # mainloop as they are): the TMA epilogue's own A/B.
    "register_epilogue": [(_PICK, "  a.tma_epi = 0;")],
    "fast_exp": [(_ELU, _ELU.replace("expf(", "__expf("))],
    "one_product": [(_FIRST, _FIRST.replace("al[ks]", "ah[ks]")),
                    (_LO_HI, _LO_HI.replace("al[ks]", "ah[ks]")),
                    (_SMALL, "")],
    "no_split": [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = 0u;")],
}

_ENTRY = "tt_band_conv_wgmma_f32"


def _build_variants(variants, entry):
    """Compile each of ``variants`` (name: substitutions in
    ``csrc/band_wgmma.cu``) in parallel; returns {name: the ctypes entry
    point ``entry`` of its library}."""
    src = (_build._CSRC / "band_wgmma.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: csrc/band_wgmma.cu no "
                                   f"longer holds {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{entry}-{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{entry}-{name}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *_build._FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{entry}-{name}.so")),
                     entry)
        fn.argtypes = _build._SIGNATURES["band_wgmma"][entry]
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


def turns_arg(doc, argv):
    """The ``--turns`` of a tool's command line (``doc``: its docstring)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    return ap.parse_args(argv).turns


def ablate(variants, entry, dtype, turns):
    """Build ``variants`` of the K1 entry point ``entry`` and time each,
    ``turns`` times in turns, on the flagship chain and three stages alone
    at ``dtype``; prints a line per variant and turn and the JSON line."""
    if not torch.cuda.is_available():
        print(f"{entry} ablation: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = _build_variants(variants, entry)
    net = init_weights(TimbreTrapNet(540, 128, 2),
                       torch.Generator().manual_seed(0)).cuda().eval()
    spec = forward_spec(net, True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (0.3 * torch.randn((4, 1080, 1024), generator=gen, device="cuda")
         ).to(dtype)
    picks = {}
    for cb in spec.convs():
        if not cb.per_block and cb.f_out == cb.f_in:
            kind = "1x1" if len(cb.dts) == 1 else f"3x3 d={max(cb.dts)}"
            picks.setdefault(f"{kind} c{cb.c_out}", cb)
    stages = {}
    for name in ("3x3 d=3 c32", "1x1 c4", "1x1 c32"):
        cb = picks[name]
        stages[name] = (cb, torch.randn((4, cb.r_in, 1024), generator=gen,
                                        device="cuda").to(dtype),
                        torch.randn((4, cb.r_out, 1024), generator=gen,
                                    device="cuda").to(dtype))
    real = _build.load
    times = {name: {"chain_ms": [], **{s: [] for s in stages}}
             for name in fns}
    errs = {}
    try:
        with torch.no_grad():
            ref = fl.packed_level_apply(x, spec, dtype).float()
            scale = ref.abs().max().item()
            for turn in range(turns):
                for name, fn in fns.items():
                    _build.load = (lambda lib, e, fn=fn: fn
                                   if e == entry else real(lib, e))
                    chain = lambda: fl.fused_level_apply(x, spec,  # noqa: E731
                                                         dtype)
                    errs[name] = ((chain().float() - ref).abs().max().item()
                                  / scale)
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
    print(json.dumps({"card": card, "entry": entry, "shape": list(x.shape),
                      "median_ms": median, "turns": times,
                      "max_rel_err": errs}))
    return 0


def main(argv=None):
    return ablate(VARIANTS, _ENTRY, torch.float32, turns_arg(__doc__, argv))


if __name__ == "__main__":
    sys.exit(main())

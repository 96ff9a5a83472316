"""How close the float32 conv chain comes to exact arithmetic on the card.

    python -m timbre_trap_tpu_torch.tools.f32_accuracy

Builds the flagship base model's 36-item inference chain (22.05 kHz, 9 x 60
bins, latent 128, complexity 2, random weights of seed 0) and, on seeded
0.3 * N(0, 1) input, holds the float32 kernel route (``banded_conv``:
split-TF32 tensor-core products) and the IEEE plain version
(``banded_conv_reference``) against the same chain in float64:

1. every item alone, at (2, 1080, T) for T = 1001 and 1024, on the input
   the plain float32 chain gives it;
2. the whole chain at (4, 1080, 1024) and (2, 1080, T) for T = 1001, 70, 1;
3. the level backward's products, conv by conv over the 8 training levels
   of the same net (with adjoints), at (2, ., 1001): dX (``banded_conv_dx``
   on the adjoint blocks, N(0, 1) cotangent) and dW, dBias
   (``banded_conv_dw``, 0.3 * N(0, 1) input, N(0, 1) cotangent), the
   split-TF32 kernels beside their IEEE plain versions;
4. the same for the four stages the families add to training, from
   flagship nets with skip connections (seed 0): the skip route's
   standalone convin 2 -> 4 and convout 4 -> 2, and the one-channel convin
   1 -> 4 and convout 4 -> 1 of Mag and MagDB.

Errors are max abs error / max|float64 result|. Prints one line per chain,
one for the backward's worst ratios, and one JSON line with every number
and the card's name and power limit. Needs a CUDA device; exits non-zero
without one.
"""

import json
import subprocess
import sys

import torch

from ..interop import hwio_params
from ..models import TimbreTrap, TimbreTrapMag
from ..models.fused import level_specs
from ..ops.fused_level import (_apply_chain, _elu, banded_conv,
                               banded_conv_dw, banded_conv_dw_reference,
                               banded_conv_dx, banded_conv_dx_reference,
                               banded_conv_reference)
from ..ops.packed_conv import packed_conv_reference


def _stage64(x, cb, act=False, residual=None):
    y = packed_conv_reference(x.double(), cb, blocks=cb.blocks.double())
    if act:
        y = _elu(y)
    return y if residual is None else y + residual.double()


_ROUTES = {"kernel": banded_conv, "ieee": banded_conv_reference}


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def _items(spec, x):
    """Each item alone against float64, on the plain chain's input."""
    out = []
    cur = x
    for i, it in enumerate(spec.items):
        if it[0] == "conv":
            args = (cur, it[1], it[2])
            ref = _stage64(*args)
            nxt = banded_conv_reference(*args)
        else:
            h = banded_conv_reference(cur, it[1], True)
            args = (h, it[2], True, cur)
            ref = _stage64(*args)
            nxt = banded_conv_reference(*args)
        errs = {k: _rel(f(*args), ref) for k, f in _ROUTES.items()}
        out.append({"item": i, "kind": it[0], **errs})
        cur = nxt
    return out


_DX = {"kernel": banded_conv_dx, "ieee": banded_conv_dx_reference}
_DW = {"kernel": banded_conv_dw, "ieee": banded_conv_dw_reference}


def _backward_convs(specs, t, gen):
    """dX, dW and dBias of every conv of ``specs`` (built with adjoints)
    alone against float64, at (2, ., t) on seeded inputs from ``gen``."""
    dev = gen.device

    def rand(rows, scale=1.0):
        return scale * torch.randn((2, rows, t), generator=gen, device=dev)

    out = []
    for li, spec in enumerate(specs):
        for ci, cb in enumerate(spec.convs()):
            adj = cb.adjoint
            c = rand(adj.r_in)
            dx64 = packed_conv_reference(c.double(), adj,
                                         blocks=adj.blocks.double())
            x, dz = rand(cb.r_in, 0.3), rand(cb.r_out)
            dw64, db64 = banded_conv_dw_reference(dz.double(), x.double(), cb)
            dws = {k: f(dz, x, cb) for k, f in _DW.items()}
            out.append({
                "level": li, "conv": ci,
                "dx": {k: _rel(f(c, adj, torch.float32)[0], dx64)
                       for k, f in _DX.items()},
                "dw": {k: _rel(v[0], dw64) for k, v in dws.items()},
                "dbias": {k: _rel(v[1], db64) for k, v in dws.items()}})
    return out


def variant_stage_specs(device=None):
    """{name: one-conv training spec} of the stages the families add: the
    first encoder and last decoder spec of flagship base and Mag nets with
    skip connections (seed 0), built with adjoints."""
    out = {}
    for cls, tag in ((TimbreTrap, ""), (TimbreTrapMag, "-mag")):
        net = cls(22050, 9, 60, 3, latent_size=128, model_complexity=2,
                  skip_connections=True, seed=0, device=device).net
        with torch.no_grad():
            especs, dspecs = level_specs(hwio_params(net), net, True)
        out[f"convin{tag}"], out[f"convout{tag}"] = especs[0], dspecs[-1]
    return out


def _worst_ratio(convs, what):
    return max(e[what]["kernel"] / max(e[what]["ieee"], 1e-30)
               for e in convs)


def main():
    if not torch.cuda.is_available():
        print("f32_accuracy: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = TimbreTrap(22050, 9, 60, 3, latent_size=128, model_complexity=2,
                       seed=0)
    spec = model._spec(True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(b, t):
        return 0.3 * torch.randn((b, spec.r_in, t), generator=g, device="cuda")

    with torch.no_grad():
        items = {t: _items(spec, rand(2, t)) for t in (1001, 1024)}
        chains = {}
        for b, t in ((4, 1024), (2, 1001), (2, 70), (2, 1)):
            x = rand(b, t)
            ref = _apply_chain(x.double(), spec, torch.float64, _stage64)
            chains[f"({b}, {spec.r_in}, {t})"] = {
                k: _rel(_apply_chain(x, spec, torch.float32, f), ref)
                for k, f in _ROUTES.items()}
        especs, dspecs = level_specs(hwio_params(model.net), model.net, True)
        convs = _backward_convs(especs + dspecs, 1001, g)
        stage_specs = variant_stage_specs()
        stages = dict(zip(stage_specs, _backward_convs(
            list(stage_specs.values()), 1001, g)))
    ratio = max(e["kernel"] / e["ieee"] for v in items.values() for e in v)
    for shape, e in chains.items():
        print(f"chain {shape} vs float64: kernel {e['kernel']:.3e}, IEEE "
              f"{e['ieee']:.3e} of max|ref|")
    print(f"items: kernel at most {ratio:.2f}x the IEEE error")
    worst = {w: _worst_ratio(convs, w) for w in ("dx", "dw", "dbias")}
    print(f"backward, {len(convs)} convs: kernel at most "
          + ", ".join(f"{v:.2f}x" + f" ({w})" for w, v in worst.items())
          + " the IEEE error; largest kernel errors "
          + ", ".join(f"{w} {max(e[w]['kernel'] for e in convs):.3e}"
                      for w in worst))
    worst_stages = {w: _worst_ratio(stages.values(), w)
                    for w in ("dx", "dw", "dbias")}
    print("the families' stages (" + ", ".join(stages) + "): kernel at most "
          + ", ".join(f"{v:.2f}x ({w})" for w, v in worst_stages.items())
          + " the IEEE error")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "chains": chains,
                      "worst_item_ratio": ratio, "items": items,
                      "backward_worst_ratio": worst,
                      "backward_convs": convs,
                      "variant_stages_worst_ratio": worst_stages,
                      "variant_stages": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

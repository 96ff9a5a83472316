"""The quality probe's spread over initial weights, on the card.

    python -m timbre_trap_tpu_torch.tools.quality_spread [--seeds 0 1 2]

Runs ``eval.quality_f1`` at each of ``bench.py``'s frozen probe
configurations (``eval.quality.BENCH_PROBES``) on the flagship model
(22.05 kHz, 9 x 60 bins, 3-s blocks, latent 128, complexity 2), once from
the port's seeded weights (``TimbreTrap(seed=s)``, torch's generator) and
once from the JAX package's (``models.flax_init.jax_package_params``, the
weights of the JAX package's ``TimbreTrap(seed=s)``), for every seed.
Prints one JSON line a run (F1 and wall seconds), then the card's name
and power limit. The probe's F1 depends on where training starts; this
separates that spread from the port's numerics.
"""

import argparse
import json
import subprocess
import time

import torch

from ..eval.quality import BENCH_PROBES, quality_f1
from ..interop import hwio_params
from ..models import TimbreTrap
from ..models.flax_init import jax_package_params

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = p.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rows = []
    for seed in args.seeds:
        for init in ("port", "jax_package"):
            for probe, kw in BENCH_PROBES.items():
                model = TimbreTrap(22050, 9, 60, 3, latent_size=128,
                                   model_complexity=2, seed=seed)
                if init == "jax_package":
                    model.load_jax_params(jax_package_params(
                        hwio_params(model.net), seed))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f1 = quality_f1(model, **kw)
                torch.cuda.synchronize()
                rows.append(dict(seed=seed, init=init, probe=probe, f1=f1,
                                 wall_s=time.perf_counter() - t0))
                print(json.dumps(rows[-1]), flush=True)
                del model
                torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"quality_spread": rows, "card": card}))
    return rows


if __name__ == "__main__":
    main()

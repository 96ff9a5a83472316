"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Loads, warms up, measures for ``--seconds``, checks against the plain
reference and prints one JSON line last: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window. Exits non-zero, printing no
result, without a CUDA device, or when a JAX module is loaded.

Kernel builds stay inside the checkout: the port builds its libraries
into ``timbre_trap_tpu_torch/build/``.
"""

import argparse
import os
import sys

# The port needs no JAX: keep libraries that could load it from doing so.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: the cell needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2

    from . import bench, program

    result = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), program)
    found = bench.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    bench.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The command-line entry points of the port, run as modules:

    python -m timbre_trap_tpu_torch.experiments.train ...
    python -m timbre_trap_tpu_torch.experiments.evaluate ...
    python -m timbre_trap_tpu_torch.experiments.sonify ...

Each takes the arguments and defaults of its counterpart in the JAX
package's ``experiments/`` and one more, ``--device``: the card unless
``--device cpu`` is given (the kernels' plain versions then run). Each
module's ``main(argv)`` takes the argument list, so Python callers drive the
same code the command line does.
"""

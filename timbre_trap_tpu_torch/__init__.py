"""timbre_trap_tpu_torch — the PyTorch/CUDA port of timbre_trap_tpu.

The same sliCQ transform (native and ``cqt_pytorch`` compat frames,
analysis and synthesis), Timbre-Trap model families (base, FiLM, Mag,
MagDB, with or without skip connections) and their persistence, streaming
``transcribe`` and ``reconstruct``, the training step and the Trainer with
its data pipeline, and ``evaluate`` with its metrics as the JAX package,
run on an NVIDIA Hopper GPU: the conv chain, its backward and the peak mask
go through kernels written by hand for ``sm_90a`` (``csrc/``), each with a
plain PyTorch twin that the CPU takes.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``). This package never imports JAX nor the JAX package.
"""

__version__ = "0.1.0"

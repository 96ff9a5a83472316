"""The benchmark of the PyTorch and CUDA port (``timbre_trap_tpu_torch``).

Run a cell with ``python3 -m portbench.run``; see ``run.py``.
"""

"""Measurement scripts of the port; each runs on the card as
``python -m timbre_trap_tpu_torch.tools.<name>``."""

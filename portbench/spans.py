"""The port's span record, as the per-layer metrics of source
``program_span`` read it.

The record is taken from the port's profiling module where the run has
loaded it (``program.py`` stays the only module here that imports the
port); a program that keeps no span record gives None, and so does a
span it did not record.
"""

import sys

__all__ = ["MODULE", "record", "get"]

MODULE = "timbre_trap_tpu_torch.utils.profiling"


def record():
    """{span: {"count", "items", "total_s", "self_s"}} of the traced
    window, or None where the program keeps no span record."""
    read = getattr(sys.modules.get(MODULE), "record", None)
    return None if read is None else read()


def get(name):
    """The record's entry of span ``name``, or None."""
    rec = record()
    return None if rec is None else rec.get(name)

"""Reference-taxonomy aliases (timbre_trap.datasets.AudioStems)."""

from ..medleydb import MedleyDBStems as MedleyDB

__all__ = ["MedleyDB"]

"""Reference-taxonomy aliases (timbre_trap.datasets.AudioMixtures)."""

from ..medleydb import MedleyDBMixtures as MedleyDB
from ..fma import FMA, FMA_F, FMA_L, FMA_M, FMA_S

__all__ = ["MedleyDB", "FMA", "FMA_F", "FMA_L", "FMA_M", "FMA_S"]

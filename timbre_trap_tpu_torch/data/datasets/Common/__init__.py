"""Reference-taxonomy aliases (timbre_trap.datasets.Common equivalents)."""

from ..urmp import URMPCommon as URMP
from ..bach10 import Bach10Common as Bach10
from ..trios import TRIOSCommon as TRIOS
from ..medleydb import MedleyDBCommon as MedleyDB
from ..musicnet import MusicNetCommon as MusicNet

__all__ = ["URMP", "Bach10", "TRIOS", "MedleyDB", "MusicNet"]

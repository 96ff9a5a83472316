"""Reference-taxonomy aliases (timbre_trap.datasets.SoloMultiPitch)."""

from ..urmp import URMPStems as URMP
from ..bach10 import Bach10Stems as Bach10
from ..trios import TRIOSStems as TRIOS
from ..maestro import MAESTRO
from ..guitarset import GuitarSet
from ..medleydb import MedleyDB_Pitch, MedleyDB_Stem_Synth
from ..musicnet import MusicNetSolo as MusicNet

__all__ = ["URMP", "Bach10", "TRIOS", "MAESTRO", "GuitarSet",
           "MedleyDB_Pitch", "MedleyDB_Stem_Synth", "MusicNet"]

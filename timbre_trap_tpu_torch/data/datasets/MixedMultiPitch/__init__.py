"""Reference-taxonomy aliases (timbre_trap.datasets.MixedMultiPitch)."""

from ..urmp import URMPMixtures as URMP
from ..bach10 import Bach10Mixtures as Bach10
from ..su import Su
from ..trios import TRIOSMixtures as TRIOS
from ..musicnet import MusicNetMixtures as MusicNet

__all__ = ["URMP", "Bach10", "Su", "TRIOS", "MusicNet"]

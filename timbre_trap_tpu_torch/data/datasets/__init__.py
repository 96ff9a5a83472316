"""Concrete dataset zoo (17 wrappers over 9 corpora): the port's copy of
``timbre_trap_tpu/data/datasets``, over the port's ``BaseDataset``,
``MPEDataset`` and ``AudioDataset`` (an MPE wrapper takes the port's ``CQT``
as ``cqt=``).

Two access styles:
* flat: ``from timbre_trap_tpu_torch.data.datasets import URMPMixtures``
* reference taxonomy:
  ``from timbre_trap_tpu_torch.data.datasets.MixedMultiPitch import URMP``
  — mirrors ``timbre_trap.datasets.MixedMultiPitch`` etc.

Importing the package needs no PyYAML: the MedleyDB wrappers import it
where they read their multitrack metadata.
"""

from .urmp import URMPCommon, URMPMixtures, URMPStems
from .bach10 import Bach10Common, Bach10Mixtures, Bach10Stems
from .su import Su
from .trios import TRIOSCommon, TRIOSMixtures, TRIOSStems
from .maestro import MAESTRO
from .guitarset import GuitarSet
from .medleydb import (MedleyDBCommon, MedleyDBMixtures, MedleyDBStems,
                       MedleyDB_Pitch, MedleyDB_Stem_Synth)
from .fma import FMA, FMA_F, FMA_L, FMA_M, FMA_S
from .musicnet import MusicNetCommon, MusicNetMixtures, MusicNetSolo

__all__ = [
    "URMPCommon", "URMPMixtures", "URMPStems",
    "Bach10Common", "Bach10Mixtures", "Bach10Stems",
    "Su",
    "TRIOSCommon", "TRIOSMixtures", "TRIOSStems",
    "MAESTRO",
    "GuitarSet",
    "MedleyDBCommon", "MedleyDBMixtures", "MedleyDBStems",
    "MedleyDB_Pitch", "MedleyDB_Stem_Synth",
    "FMA", "FMA_F", "FMA_L", "FMA_M", "FMA_S",
    "MusicNetCommon", "MusicNetMixtures", "MusicNetSolo",
]

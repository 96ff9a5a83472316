from .calibrate import identify_transform, load_tables, save_tables
from .cqt import CQT
from .design import (SlicqPlan, design_cqt_pytorch, design_slicq, hz_to_midi,
                     midi_to_hz)

__all__ = ["CQT", "SlicqPlan", "design_slicq", "design_cqt_pytorch",
           "hz_to_midi", "midi_to_hz", "identify_transform", "save_tables",
           "load_tables"]

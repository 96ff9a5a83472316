from . import multipitch
from .multipitch import MAX_FREQ, MIN_FREQ, resample_multipitch
from .sdr import signal_distortion_ratio

__all__ = ["multipitch", "resample_multipitch", "signal_distortion_ratio",
           "MAX_FREQ", "MIN_FREQ"]

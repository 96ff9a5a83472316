from . import multipitch
from .multipitch import MAX_FREQ, MIN_FREQ, resample_multipitch
from .sdr import signal_distortion_ratio

__all__ = ["multipitch", "resample_multipitch", "signal_distortion_ratio",
           "MAX_FREQ", "MIN_FREQ", "evaluate", "masked_peak_estimates"]


def __getattr__(name):
    # Lazy: evaluation pulls in the data and model stacks, which use utils
    # -> eval.multipitch; deferring the import breaks the cycle.
    if name in ("evaluate", "masked_peak_estimates"):
        from . import evaluation

        return getattr(evaluation, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

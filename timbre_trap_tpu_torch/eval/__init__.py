from . import multipitch
from .multipitch import MAX_FREQ, MIN_FREQ, resample_multipitch
from .sdr import signal_distortion_ratio

__all__ = ["multipitch", "resample_multipitch", "signal_distortion_ratio",
           "MAX_FREQ", "MIN_FREQ", "evaluate", "masked_peak_estimates",
           "quality_f1", "synthesize_polyphony"]


def __getattr__(name):
    # Lazy: evaluation and quality pull in the data, model and train stacks,
    # which use utils -> eval.multipitch; deferring the import breaks the
    # cycle.
    if name in ("evaluate", "masked_peak_estimates"):
        from . import evaluation

        return getattr(evaluation, name)
    if name in ("quality_f1", "synthesize_polyphony"):
        from . import quality

        return getattr(quality, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

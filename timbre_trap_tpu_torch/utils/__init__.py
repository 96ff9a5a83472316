from .experiments import MultipitchEvaluator, print_and_log, seed_everything
from .processing import filter_non_peaks, threshold, to_array

__all__ = ["to_array", "filter_non_peaks", "threshold", "seed_everything",
           "print_and_log", "MultipitchEvaluator"]

from .experiments import (MultipitchEvaluator, average_gradient_norms,
                          enable_nan_debugging, get_max_gradient,
                          get_max_gradient_norm, log_gradient_norms,
                          print_and_log, seed_everything, sum_gradient_norms)
from .processing import debug_nans, filter_non_peaks, threshold, to_array

__all__ = ["to_array", "debug_nans", "filter_non_peaks", "threshold",
           "seed_everything", "print_and_log", "enable_nan_debugging",
           "sum_gradient_norms", "average_gradient_norms", "get_max_gradient",
           "get_max_gradient_norm", "log_gradient_norms",
           "MultipitchEvaluator"]

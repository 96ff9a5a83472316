"""Shared data-pipeline constants: the port's copy of
``timbre_trap_tpu/data/constants.py`` (reference: timbre_trap/utils/data.py:20-25)."""

import os

DEFAULT_LOCATION = os.path.join(os.path.expanduser("~"), "Desktop", "Datasets")
KEY_TRACK = "track"
KEY_AUDIO = "audio"
KEY_TIMES = "times"
KEY_GROUND_TRUTH = "ground-truth"

"""The benchmark's own tests: CPU tests at a small geometry, and tests
marked ``cuda`` that skip where there is no card."""

import os
import sys

# Import ``portbench`` from the checkout these tests sit in.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where "
        "torch.cuda.is_available() is False")

"""The benchmark's own tests run from this folder (``python -m pytest
perfbench/tests``): put the checkout on the path, and register the
marker of tests that need a card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")

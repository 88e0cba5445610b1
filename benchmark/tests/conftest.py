"""The benchmark's own tests: CPU tests of the harness, the generator,
the metric arithmetic and the reference, and card tests (marked
``cuda``) of the control.  Run from the repository root:

    python -m pytest benchmark/tests -q                     # CPU
    python -m pytest benchmark/tests -m cuda -q -o addopts=""  # on the card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"

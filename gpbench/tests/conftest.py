"""The harness's tests: ``python -m pytest gpbench/tests`` from the
repository's root; the tests marked ``cuda`` skip without a card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

"""The benchmark's own CPU tests (``python -m pytest bench/tests`` from the
repository's root).  The root and ``src`` go on the path so that ``bench``
and the program import as the benchmark imports them."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, never
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

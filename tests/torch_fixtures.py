"""Fixtures shared by the port's test modules (``test_torch_*.py``), which
import what they use."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def lists_at_every_size():
    """'auto' builds its block list at every index size
    (``params.SKIP_MIN_BLOCKS`` = 0), as it did before that threshold: the
    tests' small graphs, all below it, keep running the list path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("repro_torch.kernels.params.SKIP_MIN_BLOCKS", 0)
        yield

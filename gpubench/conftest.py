"""Settings of the harness's CPU tests."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the test workers run side by side, and
    thread pools spinning over each other's cores slow a whole run of the
    harness thirtyfold (as ``run.set_environment`` keeps the card's runs
    to one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

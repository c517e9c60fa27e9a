"""One cap on torch's intra-op threads for the port's CPU tests.

The suite runs its files in several worker processes at once, each of which
would otherwise start a pool of one thread a core: the workers' pools then
spin over each other's cores and the port's small ops wait on them. A port
test file takes the cap by importing the fixture:

    from torch_port_threads import torch_threads  # noqa: F401
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """THREADS intra-op threads while the importing module's tests run."""
    was = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(was)

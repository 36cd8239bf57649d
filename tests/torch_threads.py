"""One intra-op thread for PyTorch while a module of the port's tests runs.

The whole suite runs under pytest-xdist with six workers (`-n 6`) on the
host's cores. PyTorch's CPU ops run on an OpenMP pool of one thread per core
in every worker, and OpenMP threads spin while they wait, so six pools fight
over the cores and every parallel region waits for threads that are not
scheduled: the port's heaviest test file ran about ten times slower inside
the suite than alone, and the JAX package's files beside it slowed down too. The port's test modules
import this fixture (autouse, module scope), so each of them runs its torch
ops on one thread and gives the previous count back when it is done.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

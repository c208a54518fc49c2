"""An autouse fixture for the port's CPU tests: one torch intra-op thread
per test.

The reduced models' ops are far too small to share out, and the suite
runs several pytest workers on one machine: with a thread per core in
every worker, the threads spin against each other and a test runs many
times slower than alone.  Import the fixture into a test module to use
it; the thread count is restored after each test."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

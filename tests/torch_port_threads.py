"""A fixture for the port's CPU tests: one PyTorch thread while they run.

The suite runs in several worker processes at once; PyTorch's default of one
intra-op thread per core then oversubscribes the cores, and the small eager ops
of the env loops spend their time waiting on each other's threads (a 10 s test
took 240 s under six workers). The previous thread count is restored afterwards.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

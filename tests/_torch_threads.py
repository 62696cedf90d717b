"""One intra-op thread for the port's CPU tests. The suite runs under
several xdist workers; PyTorch's default of one thread per core in each
of them oversubscribes the CPU and disturbs the timing-based tests that
other workers run at the same time."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

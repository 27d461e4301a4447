import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs several workers at once,
    and the CPU's cores are theirs to share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

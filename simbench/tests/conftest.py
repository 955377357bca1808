import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the driver runs several test workers
    at once, and the plain replay's small ops on every core of each of
    them oversubscribe the machine (a few seconds alone, minutes so)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

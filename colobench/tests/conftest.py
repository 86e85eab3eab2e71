"""The benchmark's CPU tests: one intra-op thread a test process (the
suite runs under several workers), and tiny configurations of the
cells' models."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""Shared fixtures of the benchmark's CPU tests."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    """Several test workers share the machine: one intra-op thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

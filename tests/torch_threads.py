"""A module fixture for the port's CPU-heavy test files: importing
``one_intra_op_thread`` into a test module runs that module on one intra-op
thread. Its shapes are small, so one thread is faster alone, and the
suite's workers do not oversubscribe the cores they share."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the importing module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

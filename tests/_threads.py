"""The port's CPU tests run the plain PyTorch versions: thousands of small
ops. The suite runs several test workers on shared cores, where PyTorch's
intra-op threads only wait on each other, so each test module of the port
runs with one (`one_torch_thread`, autouse: import it into the module)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

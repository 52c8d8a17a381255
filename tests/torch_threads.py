"""The port's side of a test module on one CPU thread.

A module takes it with ``from torch_threads import one_torch_thread`` (an
autouse fixture of module scope). The tier-1 suite runs six workers on the
machine's cores, and torch's thread pool in each would oversubscribe them: at
the tests' sizes its spinning threads cost far more than they give. The
spawned ranks of tests/test_torch_distributed.py run on one thread too, so
the parent's world-1 sums follow the same order."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

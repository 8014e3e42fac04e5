"""One intra-op thread for the port's tests in this process.

The suite runs its files on several workers at once, each beside gloo
ranks and JAX subprocesses of its own, on a machine with few cores;
PyTorch's default of one intra-op thread a core then oversubscribes it,
and its threads wait on each other for most of each step.  Every
``tests/test_torch_*.py`` imports ``one_thread``, an autouse fixture of
module scope: the module's tests run on one thread, and the setting is
restored after them.  A reduction may round in another order on one
thread: every bar is a tolerance, or holds two runs of this process
against each other."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

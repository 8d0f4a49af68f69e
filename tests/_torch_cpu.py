"""One torch thread in each test process for the port's test files.

The suite runs in several worker processes at once (pytest-xdist), and
torch's default of one intra-op thread per core in each of them
oversubscribes the cores: the port's small CPU ops then spin-wait, and a
file that takes 80 s alone took over ten times that beside five other
workers.  With one thread a file takes as long alone as before.  Each
port test file imports this fixture; it restores the count after the
file's tests."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

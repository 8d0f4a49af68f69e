import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(_ROOT, "src"), _ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test process, as a run has: the port's small ops
    spin-wait when the workers' thread pools oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, for tests marked ``gpu``; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(cell):
    """A cell cut to a size the CPU runs in seconds: K=4 clients of 20
    samples; a sweep of 2 V values over 3 rounds."""
    cell.traffic.update(K=4, n_samples=100)
    if cell.traffic["driver"] == "v_grid":
        cell.traffic.update(rounds=3, V_grid=[0.01, 100.0])
    if "rows" in cell.check["check"]:
        cell.check["check"].update(rows=1, judged_rounds=1)
    return cell

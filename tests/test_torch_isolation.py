"""The port stands alone: it imports neither ``jax`` nor the JAX package,
never runs on the CPU unless asked, and launches its kernels only on CUDA
tensors.  Tests that need a card carry the ``gpu`` marker and skip here
(run them on a card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_isolation.py``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.fl.runtime import MFLExperiment
from repro_torch.kernels.fusion_loss import ops, ref

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MFLExperiment("crema_d", K=4, n_samples=80)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_run_never_launches_a_kernel():
    ops.reset_launch_counts()
    exp = MFLExperiment("crema_d", K=3, n_samples=60, device="cpu",
                        engine="batched:seq+pallas")
    exp.run(1)
    assert exp.history[0].participants
    assert ops.launch_counts() == {"fusion_loss_fwd": 0,
                                   "fusion_loss_bwd": 0,
                                   "fusion_loss_reduce": 0}


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    """Forward and backward kernels against the plain version on the card,
    broadcast head included, float32 tolerances (another summation order)."""
    rng = np.random.default_rng(0)
    K, T, V, S = 3, 16, 37, 4
    seg = (0, 0, S)
    lg = [torch.as_tensor(rng.normal(size=(K, T // s if s else T, V)),
                          dtype=torch.float32, device="cuda") for s in seg]
    labels = torch.as_tensor(rng.integers(0, V, (K, T)), device="cuda")
    avail = torch.as_tensor((rng.random((3, K, 1)) < 0.7)
                            .astype(np.float32), device="cuda").expand(3, K, T)
    df = torch.randn(K, T, device="cuda")
    dm = torch.randn(3, K, T, device="cuda")
    ops.reset_launch_counts()
    out = ops.fusion_loss_fwd(lg, labels, avail, seg)
    dl, gsq, gdot = ops.fusion_loss_bwd(lg, labels, avail, df, dm, out[3],
                                        out[5], seg)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"fusion_loss_fwd": 1,
                                   "fusion_loss_bwd": 1,
                                   "fusion_loss_reduce": 1}
    stack = ops._plain_stack(lg, seg)
    for got, want in zip(out, ref.fusion_loss_ref(stack, labels, avail,
                                                  save_residuals=True)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    d, sq, dot = ref.fusion_loss_ref_grads(stack, labels, avail, df, dm)
    for m in range(3):
        torch.testing.assert_close(dl[m], d[m], rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(gsq, sq.T, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gdot, dot.T, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_card_run_goes_through_the_kernels(cuda):
    ops.reset_launch_counts()
    MFLExperiment("crema_d", K=4, n_samples=160).run(1)
    counts = ops.launch_counts()
    assert counts["fusion_loss_fwd"] > 0 and counts["fusion_loss_bwd"] > 0
    # the training step reads no gsq/gdot, so it launches no reduce
    assert counts["fusion_loss_reduce"] == 0

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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fusion_loss import ops, ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import layers, mamba2

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
    assert n_modules >= 35


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_entry_points_raise_without_cuda(no_cuda):
    for arch in ("lstm-cnn", "transformer", "ssd"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MFLExperiment("crema_d", K=4, n_samples=80, arch=arch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    assert resolve_device("cpu") == torch.device("cpu")


def _reset_all():
    for m in (ops, fa_ops, ssd_ops):
        m.reset_launch_counts()


def _all_counts():
    return {**ops.launch_counts(), **fa_ops.launch_counts(),
            **ssd_ops.launch_counts()}


@pytest.mark.parametrize("arch", ["lstm-cnn", "transformer", "ssd"])
def test_cpu_run_never_launches_a_kernel(arch):
    _reset_all()
    exp = MFLExperiment("crema_d", K=3, n_samples=60, device="cpu",
                        engine="batched:seq+pallas", arch=arch)
    exp.run(1)
    assert exp.history[0].participants
    assert _all_counts() == {"fusion_loss_fwd": 0, "fusion_loss_bwd": 0,
                             "fusion_loss_reduce": 0,
                             "flash_attention_fwd": 0, "ssd_chunk_fwd": 0}


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


#: (B, H, KH, S, hd, window, dtype): the training path's heads at S=32 and
#: S=24, GQA, windows and the JAX sweep's widest case
ATTN_CARD_CASES = [
    (96, 4, 4, 32, 8, None, torch.float32),
    (96, 4, 4, 24, 8, None, torch.float32),
    (2, 8, 2, 256, 64, 64, torch.float32),
    (1, 2, 1, 512, 128, 128, torch.float32),
    (2, 4, 2, 100, 32, 17, torch.float32),
    (2, 4, 4, 256, 32, None, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,hd,win,dtype", ATTN_CARD_CASES)
def test_flash_attention_kernel_matches_plain_on_card(cuda, B, H, KH, S, hd,
                                                      win, dtype):
    """The kernel against its plain version on the same card inputs, both in
    the model layout and as a strided view of the [B, H, S, hd] layout:
    float32 to 2e-5 (another summation order), bfloat16 to 3e-2 (the JAX
    sweep's tolerances)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(s, device="cuda", generator=g).to(dtype)
               for s in ((B, H, S, hd), (B, KH, S, hd), (B, KH, S, hd)))
    fa_ops.reset_launch_counts()
    got = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window=win)
    got2 = fa_ops.flash_attention(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), window=win)
    torch.cuda.synchronize()
    assert fa_ops.launch_counts() == {"flash_attention_fwd": 2}
    assert got.dtype == dtype
    want = fa_ref.attention_ref(q, k, v, window=win).transpose(1, 2)
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=3e-2, atol=3e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, got2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,Q,nh,hp,N", [
    (96, 4, 8, 8, 8, 16), (96, 3, 8, 8, 8, 16),       # the training path
    (1, 2, 64, 2, 32, 16), (2, 4, 32, 4, 16, 8), (1, 1, 128, 8, 64, 32),
])
def test_ssd_chunk_kernel_matches_plain_on_card(cuda, B, nc, Q, nh, hp, N):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, nc, Q, nh, hp), device="cuda", generator=g)
    cum = torch.cumsum(-torch.rand((B, nc, Q, nh), device="cuda",
                                   generator=g) * 0.1, dim=2)
    Bm, Cm = (torch.randn((B, nc, Q, N), device="cuda", generator=g)
              for _ in range(2))
    ssd_ops.reset_launch_counts()
    y, st = ssd_ops.ssd_chunk(x, cum, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_ops.launch_counts() == {"ssd_chunk_fwd": 1}
    yw, sw = ssd_ref.ssd_chunk_ref(x, cum, Bm, Cm)
    torch.testing.assert_close(y, yw, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sw, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ssd_chunk_kernel_refuses_a_chunk_too_large(cuda):
    x = torch.zeros((1, 1, 256, 1, 64), device="cuda")
    cum = torch.zeros((1, 1, 256, 1), device="cuda")
    b = torch.zeros((1, 1, 256, 32), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.ssd_chunk(x, cum, b, b)


@pytest.mark.gpu
def test_kernel_autograd_functions_match_plain_on_card(cuda):
    """Kernel forward + recompute backward against plain autograd on the
    card, at a training-path shape."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((40, 24, 4, 8), device="cuda", generator=g)
               for _ in range(3))
    x = torch.randn((40, 32, 8, 8), device="cuda", generator=g)
    dt = torch.rand((40, 32, 8), device="cuda", generator=g) * 0.1 + 0.01
    A = -torch.rand((40, 8), device="cuda", generator=g) - 0.1
    Bm, Cm = (torch.randn((40, 32, 16), device="cuda", generator=g)
              for _ in range(2))
    for kern, plain, ins, tol in (
            (lambda *a: layers.pallas_attention(*a, None, 24),
             lambda *a: layers.chunked_attention(*a, window=None, chunk=24),
             (q, k, v), dict(rtol=2e-5, atol=2e-5)),
            (lambda *a: mamba2.ssd_pallas(*a, 8),
             lambda *a: mamba2.ssd_chunked(*a, 8), (x, dt, A, Bm, Cm),
             dict(rtol=1e-4, atol=1e-4))):
        outs = []
        for fn in (kern, plain):
            ts = [t.clone().requires_grad_() for t in ins]
            o = fn(*ts)
            o.square().sum().backward()
            outs.append((o.detach(), [t.grad for t in ts]))
        (o1, g1), (o2, g2) = outs
        torch.testing.assert_close(o1, o2, **tol)
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernel", [("transformer",
                                          "flash_attention_fwd"),
                                         ("ssd", "ssd_chunk_fwd")])
def test_card_backbone_round_goes_through_the_kernels(cuda, arch, kernel):
    _reset_all()
    MFLExperiment("crema_d", K=4, n_samples=160, arch=arch).run(1)
    counts = _all_counts()
    assert counts[kernel] > 0
    assert counts["fusion_loss_fwd"] > 0 and counts["fusion_loss_bwd"] > 0

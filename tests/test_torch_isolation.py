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
    # the short regime's edges: ragged S, GQA with a window, hd 16 and 32,
    # two warps a head (S=64), bfloat16
    (7, 4, 4, 24, 8, None, torch.bfloat16),
    (3, 8, 2, 48, 16, 5, torch.float32),
    (5, 4, 2, 24, 16, None, torch.float32),
    (5, 2, 2, 64, 32, None, torch.float32),
    (3, 8, 2, 40, 32, 9, torch.bfloat16),
    # the long regime's edges in bfloat16 (tensor cores): ragged S with GQA
    # and a window, hd 128, S just past the short regime, 32-key tiles with
    # four key splits (S=128); hd 16 in float32
    (2, 4, 2, 100, 32, 17, torch.bfloat16),
    (1, 2, 1, 512, 128, 128, torch.bfloat16),
    (2, 8, 2, 65, 64, None, torch.bfloat16),
    (1, 4, 2, 128, 64, None, torch.bfloat16),
    (2, 4, 4, 130, 16, None, torch.float32),
    # the generic regime: hd 8 past S=64, hd 256
    (2, 4, 4, 200, 8, None, torch.float32),
    (1, 2, 1, 96, 256, None, torch.bfloat16),
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
    # the JAX configs' chunk: mamba2-370m (N=128) and jamba (N=16)
    (1, 1, 256, 2, 64, 128), (1, 1, 256, 2, 64, 16),
    # small regime: a batch that is not a multiple of the block's group,
    # hp not a multiple of 4, Q=32; large regime: ragged tiles (Q=96), hp
    # 8 and 128, and a small chunk whose heads do not fit one block (the
    # sweep's (2, 4, 32, ...) above runs there too: few chunks)
    (961, 4, 8, 8, 8, 16), (3, 2, 16, 3, 6, 5), (32, 4, 32, 4, 16, 8),
    (2, 2, 96, 2, 8, 12),
    (1, 2, 64, 2, 128, 20), (1, 1, 32, 64, 64, 16),
    # small regime with run-time divisors (hp 12, nh 3) and with powers of
    # two at hp 2; large regime at hp and N not multiples of 4, hp 48 (a
    # part-filled column tile) and hp 256 (two column tiles)
    (50, 2, 16, 3, 12, 8), (40, 2, 16, 3, 6, 5), (80, 1, 8, 2, 2, 4),
    (1, 1, 64, 2, 64, 6), (1, 2, 96, 3, 6, 5), (1, 1, 256, 2, 48, 16),
    (1, 1, 64, 2, 256, 16),
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
def test_ssd_chunk_kernel_takes_a_256_token_chunk(cuda):
    """The chunk an earlier kernel refused (its Q×Q scores outgrew a block's
    shared memory) now goes through the large regime and matches the plain
    version."""
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, 1, 256, 1, 64), device="cuda", generator=g)
    cum = torch.cumsum(-torch.rand((1, 1, 256, 1), device="cuda",
                                   generator=g) * 0.1, dim=2)
    Bm, Cm = (torch.randn((1, 1, 256, 32), device="cuda", generator=g)
              for _ in range(2))
    assert ssd_ops.plan(1, 1, 256, 1, 64, 32).regime == "large"
    y, st = ssd_ops.ssd_chunk(x, cum, Bm, Cm)
    yw, sw = ssd_ref.ssd_chunk_ref(x, cum, Bm, Cm)
    torch.testing.assert_close(y, yw, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sw, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_python_plans_match_the_kernels_shared_memory(cuda):
    """The wrappers' shared-memory sizes (which decide the regime) equal
    the C side's for every regime they plan."""
    from repro_torch.kernels.flash_attention.build import load as fa_load
    from repro_torch.kernels.ssd_scan.build import load as ssd_load
    for B, nc, Q, nh, hp, N in [(960, 4, 8, 8, 8, 16), (240, 4, 8, 8, 8, 16),
                                (1, 1, 256, 2, 64, 128),
                                (1, 1, 128, 8, 64, 32), (3, 2, 16, 3, 6, 5),
                                (40, 2, 16, 3, 6, 5), (1, 1, 64, 2, 256, 6)]:
        p = ssd_ops.plan(B, nc, Q, nh, hp, N)
        assert ssd_load().ssd_chunk_smem_bytes(
            ssd_ops.REGIMES[p.regime], p.group, Q, nh, hp, N) == p.smem
    for B, S, H, KH, hd in [(960, 32, 4, 4, 8), (3, 48, 8, 2, 16),
                            (1, 512, 2, 1, 128), (2, 200, 4, 4, 8)]:
        for dt, code in fa_ops._DTYPES.items():
            p = fa_ops.plan(B, S, H, KH, hd, dt)
            assert fa_load().flash_attention_smem_bytes(
                fa_ops.REGIMES[p.regime], code, S, hd, p.c_arg,
                H // KH, p.key_tile) == p.smem


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

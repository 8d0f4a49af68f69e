"""The port stands alone: it imports neither ``jax`` nor the JAX package,
never runs on the CPU unless asked, and launches its kernels only on CUDA
tensors.  Tests that need a card carry the ``gpu`` marker and skip here
(run them on a card with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_isolation.py``)."""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro_torch.convert import params_from_numpy
from repro_torch.core.trees import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.fl.runtime import MFLExperiment
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fusion_loss import ops, ref
from repro_torch.kernels.jcsba_solver import ops as solver_ops
from repro_torch.kernels.jcsba_solver.checks import (antibody_rows,
                                                     plain_versions,
                                                     synthetic_round)
from repro_torch.kernels.jcsba_solver import ref as solver_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import layers, mamba2
from repro_torch.wireless.schedulers import make_scheduler

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
# the scenario library's functions import lazily: run them too
from repro_torch.data.scenarios import ScenarioSpec, stack_scenarios
from repro_torch.wireless.params import WirelessParams
assert "repro_torch.data.scenarios" in names
grid = stack_scenarios([ScenarioSpec(K=4, n_per_client=2, n_test=4, seed=s,
                                     split=sp)
                        for s, sp in enumerate(("iid", "natural"))],
                       WirelessParams(K=4))
assert grid.store_row(1).K == 4 and grid.overrides["V"].shape == (2,)
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
    assert n_modules >= 39


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
    # the default engine (JCSBA on the torch solver) and the baselines
    for sched in ("jcsba", "random", "dropout"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MFLExperiment("crema_d", scheduler=sched, K=4, n_samples=80,
                          device="cuda", engine="batched:pallas")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_scheduler(sched, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    assert resolve_device("cpu") == torch.device("cpu")


def _reset_all():
    for m in (ops, fa_ops, ssd_ops, solver_ops):
        m.reset_launch_counts()


def _all_counts():
    return {**ops.launch_counts(), **fa_ops.launch_counts(),
            **ssd_ops.launch_counts(), **solver_ops.launch_counts()}


@pytest.mark.parametrize("arch", ["lstm-cnn", "transformer", "ssd"])
def test_cpu_run_never_launches_a_kernel(arch):
    """The default engine on the CPU: the JCSBA solve and the cohort step
    run their plain versions and launch no kernel."""
    _reset_all()
    exp = MFLExperiment("crema_d", K=3, n_samples=60, device="cpu",
                        engine="batched:pallas", arch=arch,
                        scheduler_kwargs={"immune_kwargs": {"S": 6, "G": 2}})
    exp.run(1)
    assert exp.history[0].participants
    assert _all_counts() == {"fusion_loss_fwd": 0, "fusion_loss_bwd": 0,
                             "fusion_loss_reduce": 0,
                             "flash_attention_fwd": 0, "ssd_chunk_fwd": 0,
                             "jcsba_bmin_kernel": 0,
                             "jcsba_population_kernel": 0}


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
    _reset_all()
    MFLExperiment("crema_d", K=4, n_samples=160).run(1)
    counts = _all_counts()
    assert counts["fusion_loss_fwd"] > 0 and counts["fusion_loss_bwd"] > 0
    # the training step reads no gsq/gdot, so it launches no reduce
    assert counts["fusion_loss_reduce"] == 0
    # one B_min, pop0 + 2 a generation + the winner's B (default hp)
    assert counts["jcsba_bmin_kernel"] == 1
    assert counts["jcsba_population_kernel"] == 1 + 2 * 10 + 1


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
#: (K, T, V, M, seg, dtype, element offset of each operand, regime and,
#: for the group regime, the forward's threads a row): the
#: paper's shapes, each regime's edges (V = 1, 12, 16, 17, 31, 32, 33, 37, 64,
#: the rows regime's reach depending on the rows of a call), rows not a
#: multiple of a block, broadcast heads in each regime, M = 1 and 4, all
#: three operand types, and operands that start off a 16-byte boundary,
#: alike (read in 16-byte pieces after a scalar head) or not (scalar loads)
FUSION_CARD_CASES = [
    (10, 96, 6, 2, (0, 0), F32, (0, 0), "rows"),
    (10, 96, 10, 2, (0, 0), BF16, (0, 0), "rows"),
    (3, 50, 1, 1, (0,), F32, (0,), "rows"),
    (2, 70, 12, 4, (0, 0, 0, 0), F16, (1, 0, 3, 1), "rows"),
    (10, 96, 16, 2, (0, 0), BF16, (0, 1), "rows"),
    (10, 96, 17, 2, (0, 0), F32, (0, 0), "group/32"),
    (40, 130, 31, 4, (0, 0, 0, 0), F16, (1, 0, 3, 1), "rows"),
    (40, 128, 32, 3, (0, 0, 8), F32, (0, 0, 0), "rows"),
    (64, 64, 64, 2, (0, 0), BF16, (0, 0), "rows"),
    (200, 128, 20, 2, (0, 0), F32, (0, 0), "rows"),
    (2, 70, 31, 4, (0, 0, 0, 0), F16, (1, 0, 3, 1), "group/32"),
    (4, 40, 32, 3, (0, 0, 8), F32, (0, 0, 0), "group/32"),
    (5, 33, 33, 2, (0, 11), BF16, (0, 0), "group/32"),
    (3, 16, 37, 3, (0, 0, 4), F32, (1, 2, 3), "group/32"),
    (2, 24, 100, 4, (0, 0, 0, 0), F16, (0, 0, 0, 0), "group/32"),
    (1, 128, 1024, 1, (0,), BF16, (0,), "group/256"),
    (1, 64, 4096, 3, (0, 0, 0), F32, (3, 3, 3), "group/256"),
    (1, 32, 32000, 3, (0, 0, 8), BF16, (0, 0, 0), "group/256"),
    (2, 8, 5000, 2, (0, 2), F16, (0, 0), "group/256"),
    (1, 16, 4097, 2, (0, 0), F32, (1, 1), "group/256"),
]


def _fusion_card_case(K, T, V, M, seg, dtype, offs, seed=0):
    """Logits of ``dtype`` on the card, each a contiguous view that starts
    ``offs[m]`` elements into its storage; labels, avail with unscheduled
    rows, cotangents."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lg = []
    for s, off in zip(seg, offs):
        shape = (K, T // s if s else T, V)
        n = K * shape[1] * V
        flat = (torch.randn(n + off, device="cuda", generator=g) * 3
                ).to(dtype)
        lg.append(flat[off:].view(shape))
    labels = torch.randint(0, V, (K, T), device="cuda", generator=g)
    avail = (torch.rand((M, K, 1), device="cuda", generator=g) < 0.7
             ).float().expand(M, K, T).contiguous()
    avail[:, 0, 0] = 0.0
    df = torch.randn((K, T), device="cuda", generator=g)
    dm = torch.randn((M, K, T), device="cuda", generator=g)
    return lg, labels, avail, df, dm


def _fusion_against_plain(lg, labels, avail, df, dm, seg, p=None):
    """Both kernels (at ``p`` or the planned launch) against the plain
    version on the same values; gsq/gdot bitwise equal across two runs and
    the backward without partials equal to the one with them."""
    lgs, lab, av, shape = ops._kernel_operands(lg, labels, avail, seg)
    out = ops._launch_fwd(lgs, lab, av, seg, shape, p=p)
    runs = []
    for _ in range(2):
        dl, part = ops._launch_bwd(lgs, lab, av, df, dm, out[3], out[5], seg,
                                   shape, p=p)
        runs.append((dl, ops._launch_reduce(part)))
    dl_step, _ = ops._launch_bwd(lgs, lab, av, df, dm, out[3], out[5], seg,
                                 shape, with_partials=False, p=p)
    torch.cuda.synchronize()
    (dl, (gsq, gdot)), (_, (gsq2, gdot2)) = runs
    assert torch.equal(gsq, gsq2) and torch.equal(gdot, gdot2)
    assert all(map(torch.equal, dl_step, dl))
    stack = ops._plain_stack(lg, seg)
    for got, want in zip(out, ref.fusion_loss_ref(stack, labels, avail,
                                                  save_residuals=True)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    d, sq, dot = ref.fusion_loss_ref_grads(stack, labels, avail, df, dm)
    for m in range(len(lg)):
        torch.testing.assert_close(dl[m], d[m], rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(gsq, sq.T, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gdot, dot.T, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("K,T,V,M,seg,dtype,offs,regime", FUSION_CARD_CASES)
def test_fusion_kernel_regimes_match_plain_on_card(cuda, K, T, V, M, seg,
                                                   dtype, offs, regime):
    """Each regime's edges against the plain version on the same values
    (float32 tolerances: both compute in float32 from the same inputs)."""
    p = ops.plan(K, T, V, M, seg, dtype)
    assert (p.regime if p.regime == "rows"
            else f"{p.regime}/{p.fwd.width}") == regime
    _fusion_against_plain(*_fusion_card_case(K, T, V, M, seg, dtype, offs),
                          seg)


@pytest.mark.gpu
@pytest.mark.parametrize("regime,width", [("rows", ops.ROWS_R)]
                         + [("group", G) for G in ops.FWD_WIDTHS])
def test_fusion_kernel_every_width_matches_plain_on_card(cuda, regime, width):
    """Every forward width the C side builds, forced past the plan, with
    the backward width the plan pairs with it (so every backward width
    too): rows at V = 24 with four operands, group at V = 3000 in bfloat16
    with a broadcast head."""
    if regime == "rows":
        K, T, V, M, seg, dt = 3, 300, 24, 4, (0, 0, 0, 0), F32
    else:
        K, T, V, M, seg, dt = 2, 40, 3000, 3, (0, 0, 5), BF16
    p = ops.make_plan(regime, width, K, T, V, M, dt.itemsize)
    _fusion_against_plain(*_fusion_card_case(K, T, V, M, seg, dt,
                                             (0,) * M, seed=width),
                          seg, p=p)


@pytest.mark.gpu
def test_fusion_kernel_refuses_what_no_plan_takes(cuda):
    """No quiet plain path on the card: a float64 operand, operands of two
    types and a fifth modality raise."""
    lg, labels, avail, _, _ = _fusion_card_case(1, 8, 40, 2, (0, 0), F32,
                                                (0, 0))
    with pytest.raises(TypeError):
        ops.fusion_loss_fwd([x.double() for x in lg], labels, avail, (0, 0))
    with pytest.raises(TypeError):
        ops.fusion_loss_fwd([lg[0], lg[1].bfloat16()], labels, avail, (0, 0))
    with pytest.raises(ValueError):
        ops.fusion_loss_fwd(lg * 3, labels, avail.repeat(3, 1, 1),
                            (0,) * 6)


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
    from repro_torch.kernels.fusion_loss.build import load as fl_load
    for K, T, V, M, seg, dt, _, _ in FUSION_CARD_CASES:
        p = ops.plan(K, T, V, M, seg, dt)
        for bwd, d in ((0, p.fwd), (1, p.bwd)):
            assert fl_load().fusion_loss_smem_bytes(
                ops.REGIMES[p.regime], bwd, d.width, V, M,
                dt.itemsize) == d.smem


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


# ---------------------------------------------------------------------------
# the JCSBA solver kernels
# ---------------------------------------------------------------------------
def _solver_kernels_against_plain(data, A, hp=None):
    """Both kernels against their plain versions on the same card tensors:
    B_min and ok; J (rel 1e-4, abs 1e-6), feasibility (equal) and B (rtol
    1e-3, atol 2 Hz) with and without B; returns the plain (J, B, feas)."""
    from repro_torch.wireless.solver import SolverHyper, torchsolver
    hp = hp or SolverHyper()
    d = torchsolver.to_device(data, "cuda")
    solver_ops.reset_launch_counts()
    bm, ok = solver_ops.bmin(d["gamma"], d["h"], d["tau_rem"], d["B_max"],
                             d["p_tx"], d["N0"], hp)
    bm_w, ok_w = solver_ref.bmin(d["gamma"], d["h"], d["tau_rem"],
                                 d["B_max"], d["p_tx"], d["N0"], hp)
    assert torch.equal(ok, ok_w)
    torch.testing.assert_close(bm, bm_w, rtol=1e-6, atol=0.0)
    At = torch.as_tensor(A, device="cuda")
    J, B, feas = solver_ops.population_objective(At, bm_w, ok_w, d, hp,
                                                 want_B=True)
    J2, none, feas2 = solver_ops.population_objective(At, bm_w, ok_w, d, hp)
    J_w, B_w, feas_w = solver_ref.population_objective(At, bm_w, ok_w, d,
                                                       hp, want_B=True)
    torch.cuda.synchronize()
    assert solver_ops.launch_counts() == {"jcsba_bmin_kernel": 1,
                                          "jcsba_population_kernel": 2}
    assert none is None and torch.equal(J, J2) and torch.equal(feas, feas2)
    assert torch.equal(feas, feas_w)
    assert torch.equal(torch.isinf(J), torch.isinf(J_w))
    fin = torch.isfinite(J_w)
    torch.testing.assert_close(J[fin], J_w[fin], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(B, B_w, rtol=1e-3, atol=2.0)
    assert (B[~feas] == 0).all() and (B[~At] == 0).all()
    return J_w.cpu().numpy(), B_w.cpu().numpy(), feas_w.cpu().numpy(), \
        bm_w.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("K", [6, 10, 100, 1000])
@pytest.mark.parametrize("P", [1, 20, 24])
def test_solver_kernels_match_plain_on_card(cuda, K, P):
    data = synthetic_round(K, seed=K + P)
    J, B, feas, _ = _solver_kernels_against_plain(
        data, antibody_rows(K, P, K * P))
    assert feas[0] and J[0] == J[0]                 # the empty row
    if P > 1:
        assert not feas[-1]                         # the full row


def _branch_case(K):
    """Queues and rows that take each branch of the allocation: clients 0-1
    with Q = 0, 2-3 with Q = 1e-22 (φ(B_min) above the whole κ bracket, so
    every one pinned), 4 with Q = 1e-12 (pinned beside active clients), the
    rest active; the last client latency-infeasible.  Rows: empty; all
    Q = 0; all pinned; pinned beside an active client; the KKT split of two
    active clients; one; the infeasible client; and it with another."""
    Q = np.full(K, 5e-3)
    Q[[0, 1]] = 0.0
    Q[[2, 3]] = 1e-22
    Q[4] = 1e-12
    A = np.zeros((8, K), bool)
    for i, row in enumerate(([], [0, 1], [2, 3], [1, 4, 5], [5, 6], [5],
                             [K - 1], [0, K - 1])):
        A[i, row] = True
    return Q, A


@pytest.mark.gpu
@pytest.mark.parametrize("K", [8, 10])
def test_solver_kernel_branches_match_plain_on_card(cuda, K):
    Q, A = _branch_case(K)
    data = synthetic_round(K, seed=1, Q=Q)
    J, B, feas, bm = _solver_kernels_against_plain(data, A)
    assert list(feas) == [True] * 6 + [False] * 2
    share = (data["B_max"] - bm[[0, 1]].sum()) / 2
    np.testing.assert_allclose(B[1][[0, 1]], bm[[0, 1]] + share, rtol=1e-5)
    share = (data["B_max"] - bm[[2, 3]].sum()) / 2
    np.testing.assert_allclose(B[2][[2, 3]], bm[[2, 3]] + share, rtol=1e-5)
    assert B[3][1] == bm[1] and B[3][4] == bm[4] and B[3][5] > bm[5]
    # Σ B_min of row 4 at the budget: B = B_min
    at_eq = synthetic_round(K, seed=1, Q=Q,
                         B_max=float(bm[[5, 6]].sum(dtype=np.float32)))
    _, B, feas, bm = _solver_kernels_against_plain(at_eq, A[4:5])
    assert feas[0]
    np.testing.assert_array_equal(B[0][[5, 6]], bm[[5, 6]])


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1025, 5000, 8192])
def test_solver_kernel_takes_several_clients_a_thread(cuda, K):
    """K past 1024 threads: 2 and 8 clients a thread in one block."""
    assert solver_ops.plan(K)[1] == (2 if K == 1025 else 8)
    data = synthetic_round(K, seed=K)
    _solver_kernels_against_plain(data, antibody_rows(K, 6, K))


@pytest.mark.gpu
def test_solver_kernel_refuses_past_one_block(cuda):
    from repro_torch.wireless.solver import SolverHyper, torchsolver
    d = torchsolver.to_device(synthetic_round(8193, 0), "cuda")
    bm = torch.ones(8193, device="cuda")
    with pytest.raises(ValueError, match="8192"):
        solver_ops.population_objective(
            torch.zeros((2, 8193), dtype=torch.bool, device="cuda"), bm,
            bm > 0, d, SolverHyper())


@pytest.mark.gpu
def test_solve_on_card_matches_plain_solve(cuda):
    """One whole solve with the kernels and one with the plain versions on
    the card, on the same draws: the same a*; J and B within tolerance."""
    from repro_torch.wireless.solver import SolverHyper, torchsolver
    hp = SolverHyper()
    d = torchsolver.to_device(synthetic_round(10, 3), "cuda")
    draws = torchsolver.make_draws(
        torch.Generator(device="cuda").manual_seed(5), 10, hp)
    seeds = torch.zeros((2, 10), dtype=torch.bool, device="cuda")
    a, J, B = torchsolver.solve_core(d, seeds, draws, hp)
    with plain_versions():
        a_w, J_w, B_w = torchsolver.solve_core(d, seeds, draws, hp)
    assert torch.equal(a, a_w)
    torch.testing.assert_close(J, J_w, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(B, B_w, rtol=1e-3, atol=2.0)


@pytest.mark.gpu
def test_population_kernel_reads_v_from_the_device_in_a_graph(cuda):
    """One captured population launch replayed at two V copied into the
    0-d V tensor it read at capture, each against the plain version at
    that V (queues > 0: the κ/φ⁻¹ bisections), at the J tolerance."""
    from repro_torch.wireless.solver import SolverHyper, torchsolver
    hp = SolverHyper()
    d = torchsolver.to_device(synthetic_round(10, 3), "cuda")
    A = torch.as_tensor(antibody_rows(10, 20, 7), device="cuda")
    bm, ok = solver_ref.bmin(d["gamma"], d["h"], d["tau_rem"], d["B_max"],
                             d["p_tx"], d["N0"], hp)
    solver_ops.population_objective(A, bm, ok, d, hp)     # build, load
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        J, _, feas = solver_ops.population_objective(A, bm, ok, d, hp)
    seen = []
    for V in (0.5, 40.0):
        d["V"].fill_(V)
        g.replay()
        J_w, _, feas_w = solver_ref.population_objective(A, bm, ok, d, hp)
        torch.cuda.synchronize()
        assert torch.equal(feas, feas_w)
        fin = torch.isfinite(J_w)
        assert fin.any()
        torch.testing.assert_close(J[fin], J_w[fin], rtol=1e-4, atol=1e-6)
        seen.append(J[fin].clone())
    assert not torch.equal(seen[0], seen[1])


def _grid_card(rows=2, rounds=3, device="cuda"):
    """A from_store engine on a ``rows``-row iemocap grid (K=6) and its
    xs, on the card."""
    from repro_torch.data.scenarios import ScenarioSpec, stack_scenarios
    from repro_torch.fl.client import make_adapter
    from repro_torch.fl.fused_round import (FusedRoundEngine,
                                            draw_population_xs)
    from repro_torch.wireless.channel import Channel
    from repro_torch.wireless.params import WirelessParams
    from repro_torch.wireless.policies import JCSBAPolicy
    from repro_torch.wireless.solver import SolverHyper
    params = WirelessParams(K=6, B_max=6e6, E_add=2e-4)
    specs = [ScenarioSpec(dataset="iemocap", K=6, n_per_client=8,
                          n_test=16, omega=w, V=V, seed=i, split=sp)
             for i, (sp, w, V) in enumerate((("iid", 0.0, 1e-6),
                                             ("dirichlet", 0.3, 1.0),
                                             ("natural", 0.5, 10.0))[:rows])]
    grid = stack_scenarios(specs, params)
    pol = JCSBAPolicy(6, SolverHyper(S=8, G=3), max_cohort=3)
    eng = FusedRoundEngine.from_store(grid.store_row(0), params, pol,
                                      make_adapter("iemocap", dropout=0.0),
                                      device=device)
    rng = np.random.default_rng(1)
    xs = draw_population_xs(Channel(params, rng), rng, 6, rounds,
                            eval_every=2, include_final=True, policy=pol,
                            device=device)
    kw = dict(stores=grid.stores,
              test_sets=(grid.test_features, grid.test_labels))
    return grid, eng, xs, kw


@pytest.mark.gpu
def test_scenario_grid_replays_equal_the_eager_body(cuda):
    """A 2-row grid on the card (one captured round replayed row by row)
    against each row's experiment run eagerly with the scenario passed as
    arguments: participants identical, params and metrics within 1e-6;
    two captures for the grid, and the engine's own step unchanged."""
    from repro_torch.fl.fused_round import tree_row
    grid, eng, xs, kw = _grid_card()
    x0 = tree_row(xs, 0)
    c0, a0 = eng.step_eager(eng.fresh_carry(), x0)
    carries, auxs = eng.scan_scenario_grid(grid.overrides,
                                           eng.fresh_carry(), xs, **kw)
    assert eng.capture_count == 2 and set(eng.replays) == {"grid", False}
    assert sum(eng.replays.values()) == 2 * 3
    for s in range(2):
        ovr, store, test = eng._grid_row(grid.overrides, s, **kw)
        c, a = eng._scan_one_scenario(ovr, store, test, eng.fresh_carry(),
                                      xs)
        assert torch.equal(a.ok, auxs.ok[s]) and torch.equal(a.a, auxs.a[s])
        for k in a.metrics:
            torch.testing.assert_close(a.metrics[k], auxs.metrics[k][s],
                                       rtol=1e-6, atol=1e-6, equal_nan=True)
        for x, y in zip(tree_leaves(c.params), tree_leaves(carries.params)):
            torch.testing.assert_close(x, y[s], rtol=1e-6, atol=1e-6)
    c1, a1 = eng.step_eager(eng.fresh_carry(), x0)
    for x, y in zip(tree_leaves(c0) + tree_leaves(a0),
                    tree_leaves(c1) + tree_leaves(a1)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)


def _fused_card(arch="lstm-cnn", **kw):
    return MFLExperiment("crema_d", K=6, n_samples=240, arch=arch,
                         engine="fused:pallas", eval_every=2,
                         scheduler_kwargs={"immune_kwargs": {"S": 8,
                                                             "G": 3}},
                         **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["lstm-cnn", "transformer", "ssd"])
def test_fused_graph_replays_equal_the_eager_body(cuda, arch):
    """The captured round, replayed, against the same body run eagerly on
    the card on the same carry and xs: participants identical, params
    within 1e-6, metrics on the eval rounds within 1e-6."""
    from repro_torch.fl.fused_round import draw_round_xs, tree_row
    exp = _fused_card(arch)
    eng = exp._get_fused_engine()
    xs = draw_round_xs(exp, 4)
    eager = graph = exp._carry
    for i in range(4):
        x = tree_row(xs, i)
        eager, ae = eng.step_eager(eager, x)
        graph, ag = eng.step(graph, x)
        assert torch.equal(ae.ok, ag.ok) and torch.equal(ae.a, ag.a)
        for k in ae.metrics:
            torch.testing.assert_close(ae.metrics[k], ag.metrics[k],
                                       rtol=1e-6, atol=1e-6,
                                       equal_nan=True)
    for a, b in zip(tree_leaves(eager.params), tree_leaves(graph.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert eng.capture_count == 2       # one graph with eval, one without


@pytest.mark.gpu
def test_fused_rounds_capture_once_a_graph(cuda):
    """Many rounds, one capture a graph: stepwise rounds and a scan reuse
    the two captured graphs; the captured rounds launched the fusion-loss
    and solver kernels, and each replay counts."""
    exp = _fused_card()
    exp.run(3)
    exp.run_scanned(4)
    eng = exp._fused_engine
    assert eng.capture_count == 2
    assert eng.replays == {True: 4, False: 3}
    for g in (True, False):
        got = eng.graph_launches[g]
        assert got["fusion_loss_fwd"] == got["fusion_loss_bwd"] == 1
        assert got["jcsba_bmin_kernel"] == 1
        assert got["jcsba_population_kernel"] == 1 + 2 * 3 + 1
    assert len(exp.history) == 7
    assert all(math.isfinite(v) for r in exp.history
               for v in r.metrics.values())


@pytest.mark.gpu
def test_fused_global_params_survive_a_replay(cuda):
    """``global_params`` is a copy of the carry, not the graph's static
    buffers: a reference kept across replayed rounds still holds the
    round it was taken at, as in the host loops, where the params are
    rebound each round and never written in place."""
    exp = _fused_card()
    exp.run(2)                      # the two captures (eval, no eval)
    kept = exp.global_params
    snap = [x.clone() for x in tree_leaves(kept)]
    exp.run(2)                      # two more replays, no capture
    eng = exp._fused_engine
    assert eng.capture_count == 2
    assert eng.replays == {True: 2, False: 2}
    for a, b in zip(tree_leaves(kept), snap):
        assert torch.equal(a, b)
    if any(r.participants for r in exp.history[2:]):
        assert any(not torch.equal(a, b) for a, b in
                   zip(tree_leaves(exp.global_params), snap))

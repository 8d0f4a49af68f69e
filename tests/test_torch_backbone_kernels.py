"""The port's flash-attention and SSD intra-chunk kernels' plain versions
(``repro_torch.kernels.{flash_attention,ssd_scan}``, what the CPU path
runs) against the JAX package's Pallas kernels in interpret mode and their
``ref.py`` oracles, on the same numpy inputs, plus the kernel-path autograd
Functions against the plain path's gradients.

Tolerances (float32): attention 2e-5 and SSD 1e-4, the JAX package's own
kernel-sweep tolerances (tests/test_kernels.py) — another summation order,
and SSD's exp-weighted sums over a chunk.  The card's kernels are held
against the same plain versions by the ``gpu`` tests of
tests/test_torch_isolation.py and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as j_ssd_chunk_ref
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba

ATOL_ATTN = dict(rtol=2e-5, atol=2e-5)
ATOL_SSD = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, B, H, KH, S, hd):
    """q [B,H,S,hd], k/v [B,KH,S,hd] (the TPU kernel's layout), float32."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, H, S, hd), (B, KH, S, hd), (B, KH, S, hd)))


def _bshd(x):
    """[B,H,S,hd] numpy -> [B,S,H,hd] tensor (models.layers' layout)."""
    return torch.as_tensor(x).transpose(1, 2)


# GQA (H != KH), a window, and S = 24 (the IEMOCAP text axis, no power of 2)
ATTN_CASES = [
    (2, 4, 4, 32, 8, None),         # the training path's heads, audio/image
    (3, 4, 4, 24, 8, None),         # ... and the text axis
    (1, 4, 2, 24, 16, None),        # GQA at S=24
    (2, 8, 2, 64, 16, 16),          # GQA + sliding window
    (1, 2, 1, 48, 32, 5),           # window not dividing the tile
    # the wide regime's head dims: gemma3-12b's (hd 256, R = 2, a window)
    # and kimi-k2's (hd 112, R = 8)
    (1, 4, 2, 40, 256, 16),
    (1, 8, 1, 24, 112, None),
]


@pytest.mark.parametrize("B,H,KH,S,hd,win", ATTN_CASES)
def test_flash_attention_plain_matches_pallas_and_ref(B, H, KH, S, hd, win):
    q, k, v = _qkv(0, B, H, KH, S, hd)
    want_k = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=win, interpret=True))
    want_r = np.asarray(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        window=win))
    got = fa_ops.flash_attention(_bshd(q), _bshd(k), _bshd(v),
                                 window=win).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want_k, **ATOL_ATTN)
    np.testing.assert_allclose(got, want_r, **ATOL_ATTN)
    # the float64 oracle and the model's plain path agree with it too
    got64 = fa_ref.attention_ref(*map(torch.as_tensor, (q, k, v)),
                                 window=win, dtype=torch.float64)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got, got64.numpy(), **ATOL_ATTN)
    plain = tlayers.chunked_attention(_bshd(q), _bshd(k), _bshd(v),
                                      window=win, chunk=16)
    np.testing.assert_allclose(plain.transpose(1, 2).numpy(), want_r,
                               **ATOL_ATTN)


@pytest.mark.parametrize("window,chunk", [(None, 8), (None, 24), (6, 8),
                                          (16, 12)])
def test_chunked_attention_matches_jax(window, chunk):
    """The plain path, windowed branch included, against the JAX package's
    ``chunked_attention`` in the [B,S,H,hd] layout."""
    q, k, v = (np.swapaxes(x, 1, 2) for x in _qkv(1, 2, 4, 2, 24, 8))
    want = np.asarray(jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        chunk=chunk))
    got = tlayers.chunked_attention(*map(torch.as_tensor, (q, k, v)),
                                    window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **ATOL_ATTN)


@pytest.mark.parametrize("window", [None, 7])
def test_pallas_attention_grads_match_plain_path(window):
    """The autograd Function's forward is the kernel's (here its plain
    version) and its backward the recompute through ``chunked_attention``:
    value and gradients equal the plain path's, and no kernel launches on
    CPU tensors."""
    fa_ops.reset_launch_counts()
    q, k, v = (np.swapaxes(x, 1, 2) for x in _qkv(2, 3, 4, 2, 24, 8))
    g = torch.as_tensor(np.random.default_rng(3).normal(size=q.shape)
                        .astype(np.float32))

    def run(fn):
        ins = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ins)
        out.backward(g)
        return out.detach(), [t.grad for t in ins]

    o1, g1 = run(lambda *a: tlayers.pallas_attention(*a, window, 24))
    o2, g2 = run(lambda *a: tlayers.chunked_attention(*a, window=window,
                                                      chunk=24))
    torch.testing.assert_close(o1, o2, **ATOL_ATTN)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert fa_ops.launch_counts() == {"flash_attention_fwd": 0}


# ---------------------------------------------------------------------------
def _ssd_chunk_inputs(seed, B, nc, Q, nh, hp, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, nc, Q, nh, hp)).astype(np.float32)
    cum = np.cumsum(-np.abs(rng.normal(size=(B, nc, Q, nh)) * 0.1),
                    axis=2).astype(np.float32)
    Bm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    Cm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    return x, cum, Bm, Cm


@pytest.mark.parametrize("B,nc,Q,nh,hp,N", [
    (3, 4, 8, 8, 8, 16),            # the training path, S = 32
    (2, 3, 8, 8, 8, 16),            # ... and S = 24
    (2, 4, 32, 4, 16, 8),           # the JAX sweep's middle case
    (1, 1, 256, 2, 64, 128),        # the JAX configs' chunk: mamba2-370m
    (1, 1, 256, 2, 64, 16),         # ... and jamba-v0.1-52b
])
def test_ssd_chunk_plain_matches_pallas_and_ref(B, nc, Q, nh, hp, N):
    ins = _ssd_chunk_inputs(0, B, nc, Q, nh, hp, N)
    jins = [jnp.asarray(x) for x in ins]
    yk, sk = ssd_chunk_pallas(*jins, interpret=True)
    yr, sr = j_ssd_chunk_ref(*jins)
    y, s = ssd_ops.ssd_chunk(*map(torch.as_tensor, ins))
    for got, want in ((y, yk), (y, yr), (s, sk), (s, sr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL_SSD)
    y64, s64 = ssd_ref.ssd_chunk_ref(*map(torch.as_tensor, ins),
                                     dtype=torch.float64)
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y64.numpy(), **ATOL_SSD)
    np.testing.assert_allclose(s.numpy(), s64.numpy(), **ATOL_SSD)


def _ssd_inputs(seed, B, S, nh, hp, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, nh, hp)).astype(np.float32),
            (np.abs(rng.normal(size=(B, S, nh))) * 0.1 + 0.01
             ).astype(np.float32),
            (-np.abs(rng.normal(size=nh)) - 0.1).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32))


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 8), (64, 16), (96, 96)])
def test_ssd_forward_and_plain_path_match_jax(S, chunk):
    """``ssd_forward`` (kernel intra-chunk term + plain inter-chunk
    recurrence) and the port's ``ssd_chunked`` against the JAX package's
    ``ssd_chunked``."""
    ins = _ssd_inputs(1, 2, S, 8, 8, 16)
    want = np.asarray(jmamba.ssd_chunked(*map(jnp.asarray, ins), chunk))
    tins = list(map(torch.as_tensor, ins))
    np.testing.assert_allclose(ssd_ops.ssd_forward(*tins, chunk).numpy(),
                               want, **ATOL_SSD)
    np.testing.assert_allclose(tmamba.ssd_chunked(*tins, chunk).numpy(),
                               want, **ATOL_SSD)


def test_ssd_per_row_A_equals_broadcast_A():
    """The cohort flattens K·N into the batch with A repeated per row: an
    A of [B, nh] equal in every row gives the [nh] result."""
    x, dt, A, Bm, Cm = map(torch.as_tensor, _ssd_inputs(2, 3, 24, 8, 8, 16))
    rows = A.expand(3, -1).contiguous()
    for fn in (ssd_ops.ssd_forward, tmamba.ssd_chunked):
        torch.testing.assert_close(fn(x, dt, rows, Bm, Cm, 8),
                                   fn(x, dt, A, Bm, Cm, 8))


def test_ssd_pallas_grads_match_plain_path():
    """Kernel forward + recompute backward equals the plain path, with
    finite gradients (the exponent is masked before exp), and no kernel
    launches on CPU tensors."""
    ssd_ops.reset_launch_counts()
    ins = _ssd_inputs(4, 2, 32, 8, 8, 16)
    g = torch.as_tensor(np.random.default_rng(5).normal(size=ins[0].shape)
                        .astype(np.float32))

    def run(fn):
        ts = [torch.as_tensor(x).requires_grad_() for x in ins]
        out = fn(*ts, 8)
        out.backward(g)
        return out.detach(), [t.grad for t in ts]

    o1, g1 = run(tmamba.ssd_pallas)
    o2, g2 = run(tmamba.ssd_chunked)
    torch.testing.assert_close(o1, o2, **ATOL_SSD)
    for a, b in zip(g1, g2):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert ssd_ops.launch_counts() == {"ssd_chunk_fwd": 0}

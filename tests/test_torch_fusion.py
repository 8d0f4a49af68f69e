"""The port's fusion loss (``repro_torch.core.fusion`` and the plain path of
``repro_torch.kernels.fusion_loss``) against the JAX package.

Inputs come from numpy with a fixed seed and go through both packages; the
JAX kernel runs in interpret mode, as the JAX package's own tests run it.
Tolerances are float32 ones: the two packages reduce in another order
(forward 1e-5 rel/abs, gradients 2e-5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro.core import fusion as jfusion
from repro.kernels.fusion_loss import kernel as jkernel
from repro.kernels.fusion_loss import ops as jops
from repro_torch.core import fusion as tfusion
from repro_torch.kernels.fusion_loss import ops as tops
from repro_torch.kernels.fusion_loss import ref as tref

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


# ---------------------------------------------------------------------------
# core.fusion
# ---------------------------------------------------------------------------
def _core_case(kind, rng):
    B, S, V = 4, 3, 7
    if kind == "broadcast":
        lg = {"text": rng.normal(size=(B, S, V)),
              "vision": rng.normal(size=(B, 1, V))}
        labels = rng.integers(0, V, (B, S))
    else:
        lg = {"audio": rng.normal(size=(B, V)), "image": rng.normal(size=(B, V)),
              "text": rng.normal(size=(B, V))}
        labels = rng.integers(0, V, B)
    lg = {m: x.astype(np.float32) for m, x in lg.items()}
    avail = mask = None
    if kind == "scalar_avail":
        avail = {"audio": np.float32(1.0), "image": np.float32(0.0),
                 "text": np.float32(1.0)}
    if kind == "vector_avail":
        avail = {m: (rng.random(B) < 0.6).astype(np.float32) for m in lg}
        avail["audio"][:] = 1.0
    if kind in ("sample_mask", "broadcast"):
        mask = np.ones(labels.shape, np.float32)
        mask[-1] = 0.0
    return lg, labels.astype(np.int32), avail, mask


@pytest.mark.parametrize("kind", ["plain", "scalar_avail", "vector_avail",
                                  "sample_mask", "broadcast"])
def test_multimodal_loss_matches_jax(kind):
    rng = np.random.default_rng(0)
    lg, labels, avail, mask = _core_case(kind, rng)
    v = {m: 1.0 + i for i, m in enumerate(sorted(lg))}

    def jloss(lgj):
        total, met = jfusion.multimodal_loss(
            lgj, jnp.asarray(labels), v,
            None if avail is None else {m: jnp.asarray(a)
                                        for m, a in avail.items()},
            None if mask is None else jnp.asarray(mask))
        return total, met

    (jt, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {m: jnp.asarray(x) for m, x in lg.items()})
    tl = {m: torch.tensor(x, requires_grad=True) for m, x in lg.items()}
    tt, tmet = tfusion.multimodal_loss(
        tl, torch.as_tensor(labels), v,
        None if avail is None else {m: torch.as_tensor(a)
                                    for m, a in avail.items()},
        None if mask is None else torch.as_tensor(mask))
    tt.backward()
    _close(tt, jt, FWD)
    for key in ("F", "G", "fused_logits", *(f"G_{m}" for m in lg)):
        _close(tmet[key], jmet[key], FWD)
    for m in lg:
        _close(tl[m].grad, jg[m], GRAD)


def test_accuracy_and_xent_match_jax():
    rng = np.random.default_rng(1)
    lg = rng.normal(size=(9, 5)).astype(np.float32)
    y = rng.integers(0, 5, 9).astype(np.int32)
    jacc, jce = jax.jit(lambda a, b: (jfusion.accuracy(a, b),
                                      jfusion.softmax_xent(a, b)))(
        jnp.asarray(lg), jnp.asarray(y))
    _close(tfusion.accuracy(torch.as_tensor(lg), torch.as_tensor(y)), jacc,
           FWD)
    _close(tfusion.softmax_xent(torch.as_tensor(lg), torch.as_tensor(y)),
           jce, FWD)


# ---------------------------------------------------------------------------
# the kernel wrappers' plain path
# ---------------------------------------------------------------------------
def _kernel_case(M, T, V, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(M, T, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    avail = (rng.random((M, T)) < 0.7).astype(np.float32)
    avail[0, 1:] = 1.0
    avail[:, 0] = 0.0                           # a row with no modality
    d_fused = rng.normal(size=T).astype(np.float32)
    d_modal = rng.normal(size=(M, T)).astype(np.float32)
    return logits, labels, avail, d_fused, d_modal


@pytest.mark.parametrize("V", [6, 10, 1000])
@pytest.mark.parametrize("M", [2, 3])
def test_fusion_loss_grads_matches_jax_and_f64(M, V):
    logits, labels, avail, df, dm = _kernel_case(M, 12, V, seed=M * V)
    jd, jsq, jdot = jops.fusion_loss_grads(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(avail),
        jnp.asarray(df), jnp.asarray(dm), interpret=True)
    t = [torch.as_tensor(x) for x in (logits, labels, avail, df, dm)]
    td, tsq, tdot = tops.fusion_loss_grads(*t)
    od, osq, odot = tref.fusion_loss_ref_grads(*t, dtype=torch.float64)
    for got, want in ((td, jd), (tsq, jsq), (tdot, jdot),
                      (td, od), (tsq, osq), (tdot, odot)):
        _close(got, want, GRAD)
    # forward against the JAX kernel and the float64 oracle
    jf, jm = jops.fusion_loss(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(avail), interpret=True)
    tf, tm = tops.fusion_loss(t[0], t[1], t[2])
    of, om = tref.fusion_loss_ref(t[0], t[1], t[2], dtype=torch.float64)
    for got, want in ((tf, jf), (tm, jm), (tf, of), (tm, om)):
        _close(got, want, FWD)


@pytest.mark.parametrize("V", [6, 10, 1000])
@pytest.mark.parametrize("M", [2, 3])
def test_fused_multimodal_loss_matches_jax(M, V):
    """Cohort front-end (K clients at once) against the JAX per-client op,
    values and gradients, with per-client avail and sample-mask padding."""
    K, N = 2, 5
    rng = np.random.default_rng(10 * M + V)
    names = ["audio", "image", "text"][:M]
    lg = {m: (rng.normal(size=(K, N, V)) * 2).astype(np.float32)
          for m in names}
    labels = rng.integers(0, V, (K, N)).astype(np.int32)
    avail = {m: np.array([1.0, float(i != 1)], np.float32)
             for i, m in enumerate(names)}
    smask = np.ones((K, N), np.float32)
    smask[1, -2:] = 0.0
    v = {m: 1.0 + 2 * i for i, m in enumerate(names)}

    tl = {m: torch.tensor(x, requires_grad=True) for m, x in lg.items()}
    tt, tmet = tops.fused_multimodal_loss(
        tl, torch.as_tensor(labels), v,
        {m: torch.as_tensor(a) for m, a in avail.items()},
        torch.as_tensor(smask))
    tt.sum().backward()

    @jax.jit
    @functools.partial(jax.value_and_grad, has_aux=True)
    def jloss(lgj, lab, av, sm):
        return jops.fused_multimodal_loss(lgj, lab, v, av, sm,
                                          interpret=True)

    for k in range(K):
        (jt, jmet), jg = jloss({m: jnp.asarray(x[k]) for m, x in lg.items()},
                               jnp.asarray(labels[k]),
                               {m: jnp.asarray(a[k]) for m, a in avail.items()},
                               jnp.asarray(smask[k]))
        _close(tt[k], jt, FWD)
        for key in ("F", "G", *(f"G_{m}" for m in names)):
            _close(tmet[key][k], jmet[key], FWD)
        for m in names:
            _close(tl[m].grad[k], jg[m], GRAD)


def test_fused_multimodal_loss_broadcast_head_matches_core_fusion():
    """A [K, B, 1, V] head against [K, B, S] labels folds its gradient back
    to the compact operand; values and grads equal core.fusion's."""
    K, B, S, V = 2, 3, 4, 9
    rng = np.random.default_rng(3)
    lg = {"text": rng.normal(size=(K, B, S, V)).astype(np.float32),
          "vision": rng.normal(size=(K, B, 1, V)).astype(np.float32)}
    labels = rng.integers(0, V, (K, B, S))
    tl = {m: torch.tensor(x, requires_grad=True) for m, x in lg.items()}
    tt, _ = tops.fused_multimodal_loss(tl, torch.as_tensor(labels))
    tt.sum().backward()
    cl = {m: torch.tensor(x, requires_grad=True) for m, x in lg.items()}
    ct = torch.stack([tfusion.multimodal_loss(
        {m: x[k] for m, x in cl.items()}, torch.as_tensor(labels[k]))[0]
        for k in range(K)])
    ct.sum().backward()
    _close(tt, ct, FWD)
    for m in lg:
        assert tl[m].grad.shape == lg[m].shape
        _close(tl[m].grad, cl[m].grad, GRAD)


# ---------------------------------------------------------------------------
# edge cases and the autograd Function
# ---------------------------------------------------------------------------
def test_row_without_modalities_and_padded_rows_are_exact():
    M, T, V = 3, 6, 10
    logits, labels, avail, df, dm = _kernel_case(M, T, V, seed=7)
    avail[:, 2] = 0.0
    df[4:] = 0.0                                # sample-mask padded rows
    dm[:, 4:] = 0.0
    t = [torch.as_tensor(x) for x in (logits, labels, avail, df, dm)]
    f_nll, m_nll = tops.fusion_loss(t[0], t[1], t[2])
    for row in (0, 2):
        assert float(f_nll[row]) == pytest.approx(np.log(V), rel=1e-6)
        assert torch.all(m_nll[:, row] == 0)
    d, _, _ = tops.fusion_loss_grads(*t)
    assert torch.all(d[:, [0, 2]] == 0)
    assert torch.all(d[:, 4:] == 0)
    assert torch.all(d[avail == 0] == 0)


def test_fusion_loss_function_gradcheck_f64():
    """The Function's plain path in float64, broadcast head included."""
    rng = np.random.default_rng(5)
    K, T, V, S = 2, 4, 5, 2
    seg = (0, S)
    labels = torch.as_tensor(rng.integers(0, V, (K, T)))
    avail = torch.as_tensor((rng.random((2, K, 1)) < 0.8)
                            .astype(np.float64)).expand(2, K, T)
    x0 = torch.tensor(rng.normal(size=(K, T, V)), requires_grad=True)
    x1 = torch.tensor(rng.normal(size=(K, T // S, V)), requires_grad=True)

    def fn(a, b):
        return tops.FusionLoss.apply(seg, labels, avail, a, b)

    assert torch.autograd.gradcheck(fn, (x0, x1))


def test_ref_f32_matches_f64_oracle():
    logits, labels, avail, df, dm = _kernel_case(2, 8, 50, seed=9)
    t = [torch.as_tensor(x) for x in (logits, labels, avail, df, dm)]
    for got, want in zip(tref.fusion_loss_ref(*t[:3], save_residuals=True),
                         tref.fusion_loss_ref(*t[:3], dtype=torch.float64,
                                              save_residuals=True)):
        _close(got, want, FWD)
    for got, want in zip(tref.fusion_loss_ref_grads(*t),
                         tref.fusion_loss_ref_grads(*t, dtype=torch.float64)):
        _close(got, want, GRAD)


def test_bf16_plain_path_matches_jax_kernel_on_bf16_values():
    """bfloat16 logits at the JAX fusion sweep's (M, T, V) = (4, 128, 512):
    the port's plain path and the JAX kernel (interpret mode) both upcast
    the same bfloat16 values to float32, so the float32 results agree to
    1e-5.  JAX returns dlogits cast to the operand's type (bfloat16), the
    port's ``fusion_loss_grads`` float32: those agree to bfloat16's
    rounding (2^-8 relative)."""
    M, T, V = 4, 128, 512
    logits, labels, avail, df, dm = _kernel_case(M, T, V, seed=11)
    jl = jnp.asarray(logits, jnp.bfloat16)
    tl = torch.as_tensor(logits).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jl, np.float32),
                                  tl.float().numpy())
    tol = dict(rtol=1e-5, atol=1e-5)
    jf, jm = jkernel.fusion_loss_pallas(jl, jnp.asarray(labels),
                                        jnp.asarray(avail), interpret=True)
    tf, tm = tops.fusion_loss(tl, torch.as_tensor(labels),
                              torch.as_tensor(avail))
    _close(tf, jf, tol)
    _close(tm, jm, tol)
    jd, jsq, jdot = jops.fusion_loss_grads(
        jl, jnp.asarray(labels), jnp.asarray(avail), jnp.asarray(df),
        jnp.asarray(dm), interpret=True)
    td, tsq, tdot = tops.fusion_loss_grads(
        tl, *(torch.as_tensor(x) for x in (labels, avail, df, dm)))
    assert jd.dtype == jnp.bfloat16 and td.dtype == torch.float32
    _close(tsq, jsq, tol)
    _close(tdot, jdot, tol)
    _close(td, np.asarray(jd, np.float32), dict(rtol=2 ** -8, atol=1e-7))

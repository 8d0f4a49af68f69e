"""Plain PyTorch versions of the fusion-loss kernels, forward and backward.

Inputs
  logits: [M, *R, V]  stacked per-modality logits (any float dtype)
  labels: [*R] int
  avail:  [M, *R] float — 0/1 availability of modality m for row r
Outputs
  fused_nll: [*R]    — CE of the availability-averaged logits (Eq. 1)
  modal_nll: [M, *R] — per-modality CE (Eq. 3), zero where unavailable

``R`` is the row shape: [T] for one client, [K, T] for a cohort.  The math
runs in ``dtype`` — float32 by default, float64 as the oracle — over
materialised tensors (``logsumexp``, ``softmax``, ``one_hot``), which the
CUDA kernels never form.  CPU tensors take these functions in
``ops.py``; on the card they are what ``chip_smoke.py`` holds the kernels
against.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _mixture(lg: torch.Tensor, a: torch.Tensor):
    """Availability-averaged logits Σ_m a·x_m / max(Σ_m a, 1e-9)."""
    denom = torch.clamp_min(a.sum(0), 1e-9)                      # [*R]
    fused = (lg * a[..., None]).sum(0) / denom[..., None]        # [*R, V]
    return fused, denom


def fusion_loss_ref(logits: torch.Tensor, labels: torch.Tensor,
                    avail: torch.Tensor, *, dtype=torch.float32,
                    save_residuals: bool = False):
    """(fused_nll, modal_nll) and, with ``save_residuals``, the per-row
    (fused_max, fused_lse, modal_max, modal_lse) the kernel saves."""
    lg = logits.to(dtype)
    a = avail.to(dtype)
    fused, _ = _mixture(lg, a)
    lab = labels.long()[..., None]
    f_lse = torch.logsumexp(fused, dim=-1)
    fused_nll = f_lse - torch.gather(fused, -1, lab)[..., 0]
    m_lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, lab[None].expand(lg.shape[:-1] + (1,)))
    modal_nll = (m_lse - gold[..., 0]) * a
    if not save_residuals:
        return fused_nll, modal_nll
    return (fused_nll, modal_nll, fused.amax(dim=-1), f_lse,
            lg.amax(dim=-1), m_lse)


def fusion_loss_ref_grads(logits, labels, avail, d_fused, d_modal, *,
                          dtype=torch.float32):
    """Backward: (dlogits [M, *R, V], gsq, gdot).

    ``d_fused`` [*R] / ``d_modal`` [M, *R] are the cotangents of
    (fused_nll, modal_nll).  gsq = Σ dx_m² and gdot = Σ dx_m·g_fused (the
    Theorem-1 ζ/δ partials in logits space), summed over the last row axis
    and the vocab: [M] for R = [T], [M, K] for R = [K, T]."""
    lg = logits.to(dtype)
    a = avail.to(dtype)
    df = d_fused.to(dtype)
    dm = d_modal.to(dtype)
    V = lg.shape[-1]
    fused, denom = _mixture(lg, a)
    p_f = torch.softmax(fused, dim=-1)
    p_m = torch.softmax(lg, dim=-1)
    onehot = F.one_hot(labels.long(), V).to(dtype)
    base = df[..., None] * (p_f - onehot)
    d = ((a / denom)[..., None] * base[None]
         + (dm * a)[..., None] * (p_m - onehot[None]))
    gsq = (d * d).sum(dim=(-2, -1))
    gdot = (d * base[None]).sum(dim=(-2, -1))
    return d, gsq, gdot

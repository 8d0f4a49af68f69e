"""Decision-level fusion + unimodal loss — Eqs. (1)-(4) of the paper.

* The multimodal decision is the *average of unimodal logits over the client's
  available modalities* (missing modalities contribute 0 and are excluded from
  the mean) — Eq. (1) / Fig. 2.
* The local objective adds, for each available modality, a weighted unimodal
  cross-entropy v_m * CE(logits_m, y) — Eqs. (2)-(3).
* Total local loss H_k = F_k + G_k — Eq. (4).

The plain PyTorch twin of the JAX package's ``core.fusion``: the same
functions with the same broadcasting (paper logits [B, C] and LM-style
logits [B, S, V] with broadcast heads), in float32 math — float64 inputs
stay float64.  The cohort step (fl/client.py) calls it once per client for
the ``xla`` loss backend; the ``pallas`` backend runs the CUDA kernel in
kernels/fusion_loss instead.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


def _float(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _avail(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(1.0 if a is None else a, dtype=like.dtype,
                           device=like.device)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy. logits [..., C]; labels [...] int.

    ``sample_mask`` (0/1, broadcastable to ``labels``) restricts the mean to
    real samples — padded rows of a stacked client batch contribute nothing.
    """
    lg = _float(logits)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    ce = lse - gold
    if sample_mask is None:
        return ce.mean()
    w = torch.broadcast_to(_avail(sample_mask, ce), ce.shape)
    return (ce * w).sum() / torch.clamp_min(w.sum(), 1e-9)


def fuse_logits(modal_logits: Mapping[str, torch.Tensor],
                avail: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Eq. (1) fusion: mean of available modalities' logits.

    ``avail[m]`` is an optional 0/1 scalar (or [B]-vector) availability mask;
    by default every modality present in the dict is available.  Logit
    tensors may broadcast against each other (vision [B,1,V] + text [B,S,V]).
    """
    num, den = None, None
    for m, lg in modal_logits.items():
        lg = _float(lg)
        a = _avail(None if avail is None else avail[m], lg)
        while a.ndim < lg.ndim:
            a = a[..., None]
        term = lg * a
        num = term if num is None else num + term
        den = a if den is None else den + a
    return num / torch.clamp_min(den, 1e-9)


def multimodal_loss(modal_logits: Mapping[str, torch.Tensor],
                    labels: torch.Tensor,
                    v_weights: Optional[Mapping[str, float]] = None,
                    avail: Optional[Mapping[str, torch.Tensor]] = None,
                    sample_mask: Optional[torch.Tensor] = None):
    """H_k = F_k + G_k (Eqs. 1-4).

    ``avail[m]`` zeroes out a modality the client lacks (or dropped), and
    ``sample_mask`` zeroes out padded samples.  Returns (total, metrics) where
    metrics holds F, each unimodal G_m, G and the fused logits.
    """
    fused = fuse_logits(modal_logits, avail)
    F = softmax_xent(fused, labels, sample_mask)
    G = torch.zeros((), dtype=F.dtype, device=F.device)
    metrics: Dict[str, torch.Tensor] = {"F": F}
    for m, lg in modal_logits.items():
        v = 1.0 if v_weights is None else float(v_weights.get(m, 1.0))
        a = _avail(None if avail is None else avail[m], F)
        if lg.ndim == labels.ndim + 1 and lg.shape[:-1] == labels.shape:
            g = softmax_xent(lg, labels, sample_mask)
        else:
            # broadcast logits (e.g. vision head [B,1,V] vs labels [B,S])
            g = softmax_xent(torch.broadcast_to(
                lg, tuple(labels.shape) + lg.shape[-1:]), labels, sample_mask)
        g = v * a.mean() * g
        metrics[f"G_{m}"] = g
        G = G + g
    metrics["G"] = G
    metrics["fused_logits"] = fused
    return F + G, metrics


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()

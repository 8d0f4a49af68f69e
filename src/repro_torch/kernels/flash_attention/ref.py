"""Plain PyTorch version of the flash-attention kernel (causal, optionally
sliding-window, GQA): the twin of the JAX package's ``attention_ref`` in
its causal mode, the only one the repository calls."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q: [B, H, S, hd]; k/v: [B, KH, S, hd] -> [B, H, S, hd].

    Scores and softmax in ``dtype`` — float32 by default, float64 for
    float64 inputs — with masked scores at -1e30; the probabilities meet V
    in V's type and the output comes back in q's type, as in the JAX
    package.  An explicit ``dtype`` computes everything in it and returns
    it (the float64 oracle)."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    R = H // KH
    ct = dtype or (torch.float64 if q.dtype == torch.float64
                   else torch.float32)
    qg = q.reshape(B, KH, R, S, hd).to(ct)
    s = torch.einsum("bkrqh,bksh->bkrqs", qg, k.to(ct)) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    vv = v if dtype is None else v.to(ct)
    o = torch.einsum("bkrqs,bksh->bkrqh", p.to(vv.dtype), vv)
    return o.reshape(B, H, S, hd).to(q.dtype if dtype is None else ct)

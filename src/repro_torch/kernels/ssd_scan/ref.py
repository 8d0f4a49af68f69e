"""Plain PyTorch version of the SSD intra-chunk kernel: the twin of the JAX
package's ``ssd_chunk_ref``.

Given one chunk (length Q) per (batch, chunk, head):
  y_diag[t] = Σ_{s<=t} exp(cum_t − cum_s) (C_t·B_s) x_s
  state     = Σ_s exp(cum_Q − cum_s) B_s ⊗ x_s
where cum is the within-chunk cumulative sum of dt·A.
"""
from __future__ import annotations

from typing import Optional

import torch


def ssd_chunk_ref(x, cum, Bm, Cm, dtype: Optional[torch.dtype] = None):
    """x: [B,nc,Q,nh,hp] (dt-weighted input), cum: [B,nc,Q,nh],
    Bm/Cm: [B,nc,Q,N].  Returns (y_diag [B,nc,Q,nh,hp], states
    [B,nc,nh,N,hp]) in ``dtype`` (default: the inputs' type)."""
    if dtype is not None:
        x, cum, Bm, Cm = (t.to(dtype) for t in (x, cum, Bm, Cm))
    Q = x.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,Q,Q,nh]
    tri = torch.ones((Q, Q), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    # mask the exponent, not the exp: an upper-triangle difference overflows
    L = torch.exp(torch.where(tri, diff, -torch.inf))
    scores = torch.einsum("bctn,bcsn->bcts", Cm, Bm)
    y_diag = torch.einsum("bctsh,bcts,bcshp->bcthp", L, scores, x)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bm, decay_to_end, x)
    return y_diag, states

"""Per-modality global aggregation — Eqs. (9)-(12) of the paper.

The global multimodal model is the stack of per-modality submodels.  In round
t only participating clients that *have* modality m contribute to submodel m;
their weights are renormalised to the participated aggregation weight
``w^t_{k,m} = D_k / sum_{i in K_m^t} D_i`` (Eq. 12).  If no participant has
modality m, the submodel is unchanged.

Three forms, as in the JAX package:

* the sequential loop's ``aggregate`` / ``aggregate_gradients`` over
  per-client dicts (absent clients and modalities get zero weight);
* the batched loop's ``aggregate_stacked`` over [K, ...] leaf stacks;
* the fused round's ``*_traced`` forms, whose weights and masks are
  tensors on the stacks' device and whose every branch is a
  ``torch.where`` — no read-back, so the round can be captured as a CUDA
  graph — and the cohort scatter back to dense [K] rows
  (``scatter_cohort_rows``).

The host weights are numpy float64; every contraction runs on the stacks'
device in float32.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .trees import tree_map


def stacked_weights(data_sizes: Sequence[int],
                    upload_mask: Mapping[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
    """Eq. 12 weights from a contributor mask: ``upload_mask[m]`` is a bool
    [K] marking the clients contributing to submodel m."""
    D = np.asarray(data_sizes, np.float64)
    out = {}
    for m, mask in upload_mask.items():
        w = np.where(np.asarray(mask, bool), D, 0.0)
        tot = w.sum()
        out[m] = w / tot if tot > 0 else w
    return out


def unified_weights(data_sizes: Sequence[int],
                    modalities: Sequence[Sequence[str]],
                    all_modalities: Sequence[str]) -> Dict[str, np.ndarray]:
    """w̄_{k,m} over the full population K_m (Eq. 9)."""
    return stacked_weights(data_sizes, {
        m: np.array([m in mods for mods in modalities])
        for m in all_modalities})


def participated_weights(data_sizes: Sequence[int],
                         modalities: Sequence[Sequence[str]],
                         participants: Sequence[int],
                         all_modalities: Sequence[str]
                         ) -> Dict[str, np.ndarray]:
    """w^t_{k,m} over K_m^t (Eq. 12); zero row if K_m^t is empty."""
    part = np.zeros(len(data_sizes), bool)
    part[list(participants)] = True
    return stacked_weights(data_sizes, {
        m: np.array([m in mods for mods in modalities]) & part
        for m in all_modalities})


def weights_from_uploads(data_sizes: Sequence[int],
                         client_params: Sequence[Optional[Mapping]],
                         all_modalities: Sequence[str]
                         ) -> Dict[str, np.ndarray]:
    """Participated weights from what was actually uploaded: under
    modality dropout a client's upload may miss a modality it owns, and
    renormalising over the real contributors keeps Eq. 12 convex."""
    return stacked_weights(data_sizes, {
        m: np.array([cp is not None and m in cp for cp in client_params])
        for m in all_modalities})


def _contract(w: np.ndarray, tree):
    """Σ_k w_k x_k over the leading client axis of every leaf."""
    def one(x):
        # float32 weights, as the JAX package's, promoted to a float64
        # stack's type
        wt = torch.as_tensor(w, dtype=torch.float32, device=x.device)
        return torch.tensordot(wt.to(x.dtype), x, dims=1)
    return tree_map(one, tree)


def aggregate_stacked(global_params: Mapping[str, dict],
                      stacked_params: Mapping[str, dict],
                      weights: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """θ^t_{g,m} = Σ_k w^t_{k,m} θ^t_{k,m} over [K, ...] leaf stacks.
    Zero-weight rows drop out of the contraction; if Σ_k w_{k,m} == 0 the
    global submodel m is returned unchanged."""
    new_global: Dict[str, dict] = {}
    for m, g_sub in global_params.items():
        w = weights[m]
        if m not in stacked_params or w.sum() <= 0:
            new_global[m] = g_sub
            continue
        new_global[m] = _contract(w, stacked_params[m])
    return new_global


def aggregate_gradients_stacked(stacked_grads: Mapping[str, dict],
                                weights: Mapping[str, np.ndarray]
                                ) -> Dict[str, dict]:
    """∇H(θ_{g,m}) = Σ_k w_{k,m} ∇H_k(θ_{g,m}) (Eq. 9) over [K, ...]
    gradient stacks; modalities with no contributor are omitted."""
    return {m: _contract(weights[m], g) for m, g in stacked_grads.items()
            if weights[m].sum() > 0}


def aggregate(global_params: Mapping[str, dict],
              client_params: List[Optional[Mapping[str, dict]]],
              weights: Mapping[str, np.ndarray]) -> Dict[str, dict]:
    """θ^t_{g,m} = Σ_k w^t_{k,m} θ^t_{k,m} (Eq. 12) over per-client dicts:
    ``client_params[k]`` holds only the modalities client k trained (None
    for a client that uploaded nothing); if Σ_k w_{k,m} == 0 the global
    submodel m is returned unchanged."""
    new_global: Dict[str, dict] = {}
    for m, g_sub in global_params.items():
        w = weights[m]
        if w.sum() <= 0:
            new_global[m] = g_sub
            continue
        acc = tree_map(torch.zeros_like, g_sub)
        for k, cp in enumerate(client_params):
            if cp is None or m not in cp or w[k] == 0:
                continue
            acc = tree_map(lambda a, x: a + float(w[k]) * x, acc, cp[m])
        new_global[m] = acc
    return new_global


def aggregate_gradients(grads_by_client: List[Optional[Mapping[str, dict]]],
                        weights: Mapping[str, np.ndarray]
                        ) -> Dict[str, dict]:
    """∇H(θ_{g,m}) = Σ_k w_{k,m} ∇H_k(θ_{g,m}) (Eq. 9) over per-client
    gradient dicts; modalities nobody uploaded are omitted."""
    out: Dict[str, dict] = {}
    mods = sorted({m for g in grads_by_client if g for m in g})
    for m in mods:
        w = weights[m]
        acc = None
        for k, g in enumerate(grads_by_client):
            if g is None or m not in g or w[k] == 0:
                continue
            term = tree_map(lambda x: float(w[k]) * x, g[m])
            acc = term if acc is None else tree_map(torch.add, acc, term)
        if acc is not None:
            out[m] = acc
    return out


# ---------------------------------------------------------------------------
# The fused round's forms: weights and masks are tensors on the stacks'
# device, the host branches on ``w.sum() <= 0`` become ``torch.where`` —
# nothing reads a value back, so a CUDA graph can capture them.
# ---------------------------------------------------------------------------
def upload_masks_traced(ok, has: Mapping[str, torch.Tensor],
                        drop: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
    """The Eq. 12 contributor masks: client k contributes to submodel m iff
    it participated (``ok``), owns m (``has[m]``) and did not drop it this
    round (``drop[m]``; None ⇒ no policy drops)."""
    ok = ok.to(torch.bool)
    out = {}
    for m, h in has.items():
        u = ok & h.to(torch.bool)
        if drop is not None and m in drop:
            u = u & ~drop[m].to(torch.bool)
        out[m] = u
    return out


def stacked_weights_traced(D, upload_mask: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """Eq. 12 weights from tensor contributor masks; a contributor-free
    modality keeps its all-zero row, as ``stacked_weights`` does."""
    D = D.to(torch.float32)
    out = {}
    for m, mask in upload_mask.items():
        w = torch.where(mask.to(torch.bool), D, 0.0)
        tot = w.sum()
        out[m] = torch.where(tot > 0, w / torch.clamp_min(tot, 1e-30), w)
    return out


def aggregate_stacked_traced(global_params: Mapping[str, dict],
                             stacked_params: Mapping[str, dict],
                             weights: Mapping[str, torch.Tensor]
                             ) -> Dict[str, dict]:
    """``aggregate_stacked`` with tensor weights: Σ_k w_{k,m} == 0 keeps
    the global submodel through ``torch.where``."""
    new_global: Dict[str, dict] = {}
    for m, g_sub in global_params.items():
        if m not in stacked_params:
            new_global[m] = g_sub
            continue
        w = weights[m].to(torch.float32)
        has_contrib = w.sum() > 0
        new_global[m] = tree_map(
            lambda old, x: torch.where(has_contrib,
                                       torch.tensordot(w, x, dims=1), old),
            g_sub, stacked_params[m])
    return new_global


def aggregate_gradients_stacked_traced(stacked_grads: Mapping[str, dict],
                                       weights: Mapping[str, torch.Tensor]
                                       ) -> Dict[str, dict]:
    """``aggregate_gradients_stacked`` with tensor weights; a
    contributor-free modality yields an exact-zero aggregate instead of
    being omitted."""
    return {m: tree_map(lambda x: torch.tensordot(
        weights[m].to(torch.float32), x, dims=1), g)
        for m, g in stacked_grads.items()}


def scatter_cohort_rows(vals_c, idx, K: int):
    """Cohort-local rows [J, ...] back to dense client rows [K, ...]:
    ``idx`` [J] holds the cohort's distinct client indices, so the
    ``index_add_`` is a pure scatter; zeros at non-cohort clients."""
    out = torch.zeros((K,) + tuple(vals_c.shape[1:]), dtype=vals_c.dtype,
                      device=vals_c.device)
    return out.index_add_(0, idx.to(torch.long), vals_c)


def cohort_weights_dense(weights_c: Mapping[str, torch.Tensor], idx,
                         K: int) -> Dict[str, torch.Tensor]:
    """Dense [K] Eq. 12 weight rows from cohort-local weights [J]."""
    return {m: scatter_cohort_rows(w.to(torch.float32), idx, K)
            for m, w in weights_c.items()}
